"""Parity of the port's training path (``models.resnet.apply_train`` and
``alphazero_reversi_tpu_torch.learner``) with the JAX package's Flax
``apply_train`` and optax learner, from the same weights and batches."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_reversi_tpu import learner as jlearner
from alphazero_reversi_tpu.config import TrainingConfig as JTrainingConfig
from alphazero_reversi_tpu.models import resnet as jresnet
from alphazero_reversi_tpu_torch import learner as tlearner
from alphazero_reversi_tpu_torch import replay as treplay
from alphazero_reversi_tpu_torch.config import TrainingConfig
from alphazero_reversi_tpu_torch.env import bitboard as tenv
from alphazero_reversi_tpu_torch.models import resnet as tresnet
from alphazero_reversi_tpu_torch.models.weights import state_dict_from_flax
from torch_parity import make_nets, random_positions

# f32: the frameworks sum the same products in different orders (~1e-6);
# bf16: activations round to bf16 at different points (one ulp at |x| ~ 1
# is 8e-3). As tests/test_torch_model.py sets them.
ATOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, LR = 16, 1e-3
AUX = ("loss", "policy_loss", "value_loss", "grad_norm")


def _batch(seed: int, batch: int = B):
    """Canonical planes of random positions, Dirichlet policy targets over
    the legal moves, and outcome targets in {-1, 0, 1}."""
    rng = np.random.default_rng(seed)
    s = random_positions(batch, seed)
    planes = tenv.canonical_planes(s).numpy()
    legal = tenv.legal_action_mask(s).numpy() | (np.arange(65) == 64)
    policy = rng.dirichlet(np.ones(65), batch) * legal
    policy = (policy / policy.sum(-1, keepdims=True)).astype(np.float32)
    value = rng.integers(-1, 2, batch).astype(np.float32)
    return planes, policy, value


def _flax_state_dict(params, batch_stats, cfg):
    tree = jax.tree_util.tree_map(np.asarray, {"params": params,
                                               "batch_stats": batch_stats})
    return state_dict_from_flax(tree, cfg)


def _cfgs(**kw):
    kw = {**dict(batch_size=B, learning_rate=LR, weight_decay=1e-2,
                 gradient_clip=1.0), **kw}
    return TrainingConfig(**kw), JTrainingConfig(**kw)


@functools.lru_cache(maxsize=None)
def _jax_optimizer(gradient_clip: float):
    """One optax optimizer per clip value: ``train_step`` takes it as a
    static argument, so sharing it shares the compiled step."""
    return jlearner.make_optimizer(JTrainingConfig(
        learning_rate=LR, weight_decay=1e-2, gradient_clip=gradient_clip))


@pytest.mark.parametrize("blocks,filters,dtype,bn", [
    (1, 8, "float32", True), (1, 8, "bfloat16", True),
    (2, 16, "float32", False), (2, 16, "bfloat16", True)])
def test_apply_train_matches_flax(blocks, filters, dtype, bn):
    """Logits, value and the new BatchNorm running averages (momentum 0.99,
    biased batch variance) match Flax ``apply_train``."""
    jnet, variables, tnet, cfg = make_nets(blocks, blocks, filters, dtype,
                                           bn)
    planes = _batch(blocks)[0]
    (jl, jv), mutated = jresnet.apply_train(jnet, variables,
                                            jnp.asarray(planes))
    (tl, tv), stats = tresnet.apply_train(tnet.train(),
                                          torch.from_numpy(planes))
    tnet.eval()
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=ATOL[dtype])
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               atol=ATOL[dtype])
    want = _flax_state_dict(variables["params"], mutated["batch_stats"], cfg)
    want = {k: v for k, v in want.items() if k.endswith(("_mean", "_var"))}
    assert set(stats) == set(want)
    assert bn == bool(stats)
    for name, value in stats.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   atol=ATOL[dtype], err_msg=name)


def test_dropout_draws_from_the_generator():
    """In train mode dropout keeps x / (1 - rate) where a draw from the
    given generator says so, as Flax's ``nn.Dropout`` does (JAX's stream
    cannot be matched); eval mode and rate 0 leave the net unchanged."""
    cfg = tresnet.ModelConfig(num_res_blocks=1, num_filters=8,
                              compute_dtype="float32", dropout=0.5)
    net = tresnet.build_network(cfg)
    x = torch.rand(8, 16, 8, 8)
    net.train()
    a = net._dropout(x, torch.Generator().manual_seed(1))
    b = net._dropout(x, torch.Generator().manual_seed(1))
    c = net._dropout(x, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert 0.4 < kept.float().mean().item() < 0.6
    torch.testing.assert_close(a[kept], x[kept] * 2)
    net.eval()
    assert torch.equal(net._dropout(x, None), x)


def test_apply_train_refuses_eval_mode():
    net = tresnet.build_network(tresnet.ModelConfig(num_res_blocks=0,
                                                    num_filters=4))
    with pytest.raises(ValueError):
        tresnet.apply_train(net, torch.zeros(1, 8, 8, 3))


@pytest.mark.parametrize("policy_loss", ["soft", "argmax"])
def test_loss_and_gradients_match_jax(policy_loss):
    """Aux losses within 1e-5 relative, and every parameter's gradient
    within 1e-5 of the largest gradient entry (f32)."""
    jnet, variables, tnet, cfg = make_nets(21, 1, 8)
    planes, policy, value = _batch(21)
    kw = dict(policy_loss=policy_loss, policy_weight=1.0, value_weight=0.5)

    def jloss(params):
        return jlearner.loss_fn(jnet, params, variables["batch_stats"],
                                jnp.asarray(planes), jnp.asarray(policy),
                                jnp.asarray(value), **kw)

    (_, (jaux, _)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(variables["params"])
    net = tnet.train()
    total, taux = tlearner.loss_fn(net, torch.from_numpy(planes),
                                   torch.from_numpy(policy),
                                   torch.from_numpy(value), **kw)
    total.backward()
    for k in ("loss", "policy_loss", "value_loss"):
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]),
                                   rtol=1e-5)
    want = _flax_state_dict(jgrads, variables["batch_stats"], cfg)
    scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-5 * scale, err_msg=name)


def _run_both(steps: int, seed: int, tcfg, jcfg, augment: bool = False):
    """``steps`` SGD steps from the same weights on the same batches in
    both packages. Returns (port state, JAX state, port auxes, JAX auxes,
    the port's per-step clipped gradients)."""
    jnet, variables, tnet, cfg = make_nets(seed, 1, 8)
    tx = _jax_optimizer(jcfg.gradient_clip)
    jstate = jlearner.create_train_state(jnet, variables, jcfg)
    tstate = tlearner.create_train_state(tnet, tcfg, device="cpu")
    tauxes, jauxes, grads = [], [], []
    for t in range(steps):
        planes, policy, value = _batch(100 * seed + t)
        key = jax.random.PRNGKey(t)
        syms = None
        if augment:
            # loss_fn's draw: split the step key, the first half draws
            sym_key, _ = jax.random.split(key)
            syms = torch.from_numpy(np.array(
                jax.random.randint(sym_key, (B,), 0, 8, jnp.int32)))
        jstate, jaux = jlearner.train_step(
            jnet, tx, jstate, jnp.asarray(planes), jnp.asarray(policy),
            jnp.asarray(value), key, augment_symmetries=augment)
        tauxes.append(tlearner.train_step(
            tstate, torch.from_numpy(planes), torch.from_numpy(policy),
            torch.from_numpy(value), syms=syms, augment_symmetries=augment))
        jauxes.append(jaux)
        grads.append({n: p.grad.clone()
                      for n, p in tstate.net.named_parameters()})
    return tstate, jstate, tauxes, jauxes, grads, cfg


def _assert_states_close(tstate, jstate, grads, steps, cfg):
    """Parameters: within 1e-6, except entries whose gradient fell below
    1e-6 in some step. There Adam's step, about lr * g / (|g| + 1e-8), turns
    on the rounding of g, so such an entry may differ by at most 2 * lr per
    step. BatchNorm running averages within 1e-4 (f32)."""
    want = _flax_state_dict(jstate.params, jstate.batch_stats, cfg)
    got = tstate.net.state_dict()
    params = dict(tstate.net.named_parameters())
    for name, w in want.items():
        g, w = got[name].numpy(), w.numpy()
        if name not in params:
            np.testing.assert_allclose(g, w, atol=1e-4, err_msg=name)
            continue
        small = np.zeros(g.shape, bool)
        for step_grads in grads:
            small |= np.abs(step_grads[name].numpy()) < 1e-6
        diff = np.abs(g - w)
        assert diff[~small].max(initial=0) <= 1e-6, name
        assert diff[small].max(initial=0) <= 2 * LR * steps, name


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(steps):
    """1 and 3 steps on the same batches: aux values (loss, policy and
    value loss, pre-clip grad_norm) within 1e-5 relative; parameters and
    BatchNorm statistics as ``_assert_states_close`` bounds them."""
    tcfg, jcfg = _cfgs()
    tstate, jstate, tauxes, jauxes, grads, cfg = _run_both(steps, 3, tcfg,
                                                           jcfg)
    for taux, jaux in zip(tauxes, jauxes):
        for k in AUX:
            np.testing.assert_allclose(taux[k].item(), float(jaux[k]),
                                       rtol=1e-5, err_msg=k)
    assert tstate.step == int(jstate.step) == steps
    _assert_states_close(tstate, jstate, grads, steps, cfg)


def test_clipped_step_matches_jax():
    """A ``gradient_clip`` far below the gradient's norm: the clip rule
    (g / |g|) * max and the step still match JAX."""
    tcfg, jcfg = _cfgs(gradient_clip=1e-6)
    tstate, jstate, tauxes, jauxes, grads, cfg = _run_both(1, 4, tcfg, jcfg)
    assert tauxes[0]["grad_norm"].item() > 1e3 * tcfg.gradient_clip
    np.testing.assert_allclose(tauxes[0]["grad_norm"].item(),
                               float(jauxes[0]["grad_norm"]), rtol=1e-5)
    clipped_norm = np.sqrt(sum((g.numpy().astype(np.float64) ** 2).sum()
                               for g in grads[0].values()))
    np.testing.assert_allclose(clipped_norm, tcfg.gradient_clip, rtol=1e-5)
    _assert_states_close(tstate, jstate, grads, 1, cfg)


def test_augmented_step_matches_jax():
    """``augment_symmetries`` with JAX's symmetry draw injected."""
    tcfg, jcfg = _cfgs(augment_symmetries=True)
    tstate, jstate, tauxes, jauxes, grads, cfg = _run_both(
        1, 5, tcfg, jcfg, augment=True)
    for k in AUX:
        np.testing.assert_allclose(tauxes[0][k].item(),
                                   float(jauxes[0][k]), rtol=1e-5)
    _assert_states_close(tstate, jstate, grads, 1, cfg)


def test_learning_rate_schedule_matches_jax():
    tcfg, jcfg = _cfgs(lr_milestones=[2, 4], lr_gamma=0.5)
    for it in range(7):
        assert tlearner.lr_at_iteration(tcfg, it) == \
            jlearner.lr_at_iteration(jcfg, it)
    jnet, variables, tnet, _ = make_nets(6, 1, 8)
    tstate = tlearner.create_train_state(tnet, tcfg, device="cpu")
    jstate = jlearner.create_train_state(jnet, variables, jcfg)
    assert tlearner.current_learning_rate(tstate) == pytest.approx(
        jlearner.current_learning_rate(jstate), rel=1e-7)
    lr = tlearner.lr_at_iteration(tcfg, 5)
    tlearner.set_learning_rate(tstate, lr)
    jstate = jlearner.set_learning_rate(jstate, lr)
    assert tlearner.current_learning_rate(tstate) == pytest.approx(
        jlearner.current_learning_rate(jstate), rel=1e-7)


def _buffer(seed: int):
    planes, policy, value = _batch(seed, 48)
    buf = treplay.create(64, device="cpu")
    return treplay.add(buf, torch.from_numpy(planes),
                       torch.from_numpy(policy), torch.from_numpy(value),
                       torch.ones(48, dtype=torch.bool))


def test_train_steps_equal_single_steps():
    """``train_steps`` equals K ``replay.sample`` + ``train_step`` calls on
    one generator's draws (symmetries on), bit for bit; its aux is the
    step mean."""
    tcfg, _ = _cfgs(augment_symmetries=True)
    _, _, tnet, _ = make_nets(7, 1, 8)
    buf = _buffer(7)
    learner = tlearner.Learner(tnet, tcfg, device="cpu")
    aux = learner.steps(buf, torch.Generator().manual_seed(9), 3, 8)
    state = tlearner.create_train_state(tnet, tcfg, device="cpu")
    gen = torch.Generator().manual_seed(9)
    auxes = []
    for _ in range(3):
        batch = treplay.sample(buf, gen, 8)
        auxes.append(tlearner.train_step(state, *batch, generator=gen,
                                         augment_symmetries=True))
    for name, value in learner.state_dict().items():
        assert torch.equal(value, state.net.state_dict()[name]), name
    for k in AUX:
        assert torch.equal(aux[k], torch.stack([a[k] for a in auxes]).mean())


def test_learner_hands_its_state_to_a_selfplay_net():
    """After steps at an iteration's lr, ``copy_to`` makes the self-play
    net (eval mode) equal to the learner in weights and running stats."""
    tcfg, _ = _cfgs(lr_milestones=[1], lr_gamma=0.1)
    _, _, tnet, _ = make_nets(8, 1, 8)
    learner = tlearner.Learner(tnet, tcfg, device="cpu")
    learner.set_iteration(1)
    assert tlearner.current_learning_rate(learner.state) == \
        pytest.approx(LR * 0.1)
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    learner.steps(_buffer(8), torch.Generator().manual_seed(0), 2, 8)
    assert learner.net.training and not tnet.training
    # the learner trains a copy: the self-play net is untouched until copy_to
    assert all(torch.equal(v, tnet.state_dict()[k])
               for k, v in before.items())
    learner.copy_to(tnet)
    for name, value in learner.state_dict().items():
        assert torch.equal(tnet.state_dict()[name], value), name
    assert not all(torch.equal(v, tnet.state_dict()[k])
                   for k, v in before.items())
