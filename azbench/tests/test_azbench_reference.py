"""The benchmark's plain reference against the program on the CPU at tiny
sizes: the rules, the forward pass, the SGD steps and the searches."""
import numpy as np
import pytest
import torch

import weights as weights_lib
from kinds import selfplay as sp_kind
from kinds import sgd as sgd_kind
from reference import net as ref_net
from reference import rules
from reference import search as ref_search
from reference import sgd as ref_sgd

from alphazero_reversi_tpu_torch import learner as learner_lib
from alphazero_reversi_tpu_torch.config import ModelConfig, TrainingConfig
from alphazero_reversi_tpu_torch.env import bitboard as env
from alphazero_reversi_tpu_torch import selfplay
from alphazero_reversi_tpu_torch.models import resnet

CPU = torch.device("cpu")
MODEL = dict(board_size=8, num_res_blocks=2, num_filters=16,
             value_head_hidden_size=32, policy_head_channels=2,
             value_head_channels=1)


def _port():
    return sp_kind._port()


def _net(dtype, seed=5):
    w = weights_lib.make(MODEL, seed, CPU)
    net = resnet.build_network(ModelConfig(**MODEL, compute_dtype=dtype))
    net.load_state_dict(w, strict=False)
    return net, w


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_rules_match_the_env_along_random_games(seed):
    rng = np.random.default_rng(seed)
    n = 256
    s = rules.initial(n)
    port = _port()
    for _ in range(64):
        st = sp_kind.to_env(port, s, CPU)
        assert np.array_equal(
            env.legal_action_mask(st).numpy(), rules.legal_mask(s))
        assert np.array_equal(env.canonical_planes(st).numpy(),
                              rules.planes(s))
        mask = rules.legal_mask(s)
        pick = (rng.random(n) * np.maximum(mask.sum(-1), 1)).astype(int)
        act = np.where(s["done"], 64,
                       np.argmax(np.cumsum(mask, -1) > pick[:, None], -1))
        nxt, valid = env.step(st, torch.as_tensor(act))
        want = rules.step(s, act)
        live = ~s["done"]
        assert valid.numpy()[live].all()
        for f in ("black", "white"):
            got = getattr(nxt, f).numpy().view(np.uint64)
            assert np.array_equal(got[live], want[f][live])
        for f in ("to_move", "passed", "done", "winner"):
            got = getattr(nxt, f).numpy().astype(np.int64)
            assert np.array_equal(got[live], want[f][live].astype(np.int64))
        s = {k: np.where(live, want[k], s[k]) for k in s}


def test_symmetries_keep_legality():
    rng = np.random.default_rng(0)
    s = rules.play_random(rng.permutation(np.arange(512) % 56), rng)
    count = rules.popcount(rules.placements(*rules.sides(s)))
    for k in range(8):
        t = rules.symmetric(s, k)
        assert np.array_equal(
            rules.popcount(rules.placements(*rules.sides(t))), count)
    assert not np.array_equal(rules.symmetric(s, 1)["black"], s["black"])


def test_forward_matches_the_net():
    planes = torch.as_tensor(rules.planes(rules.play_random(
        np.arange(64) % 40, np.random.default_rng(1))))
    net, w = _net("float32")
    lg, v = resnet.apply_eval(net, planes)
    rl, rv, _ = ref_net.forward(w, planes, MODEL["num_res_blocks"])
    torch.testing.assert_close(lg, rl, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(v, rv, rtol=1e-5, atol=1e-5)
    # the bf16 trunk sits close to the reference, the fp8 control further
    net16, _ = _net("bfloat16")
    lg16, _ = resnet.apply_eval(net16, planes)
    q, _, _ = ref_net.forward(w, planes, MODEL["num_res_blocks"],
                              quant="fp8")
    assert (lg16 - rl).abs().max() < (q - rl).abs().max()


def test_sgd_steps_match_the_learner():
    net, w = _net("float32")
    tc = TrainingConfig(batch_size=32, learning_rate=1e-3,
                        weight_decay=1e-4, gradient_clip=1.0)
    lrn = learner_lib.Learner(net, tc, device=CPU)
    planes, policy, value = sgd_kind.make_data(256, 40, 3, CPU)
    idx = torch.randint(0, 256, (3, 32), generator=torch.Generator()
                        .manual_seed(0))
    batches = [(planes[i], policy[i], value[i]) for i in idx]
    for b in batches:
        lrn.step(*b)
    ref = ref_sgd.run(w, batches, model=MODEL, lr=1e-3,
                      weight_decay=1e-4, max_norm=1.0)
    got = lrn.state_dict()
    for k, v in ref["params"].items():
        torch.testing.assert_close(got[k], v, rtol=1e-4, atol=1e-6)


class _RefNet(torch.nn.Module):
    """The reference net in float32 behind the program's net interface."""

    def __init__(self, w):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))
        self.w = w

    def forward(self, planes):
        lg, v, _ = ref_net.forward(self.w, planes, MODEL["num_res_blocks"])
        return lg, v


SEARCHES = {
    "gumbel": dict(algorithm="gumbel", num_simulations=16, leaf_batch=1,
                   max_considered_actions=4, num_stages=4, max_depth=6,
                   tree_reuse="off"),
    "gumbel_reuse_L2": dict(algorithm="gumbel", num_simulations=16,
                            leaf_batch=2, max_considered_actions=8,
                            num_stages=3, max_depth=24, tree_reuse="root",
                            tree_reuse_discount=0.5),
    "puct_L4": dict(algorithm="puct", num_simulations=32, leaf_batch=4,
                    num_stages=6, max_depth=64, tree_reuse="off"),
    "puct_reuse": dict(algorithm="puct", num_simulations=24, leaf_batch=1,
                       num_stages=2, max_depth=5, tree_reuse="root"),
}


@pytest.mark.parametrize("name", list(SEARCHES))
def test_reference_search_is_the_programs(name):
    """With one float32 net on both sides, the plain search gives the
    program's recorded policies and moves, slot by slot, carrying its own
    root statistics along the moves played."""
    from kinds import selfplay as kind
    G, T = 24, 4
    cfg = dict(c_puct=1.5, dirichlet_alpha=0.3, dirichlet_epsilon=0.25,
               temp_threshold=2, temp_init=1.0, temp_final=0.1,
               c_visit=50.0, c_scale=0.1, max_considered_actions=16,
               tree_reuse_discount=1.0)
    cfg.update(SEARCHES[name])
    _, w = _net("float32")
    rng = np.random.default_rng(3)
    start = rules.play_random(rng.permutation(np.arange(G) % 50), rng)
    gen = torch.Generator().manual_seed(4)
    noise = dict(
        gumbel_noise=torch.empty(T, G, 65).exponential_(generator=gen)
        .log_().neg_(),
        log_gamma=kind.log_gamma(0.3, (T, G, 65), gen, CPU),
        sample_noise=torch.empty(T, G, 65).exponential_(generator=gen)
        .log_().neg_())
    if cfg["algorithm"] == "gumbel":
        noise = dict(gumbel_noise=noise["gumbel_noise"])
    else:
        noise.pop("gumbel_noise")
    traj = selfplay.play_games(
        _RefNet(w).eval(), num_games=G, init_states=kind.to_env(
            sp_kind._port(), start, CPU), generator=gen, device=CPU,
        max_moves=T, **cfg, **noise)
    call = dict(start=start, planes=traj.planes, policy=traj.policy,
                value=traj.value, to_move=traj.to_move, valid=traj.valid,
                actions=traj.actions, final=traj.final_state._asdict())
    errors, states, legal, live = kind._replay(call, T)
    assert errors == 0
    fn = kind._net(w, MODEL, CPU, None)
    warm = (torch.zeros(G, 65), torch.zeros(G, 65))
    same = total = 0
    for t in range(T):
        lv = torch.as_tensor(live[t])
        root = {k: v[lv.numpy()] for k, v in states[t].items()}
        played = traj.actions[t][lv].long()
        got = ref_search.run(
            fn, root, algorithm=cfg["algorithm"],
            simulations=cfg["num_simulations"],
            leaf_batch=cfg["leaf_batch"], max_depth=cfg["max_depth"],
            stages=cfg["num_stages"], c_puct=cfg["c_puct"],
            dirichlet_epsilon=cfg["dirichlet_epsilon"],
            log_gamma=noise.get("log_gamma", torch.zeros(T, G, 65))[t][lv],
            max_considered=cfg["max_considered_actions"],
            c_visit=cfg["c_visit"], c_scale=cfg["c_scale"],
            gumbel=noise.get("gumbel_noise", torch.zeros(T, G, 65))[t][lv],
            warm=tuple(x[lv] for x in warm)
            if cfg["tree_reuse"] == "root" else None,
            warm_discount=cfg["tree_reuse_discount"])
        nxt = ref_search.warm_after(got["tree"], played)
        warm = tuple(torch.zeros(G, 65).index_put_((lv.nonzero()[:, 0],), x)
                     for x in nxt)
        agree = (got["policy"] - traj.policy[t][lv]).abs().amax(-1) < 1e-6
        if got["move"] is not None:
            agree &= got["move"] == played
        same += int(agree.sum())
        total += int(lv.sum())
    assert total > 3 * G and same == total
