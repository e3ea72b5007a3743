"""The port on a CUDA card: the backup+link kernel's two entry points
against their plain versions (at the flagship's, the gate's and the PUCT
default config's shapes); the eval BatchNorm kernel against the eager
composition, alone, in the net's forward and under a CUDA graph; the env, a Gumbel and a PUCT search, the gate,
the replay buffer and the learner on the card against the same code on the
CPU; and SGD steps that never sync with the host. Every test here needs a
card and skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from alphazero_reversi_tpu_torch import learner as learner_lib
from alphazero_reversi_tpu_torch import replay
from alphazero_reversi_tpu_torch.config import ModelConfig, TrainingConfig
from alphazero_reversi_tpu_torch.env import bitboard as env
from alphazero_reversi_tpu_torch.mcts import cuda_backup
from alphazero_reversi_tpu_torch.mcts import gumbel, search
from alphazero_reversi_tpu_torch.models import resnet
from torch_round_inputs import ROUND_ARGS, round_inputs

pytestmark = pytest.mark.cuda

ARGS = ("nodes", "actions", "incs", "link_nodes", "link_actions",
        "link_slots", "do_link")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _backup_inputs(rng, batch, nodes_n, levels, links):
    """Random arguments; with ``links == 1`` each game's path nodes are
    distinct, as a single-leaf descent's are."""
    p = levels * links
    if links == 1:
        nodes = np.stack([rng.permutation(nodes_n)[:p] for _ in range(batch)])
    else:
        nodes = rng.integers(0, nodes_n, (batch, p))
    nodes = np.where(rng.random((batch, p)) < 0.75, nodes, -1)
    s = cuda_backup.STRIDE
    return dict(
        stats=(rng.integers(0, 50, (batch, nodes_n * s)) * 1024.0
               + rng.normal(0, 1, (batch, nodes_n * s))).astype(np.float32),
        nodes=nodes.astype(np.int32),
        actions=rng.integers(0, 65, (batch, p)).astype(np.int32),
        incs=rng.normal(0, 1, (batch, p)).astype(np.float32),
        link_nodes=rng.integers(0, nodes_n, (batch, links)).astype(np.int32),
        link_actions=rng.integers(0, 65, (batch, links)).astype(np.int32),
        link_slots=rng.integers(1, nodes_n, (batch, links)).astype(np.int32),
        do_link=rng.random((batch, links)) < 0.8)


@pytest.mark.parametrize("links", [1, 4])
def test_backup_kernel_matches_plain_version(card, links):
    """At the flagship's last-stage shape (B=1024, N=33, 24 levels): equal
    to the plain version on the CPU bit for bit (both add in path order),
    and to the plain version on the card exactly at L=1 and within 1e-6 at
    L=4 (its scatter_add_ adds colliding cells in atomic order)."""
    d = _backup_inputs(np.random.default_rng(links), 1024, 33, 24, links)
    cpu = {k: torch.from_numpy(v) for k, v in d.items()}
    gpu = {k: v.to(card) for k, v in cpu.items()}
    got = gpu["stats"].clone()
    before = cuda_backup.LAUNCHES
    cuda_backup.backup_and_link(got, *(gpu[k] for k in ARGS))
    torch.cuda.synchronize()
    assert cuda_backup.LAUNCHES == before + 1
    want_cpu = cpu["stats"].clone()
    cuda_backup.backup_and_link_reference(want_cpu, *(cpu[k] for k in ARGS))
    assert torch.equal(got.cpu(), want_cpu)
    want_gpu = gpu["stats"].clone()
    cuda_backup.backup_and_link_reference(want_gpu, *(gpu[k] for k in ARGS))
    if links == 1:
        assert torch.equal(got, want_gpu)
    else:
        torch.testing.assert_close(got, want_gpu, rtol=1e-6, atol=1e-6)


def _round(d, device, fn):
    """Run ``fn`` (the kernel's wrapper or the plain version) on copies of
    ``d`` on ``device``; return (stats, root_visit, root_vsum)."""
    t = {k: torch.from_numpy(np.array(v)).to(device) for k, v in d.items()
         if k != "slot0"}
    fn(t["stats"], *(t[k] for k in ROUND_ARGS), d["slot0"],
       t["root_to_move"], t["root_visit"], t["root_vsum"])
    return t["stats"], t["root_visit"], t["root_vsum"]


@pytest.mark.parametrize("links,levels,odd", [
    (1, 24, False), (4, 8, False), (4, 24, False), (4, 8, True),
    (4, 24, True)])
def test_round_backup_kernel_matches_plain_version(card, links, levels, odd):
    """azr_round_backup at the flagship's last-stage shape (B=1024, N=33):
    bit for bit equal to the plain version on the CPU (same add order,
    lanes summed in order) at L=1, at L=4 with in-round duplicates and
    shared root edges, and with nodes past the tree and actions outside
    [0, 65); P=24 and P=32 take the kernel's one-step path where the
    actions allow it, P=96 its stepwise path. At L=1 it also equals the
    plain version on the card, where no float cell takes two adds."""
    d = round_inputs(np.random.default_rng(links + levels + odd), 1024, 33,
                     levels, links, odd=odd)
    before = cuda_backup.ROUND_LAUNCHES
    got = _round(d, card, cuda_backup.round_backup)
    torch.cuda.synchronize()
    assert cuda_backup.ROUND_LAUNCHES == before + 1
    for x, y in zip(got, _round(d, "cpu", cuda_backup.round_backup_reference)):
        assert torch.equal(x.cpu(), y)
    if links == 1:
        want = _round(d, card, cuda_backup.round_backup_reference)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def test_round_backup_graph_replay_matches_eager(card):
    """One azr_round_backup launch captured in a CUDA graph and replayed
    gives what the eager launch gives."""
    d = round_inputs(np.random.default_rng(7), 1024, 33, 24, 1)
    eager = _round(d, card, cuda_backup.round_backup)
    t = {k: torch.from_numpy(np.array(v)).to(card) for k, v in d.items()
         if k != "slot0"}
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cuda_backup.round_backup(
            t["stats"], *(t[k] for k in ROUND_ARGS), d["slot0"],
            t["root_to_move"], t["root_visit"], t["root_vsum"])
    graph.replay()
    torch.cuda.synchronize()
    for x, y in zip((t["stats"], t["root_visit"], t["root_vsum"]), eager):
        assert torch.equal(x, y)


def test_env_on_card_matches_cpu(card):
    """int64 shifts, masks and popcounts behave the same on the card: random
    games in both rule modes give bit-identical states and outputs."""
    rng = np.random.default_rng(0)
    for compat in (False, True):
        sc, sg = env.initial_state((256,)), env.initial_state((256,), card)
        for _ in range(64):
            mask = env.legal_action_mask(sc, compat=compat)
            assert torch.equal(mask, env.legal_action_mask(
                sg, compat=compat).cpu())
            assert torch.equal(env.canonical_planes(sc, compat=compat),
                               env.canonical_planes(sg, compat=compat).cpu())
            act = torch.from_numpy(np.array(
                [rng.choice(np.flatnonzero(m)) if m.any() else 64
                 for m in mask.numpy()]))
            sc, vc = env.step(sc, act, compat=compat)
            sg, vg = env.step(sg, act.to(card), compat=compat)
            assert torch.equal(vc, vg.cpu())
            for x, y in zip(sc, sg):
                assert torch.equal(x, y.cpu())
        assert sc.done.all()


@pytest.mark.parametrize("warm", [False, True])
def test_gumbel_search_on_card_matches_cpu(card, warm):
    """A float32 search through the kernel (one azr_round_backup launch per
    round) equals the CPU search through the plain version (actions and
    visits exact)."""
    torch.manual_seed(0)
    net = resnet.build_network(ModelConfig(num_res_blocks=1, num_filters=16,
                                           compute_dtype="float32"))
    roots = env.initial_state((64,))
    draw = torch.from_numpy(np.random.default_rng(1).gumbel(
        size=(64, 65)).astype(np.float32))
    warm_root = None
    if warm:
        legal = env.legal_action_mask(roots)
        wv = torch.where(legal, torch.randint(0, 3, (64, 65)), 0).float()
        warm_root = (wv, wv * 0.3)
    kw = dict(num_simulations=16, max_considered_actions=8, max_depth=8,
              num_stages=2)
    ref = gumbel.run_gumbel_search(net, roots, gumbel=draw,
                                   warm_root=warm_root, device="cpu", **kw)
    before = (cuda_backup.LAUNCHES, cuda_backup.ROUND_LAUNCHES)
    got = gumbel.run_gumbel_search(
        net.to(card), env.EnvState(*(t.to(card) for t in roots)),
        gumbel=draw.to(card), device=card,
        warm_root=None if warm_root is None else tuple(
            t.to(card) for t in warm_root), **kw)
    assert (cuda_backup.LAUNCHES, cuda_backup.ROUND_LAUNCHES) == (
        before[0], before[1] + 16)
    assert torch.equal(got.chosen_action.cpu(), ref.chosen_action)
    assert torch.equal(got.visit_counts.cpu(), ref.visit_counts)
    torch.testing.assert_close(got.action_probs.cpu(), ref.action_probs,
                               rtol=0, atol=1e-5)


def _training_rows(n: int, seed: int):
    s = env.initial_state((n,))
    rng = np.random.default_rng(seed)
    for _ in range(int(rng.integers(4, 30))):
        mask = env.legal_action_mask(s).numpy()
        act = np.array([rng.choice(np.flatnonzero(m)) if m.any() else 64
                        for m in mask])
        s, _ = env.step(s, torch.from_numpy(act))
    policy = rng.dirichlet(np.ones(65), n).astype(np.float32)
    return (env.canonical_planes(s), torch.from_numpy(policy),
            torch.from_numpy(rng.integers(-1, 2, n).astype(np.float32)),
            torch.from_numpy(rng.random(n) < 0.8))


def test_replay_on_card_matches_cpu(card):
    """Inserts (one wraps the ring) and a gather: equal on both devices."""
    bufs = {d: replay.create(96, device=d) for d in ("cpu", card)}
    for seed in range(3):
        rows = _training_rows(64, seed)
        bufs = {d: replay.add(b, *(x.to(d) for x in rows))
                for d, b in bufs.items()}
    cpu, gpu = bufs["cpu"], bufs[card]
    assert (cpu.cursor, cpu.size) == (gpu.cursor, gpu.size)
    for x, y in zip(cpu[:3], gpu[:3]):
        assert torch.equal(x, y.cpu())
    idx = torch.from_numpy(np.random.default_rng(5).integers(0, 96, 50))
    for x, y in zip(replay.gather(cpu, idx), replay.gather(gpu, idx.to(card))):
        assert torch.equal(x, y.cpu())


def test_learner_on_card_matches_cpu(card):
    """3 float32 SGD steps (TF32 off) on the same batches: losses and
    grad_norm within 1e-4 relative, BN running averages within 1e-4,
    parameters within 1e-5 except entries whose gradient fell below 1e-6
    in some step (Adam's step ~ lr * g / (|g| + 1e-8) turns on the rounding
    of g there: at most 2 * lr per step)."""
    cfg = TrainingConfig(batch_size=32)
    torch.manual_seed(0)
    net = resnet.build_network(ModelConfig(
        num_res_blocks=2, num_filters=32, compute_dtype="float32"))
    states = {d: learner_lib.create_train_state(net, cfg, device=d)
              for d in ("cpu", card)}
    small = {}
    for seed in range(3):
        batch = _training_rows(32, 10 + seed)[:3]
        aux = {d: learner_lib.train_step(st, *(x.to(d) for x in batch))
               for d, st in states.items()}
        for k, v in aux["cpu"].items():
            assert aux[card][k].item() == pytest.approx(v.item(), rel=1e-4)
        for name, p in states["cpu"].net.named_parameters():
            small[name] = small.get(name, False) | (p.grad.abs() < 1e-6)
    cpu = states["cpu"].net.state_dict()
    for name, t in states[card].net.state_dict().items():
        diff = (t.cpu() - cpu[name]).abs()
        if name not in small:
            assert diff.max().item() <= 1e-4, name
            continue
        loose = small[name]
        assert torch.where(loose, 0, diff).max().item() <= 1e-5, name
        assert torch.where(loose, diff, 0).max().item() <= \
            2 * cfg.learning_rate * 3, name


def test_train_steps_never_sync(card):
    """A ``train_steps`` call (sampling, forward, backward, clip, AdamW,
    the step-mean metrics) issues no host sync: it runs under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    net = resnet.build_network(ModelConfig(num_res_blocks=1, num_filters=16))
    learner = learner_lib.Learner(net, TrainingConfig(batch_size=32))
    buf = replay.create(256)
    buf = replay.add(buf, *(x.to(card) for x in _training_rows(128, 0)))
    gen = torch.Generator(device=card).manual_seed(0)
    learner.steps(buf, gen, 2, 32)  # first calls: lazy initialisation
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        aux = learner.steps(buf, gen, 4, 32)
        with pytest.raises(RuntimeError):
            aux["loss"].item()  # the mode is on: a read-back raises
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.isfinite(v).item() for v in aux.values())


def test_round_backup_kernel_at_gate_shape(card):
    """azr_round_backup at the promotion gate's shape: 10 games per search
    group, N=33, 32 path levels at the last stage of a Gumbel-32 search
    with max_depth 64 (still the one-step path, P <= 32); equal to the plain
    version on the CPU and on the card bit for bit."""
    d = round_inputs(np.random.default_rng(10), 10, 33, 32, 1)
    got = _round(d, card, cuda_backup.round_backup)
    for x, y in zip(got, _round(d, "cpu", cuda_backup.round_backup_reference)):
        assert torch.equal(x.cpu(), y)
    for x, y in zip(got, _round(d, card, cuda_backup.round_backup_reference)):
        assert torch.equal(x, y)


def test_gate_on_card_matches_cpu(card):
    """A tiny float32 merged gate (two nets and the random player, tree
    reuse, the same injected sampling draws) gives the same per-unit scores
    on the card as on the CPU, and each search round launched the kernel
    once."""
    from alphazero_reversi_tpu_torch import arena

    torch.manual_seed(0)
    nets = [resnet.build_network(ModelConfig(
        num_res_blocks=1, num_filters=16, compute_dtype="float32"))
        for _ in range(2)] + [None]
    units = [(0, 1, 3, env.BLACK), (0, 1, 3, env.WHITE),
             (0, 2, 3, env.BLACK), (0, 2, 3, env.WHITE),
             (1, 2, 3, env.BLACK), (1, 2, 3, env.WHITE)]
    kw = dict(num_simulations=8, temperature=0.5, algorithm="gumbel",
              max_considered_actions=4, tree_reuse="root")
    pairs = (60 + 16 + 1) // 2
    noise = [torch.from_numpy(np.random.default_rng(u).gumbel(
        size=(2 * pairs, 3, 65)).astype(np.float32)) for u in range(6)]
    cpu = arena.play_units(nets, units, sample_noise=noise, device="cpu",
                           **kw)
    info = {}
    before = cuda_backup.ROUND_LAUNCHES
    gpu = arena.play_units([n if n is None else n.to(card) for n in nets],
                           units, sample_noise=[x.to(card) for x in noise],
                           info=info, **kw)
    assert cuda_backup.ROUND_LAUNCHES - before == 8 * info["searches"]
    for x, y in zip(gpu, cpu):
        np.testing.assert_array_equal(x, y)


def test_checkpoint_restores_onto_card(card, tmp_path):
    """A pipeline on the card saves its state (CUDA tensors, the CUDA
    generator) and a fresh pipeline on the card restores it exactly."""
    import os
    import sys

    from alphazero_reversi_tpu_torch import checkpoint as ckpt
    from alphazero_reversi_tpu_torch import pipeline

    sys.path.insert(0, os.path.dirname(__file__))
    from torch_configs import tiny_run_config

    cfg = tiny_run_config(str(tmp_path))
    src = pipeline.AlphaZeroPipeline(cfg)
    rows = _training_rows(64, 0)
    src.buffer = replay.add(src.buffer, *(x.to(card) for x in rows))
    src.learner.steps(src.buffer, src.generator, 2, 16)
    src.iteration = 1
    src.save_checkpoint()
    ckpt.wait_for_saves()
    dst = pipeline.AlphaZeroPipeline(cfg)
    assert dst.load_checkpoint()
    for x, y in zip(src.learner.state_dict().values(),
                    dst.learner.state_dict().values()):
        assert y.device.type == "cuda" and torch.equal(x, y)
    for x, y in zip(src.buffer[:3], dst.buffer[:3]):
        assert y.device.type == "cuda" and torch.equal(x, y)
    assert (dst.buffer.cursor, dst.buffer.size) == (src.buffer.cursor,
                                                    src.buffer.size)
    opt = dst.learner.state.optimizer.state_dict()["state"]
    assert all(v["exp_avg"].device.type == "cuda" for v in opt.values())
    assert torch.equal(torch.rand(3, generator=src.generator, device=card),
                       torch.rand(3, generator=dst.generator, device=card))


@pytest.mark.parametrize("batch,links,dups", [(1024, 1, False),
                                              (1, 1, False), (64, 4, True)],
                         ids=["selfplay", "analyze", "dups"])
def test_round_backup_kernel_at_puct_shapes(card, batch, links, dups):
    """azr_round_backup at the default config's PUCT-400 shapes: N=401 and
    60 path levels a lane (max_depth 64, every stage unrolls 60 levels), so
    P = 60 L > 32 takes the kernel's stepwise path. Self-play (B=1024, L=1)
    and analyze (B=1) equal the plain version on the CPU and on the card
    bit for bit; B=64 at L=4 with lane 1 repeating lane 0 in every game
    (in-round duplicates, linked once) equals the CPU plain version."""
    d = round_inputs(np.random.default_rng(batch + links), batch, 401, 60,
                     links, dups=dups)
    before = cuda_backup.ROUND_LAUNCHES
    got = _round(d, card, cuda_backup.round_backup)
    torch.cuda.synchronize()
    assert cuda_backup.ROUND_LAUNCHES == before + 1
    for x, y in zip(got, _round(d, "cpu", cuda_backup.round_backup_reference)):
        assert torch.equal(x.cpu(), y)
    if links == 1:
        for x, y in zip(got, _round(d, card,
                                    cuda_backup.round_backup_reference)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("leaf_batch", [1, 4])
def test_puct_search_on_card_matches_cpu(card, leaf_batch):
    """A float32 PUCT search with injected root noise and a warm root at
    discount 0.25 (one azr_round_backup launch per round) equals the CPU
    search through the plain version: visit counts exact."""
    torch.manual_seed(0)
    net = resnet.build_network(ModelConfig(num_res_blocks=1, num_filters=16,
                                           compute_dtype="float32"))
    roots = env.initial_state((8,))
    rng = np.random.default_rng(2)
    legal = env.legal_action_mask(roots)
    wv = torch.where(legal, torch.from_numpy(rng.integers(0, 6, (8, 65))),
                     0).float()
    kw = dict(num_simulations=16, c_puct=1.25, dirichlet_alpha=0.03,
              dirichlet_epsilon=0.25, max_depth=8, num_stages=3,
              leaf_batch=leaf_batch, warm_discount=0.25)
    log_gamma = torch.from_numpy(rng.normal(0, 5, (8, 65)).astype(
        np.float32))
    ref = search.run_search(net, roots, warm_root=(wv, wv * 0.3),
                            log_gamma=log_gamma, device="cpu", **kw)
    before = cuda_backup.ROUND_LAUNCHES
    got = search.run_search(
        net.to(card), env.EnvState(*(t.to(card) for t in roots)),
        warm_root=(wv.to(card), wv.to(card) * 0.3),
        log_gamma=log_gamma.to(card), device=card, **kw)
    assert cuda_backup.ROUND_LAUNCHES == before + 16 // leaf_batch
    assert torch.equal(got.visit_counts.cpu(), ref.visit_counts)
    torch.testing.assert_close(got.root_value.cpu(), ref.root_value,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("nodes_n,levels,links", [(401, 24, 16), (33, 4, 8)],
                         ids=["puct400_lb16", "peak_lb8"])
def test_round_backup_kernel_at_bench_shapes(card, nodes_n, levels, links):
    """azr_round_backup at the bench's multi-leaf shapes (B=1024): PUCT-400
    at leaf_batch 16 (N=401, its last stage's 24 levels, P=384: twelve
    32-entry chunks on the stepwise path) and the tiny-net points' PUCT-32
    / Gumbel-32 at leaf_batch 8 (N=33, 4 levels, P=32), both with in-round
    duplicates; bit for bit equal to the plain version on the CPU."""
    d = round_inputs(np.random.default_rng(nodes_n + links), 1024, nodes_n,
                     levels, links)
    before = cuda_backup.ROUND_LAUNCHES
    got = _round(d, card, cuda_backup.round_backup)
    torch.cuda.synchronize()
    assert cuda_backup.ROUND_LAUNCHES == before + 1
    for x, y in zip(got, _round(d, "cpu", cuda_backup.round_backup_reference)):
        assert torch.equal(x.cpu(), y)


def test_background_save_on_card_holds_the_state_at_save(card, tmp_path):
    """A background checkpoint fetch on the card: SGD steps and a replay
    insert issued right after the save, while the worker copies, do not
    reach the checkpoint."""
    import os
    import sys

    from alphazero_reversi_tpu_torch import checkpoint as ckpt
    from alphazero_reversi_tpu_torch import pipeline

    sys.path.insert(0, os.path.dirname(__file__))
    from torch_configs import tiny_run_config

    cfg = tiny_run_config(str(tmp_path))
    cfg.training.async_checkpointing = True
    cfg.training.background_checkpoint_fetch = True
    pipe = pipeline.AlphaZeroPipeline(cfg)
    rows = _training_rows(64, 1)
    pipe.buffer = replay.add(pipe.buffer, *(x.to(card) for x in rows))
    pipe.learner.steps(pipe.buffer, pipe.generator, 2, 16)
    pipe.iteration = 1
    want = ckpt.to_host(pipe._checkpoint_tree())
    pipe.save_checkpoint()
    pipe.learner.steps(pipe.buffer, pipe.generator, 4, 16)
    pipe.buffer = replay.add(pipe.buffer, *(x.to(card) for x in rows))
    pipe._join_bg_save()
    got = ckpt.restore_checkpoint(ckpt.latest_checkpoint(
        cfg.training.checkpoint_dir))
    for x, y in zip(got["learner"]["net"].values(),
                    want["learner"]["net"].values()):
        assert torch.equal(x, y)
    for i, st in want["learner"]["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(got["learner"]["optimizer"]["state"][i][k], v)
    for k in ("planes", "policy", "value", "cursor", "size"):
        x, y = got["replay"][k], want["replay"][k]
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


def _bn(channels: int, device, seed: int):
    """A BatchNorm of the net with random running statistics and affine
    parameters, in eval mode, with planted edge cases: channel 0 gets weight
    0 and bias -0.0 (its outputs are signed zeros), channel 1 (where there
    is one) a zero variance, and the last channel a huge weight."""
    g = torch.Generator().manual_seed(seed)
    bn = resnet._BatchNorm(channels)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(channels, generator=g))
        bn.running_var.copy_(torch.rand(channels, generator=g) * 3)
        bn.weight.copy_(torch.randn(channels, generator=g))
        bn.bias.copy_(torch.randn(channels, generator=g))
        bn.weight[0], bn.bias[0] = 0.0, -0.0
        if channels > 1:
            bn.running_var[1] = 0.0
            bn.weight[-1] = 1e30
    return bn.to(device).eval()


def _bn_input(rows: int, channels: int, dtype, layout: str, device,
              seed: int):
    """[rows, C, 8, 8] normal values in the given memory layout, with NaN,
    +-inf, -0.0 and values near the dtype's largest planted."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, channels, 8, 8, generator=g) * 4
    flat = x.view(-1)
    big = torch.finfo(dtype).max
    for i, v in enumerate((float("nan"), float("inf"), -float("inf"), -0.0,
                           big, -big, big / 2)):
        flat[i * 997::7919] = v
    x = x.to(device=device, dtype=dtype)
    fmt = (torch.channels_last if layout == "channels_last"
           else torch.contiguous_format)
    return x.contiguous(memory_format=fmt)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return (a.stride() == b.stride()
            and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype])))


@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("residual", [False, True], ids=["bn", "bn_res"])
@pytest.mark.parametrize("rows,channels", [(8192, 128), (16384, 128),
                                           (16384, 2), (16384, 1)])
def test_bn_act_kernel_matches_plain_version(card, rows, channels, residual,
                                             dtype, layout):
    """azr_bn_act at the trunk's shapes of the flagship (8,192 rows) and
    default (16,384) self-play cells and at the heads' C = 2 and 1: the
    eager composition's bits (NaN, signed zeros, infinities and overflow
    included) in the input's memory layout, one launch a call."""
    from alphazero_reversi_tpu_torch.models import cuda_bn

    bn = _bn(channels, card, channels)
    x = _bn_input(rows, channels, dtype, layout, card, 1)
    res = _bn_input(rows, channels, dtype, layout, card, 2) \
        if residual else None
    with torch.no_grad():
        before = cuda_bn.LAUNCHES
        got = cuda_bn.bn_act(x, bn, res)
        assert cuda_bn.LAUNCHES == before + 1
        want = cuda_bn.bn_act_reference(x, bn, res)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    assert torch.isnan(got).any() and (got == 0).any()


def _flagship_net(card):
    """The 5x128 bf16 BN net with random weights and running statistics."""
    torch.manual_seed(11)
    net = resnet.build_network(ModelConfig())
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0, 0.5)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 2.0)
        for name, p in net.named_parameters():
            if "bn" in name:
                p.normal_(0.5 if name.endswith("weight") else 0.0, 0.3)
    return net.to(card)


def _random_planes(rng, rows: int, card) -> torch.Tensor:
    """[rows, 8, 8, 3] float32 planes of random 0/1 cells."""
    return torch.from_numpy(rng.integers(0, 2, (rows, 8, 8, 3)).astype(
        np.float32)).to(card)


@pytest.mark.parametrize("rows", [1, 1024])
def test_eval_forward_takes_the_bn_kernel_bit_for_bit(card, rows,
                                                      monkeypatch):
    """A flagship-width eval forward launches azr_bn_act at its 13
    BatchNorm sites and gives the forward through the plain versions bit
    for bit (1,024 rows as the self-play's; one row as ``analyze``'s)."""
    from alphazero_reversi_tpu_torch.models import cuda_bn

    net = _flagship_net(card)
    planes = _random_planes(np.random.default_rng(rows), rows, card)
    before = cuda_bn.LAUNCHES
    got = resnet.apply_eval(net, planes)
    assert cuda_bn.LAUNCHES == before + 13
    monkeypatch.setattr(resnet, "bn_act", cuda_bn.bn_act_reference)
    want = resnet.apply_eval(net, planes)
    torch.cuda.synchronize()
    assert cuda_bn.LAUNCHES == before + 13
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_eval_forward_graph_replay_matches_eager(card):
    """An eval forward captured in a CUDA graph (13 azr_bn_act launches
    among the convs) and replayed on new planes gives the eager forward's
    bits."""
    from alphazero_reversi_tpu_torch.models import cuda_bn

    net = _flagship_net(card)
    rng = np.random.default_rng(5)
    static = _random_planes(rng, 256, card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        resnet.apply_eval(net, static)  # warm-up: cuDNN plans, the library
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = cuda_bn.LAUNCHES
    with torch.cuda.graph(graph):
        out = resnet.apply_eval(net, static)
    assert cuda_bn.LAUNCHES == before + 13
    fresh = _random_planes(rng, 256, card)
    static.copy_(fresh)
    graph.replay()
    want = resnet.apply_eval(net, fresh)
    torch.cuda.synchronize()
    for g, w in zip(out, want):
        assert torch.equal(g, w)


def test_train_forward_keeps_the_eager_bn(card):
    """Train mode (``apply_train``: batch statistics, a backward pass)
    never launches azr_bn_act."""
    from alphazero_reversi_tpu_torch.models import cuda_bn

    net = _flagship_net(card).train()
    planes = env.canonical_planes(env.initial_state((64,))).to(card)
    before = cuda_bn.LAUNCHES
    (logits, value), _ = resnet.apply_train(net, planes)
    (logits.sum() + value.sum()).backward()
    torch.cuda.synchronize()
    assert cuda_bn.LAUNCHES == before


def test_stock_batchnorm_keeps_its_own_arithmetic(card):
    """A stock ``nn.BatchNorm2d`` in eval mode (``F.batch_norm``, which
    rounds unlike the net's BatchNorm) takes the plain version: no launch,
    and its own output."""
    from alphazero_reversi_tpu_torch.models import cuda_bn

    bn = torch.nn.BatchNorm2d(128).to(card).eval()
    x = _bn_input(1024, 128, torch.bfloat16, "channels_last", card, 3)
    with torch.no_grad():
        before = cuda_bn.LAUNCHES
        got = cuda_bn.bn_act(x, bn)
        assert cuda_bn.LAUNCHES == before
        want = torch.relu(bn(x))
    assert _same_bits(got, want)
