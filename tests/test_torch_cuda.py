"""The port on a CUDA card: the backup+link kernel's two entry points
against their plain versions; the env, a Gumbel search, the replay buffer
and the learner on the card against the same code on the CPU; and SGD steps
that never sync with the host. Every test here needs a card and skips
without one.

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
from alphazero_reversi_tpu_torch.mcts import gumbel
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
