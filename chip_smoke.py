#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 1 if any failed):

1. build every CUDA kernel of the path from ``alphazero_reversi_tpu_torch/
   csrc`` (one ``nvcc`` per source, started together);
2. hold each kernel entry point against its plain PyTorch version, on the
   card and on the CPU, at the shapes the flagship self-play gives it
   (``azr_backup_link``, the JAX-shaped interface, and ``azr_round_backup``,
   the search's round tail; the round inputs come from
   ``tests/torch_round_inputs.py``, which imports no JAX), check a
   captured-graph replay, and time each: device time per launch from a
   replayed CUDA graph of 200 launches, the wrapper's issue rate back to
   back, the plain version, one library call, and the bound;
3. play one flagship self-play batch (``configs/flagship_run.json``: 1024
   games, Gumbel-32, 4 stages, tree reuse, 60 moves, the 5x128 bf16 ResNet
   with seeded random weights) and check that every simulation round went
   through ``azr_round_backup``, once;
4. play a small float32 batch on the card and on the CPU with the same
   weights and Gumbel draws (TF32 off): actions and trajectories must agree.
   The CPU path is the one the CPU tests hold against the JAX package.

Prints the ``kernels`` JSON line, the self-play rate, the card's name and
power limit, and last ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the package beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # non-tensor-core float32


def _time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _backup_inputs(rng, batch, nodes_n, levels, links, dev):
    """Backup+link arguments shaped like a flagship round: each descent
    visits distinct nodes, 1..12 levels deep, padded with -1 to ``levels``;
    its link is the (leaf, action) edge it expands, so that cell takes a
    visit and a link, both exact integers (their order cannot matter)."""
    s = 130
    # packed visits|child cells hold exact integers, value sums floats
    visits = rng.integers(0, 33, (batch, nodes_n, 65))
    stats = np.concatenate(
        [visits * 1024.0 + rng.integers(0, nodes_n, visits.shape),
         visits * rng.uniform(-1, 1, visits.shape)], -1).astype(np.float32)
    p = levels * links
    nodes = np.full((batch, p), -1, np.int32)
    actions = np.zeros((batch, p), np.int32)
    lnode = np.zeros((batch, links), np.int32)
    lact = np.zeros((batch, links), np.int32)
    for b in range(batch):
        for l in range(links):
            depth = rng.integers(1, 13)
            path = rng.permutation(nodes_n)[:depth]
            acts = rng.integers(0, 65, depth)
            nodes[b, l * levels:l * levels + depth] = path
            actions[b, l * levels:l * levels + depth] = acts
            lnode[b, l], lact[b, l] = path[-1], acts[-1]
    arrays = dict(
        stats=stats.reshape(batch, nodes_n * s), nodes=nodes,
        actions=actions, incs=rng.uniform(-1, 1, (batch, p)).astype(
            np.float32),
        link_nodes=lnode, link_actions=lact,
        link_slots=rng.integers(1, nodes_n, (batch, links)).astype(np.int32),
        do_link=rng.random((batch, links)) < 0.9)
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


ARGS = ("nodes", "actions", "incs", "link_nodes", "link_actions",
        "link_slots", "do_link")
SOURCE = "alphazero_reversi_tpu_torch/csrc/backup_link.cu"
REPLACES = "alphazero_reversi_tpu/mcts/pallas_backup.py:44"


def _graph_ms(fn, launches: int = 200, replays: int = 5) -> float:
    """Device time per launch: ``launches`` calls of ``fn`` captured in one
    CUDA graph, replayed ``replays`` times between CUDA events (no host
    issue cost inside the timed span)."""
    fn()  # load the library outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def _scatter_yardstick(nodes, actions, incs, link_nodes, link_actions,
                       link_slots, do_link, m):
    """Flat indices and updates of one backup+link call (``m``: dropped),
    for the library call ``scatter_add_`` and the bound's cell count."""
    ok = nodes >= 0
    base = nodes.clamp_min(0).long() * 130 + actions.long()
    idx = torch.cat([torch.where(ok, base, m), torch.where(ok, base + 65, m),
                     torch.where(do_link, link_nodes.long() * 130
                                 + link_actions.long(), m)], -1)
    idx = torch.where((idx >= 0) & (idx < m), idx, m)
    upd = torch.cat([torch.full(nodes.shape, 1024.0, device=nodes.device),
                     incs.float(), link_slots.float()], -1)
    return idx, upd


def _touched(idx, m) -> tuple:
    """(updates, distinct cells) among the flat indices ``idx`` [B, U]."""
    live = idx < m
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None] * m + idx
    return int(live.sum()), int(torch.unique(rows[live]).numel())


def _bound_ms(nbytes: int, adds: int) -> float:
    return max(nbytes / H100_BYTES_PER_S, adds / H100_F32_FLOPS) * 1e3


def check_backup_kernel(results: dict) -> None:
    """azr_backup_link (the JAX-shaped entry point) vs its plain version at
    the flagship's last stage (B=1024, N=33, P=24): L=1 must be bit-exact;
    L=4 (colliding cells, the plain version's CUDA scatter_add_ adds them in
    atomic order) within 1e-6 relative to max(|value|, 1), and bit-exact
    against the plain version on the CPU, which adds in the kernel's
    order."""
    from alphazero_reversi_tpu_torch.mcts import cuda_backup

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    max_err = 0.0
    d1 = _backup_inputs(rng, 1024, 33, 24, 1, dev)
    got, want = d1["stats"].clone(), d1["stats"].clone()
    cuda_backup.backup_and_link(got, *(d1[k] for k in ARGS))
    cuda_backup.backup_and_link_reference(want, *(d1[k] for k in ARGS))
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("backup kernel != plain version at L=1: max "
                             f"|diff| {(got - want).abs().max().item()}")
    max_err = max(max_err, (got - want).abs().max().item())

    d4 = _backup_inputs(rng, 1024, 33, 24, 4, dev)
    got4, want4 = d4["stats"].clone(), d4["stats"].clone()
    cuda_backup.backup_and_link(got4, *(d4[k] for k in ARGS))
    cuda_backup.backup_and_link_reference(want4, *(d4[k] for k in ARGS))
    cpu4 = d4["stats"].cpu()
    cuda_backup.backup_and_link_reference(cpu4, *(d4[k].cpu() for k in ARGS))
    torch.cuda.synchronize()
    diff4 = (got4 - want4).abs()
    rel4 = (diff4 / want4.abs().clamp_min(1.0)).max().item()
    max_err = max(max_err, (got4.cpu() - cpu4).abs().max().item())
    if rel4 > 1e-6:
        raise AssertionError(f"backup kernel vs plain version at L=4: max "
                             f"relative diff {rel4} > 1e-6")
    if not torch.equal(got4.cpu(), cpu4):
        raise AssertionError("backup kernel != CPU plain version at L=4")

    # timing at the L=1 flagship shape (in place, repeated on one buffer)
    work = d1["stats"].clone()
    args = [d1[k] for k in ARGS]
    device_ms = _graph_ms(lambda: cuda_backup.backup_and_link(work, *args))
    issue_ms = _time_ms(lambda: cuda_backup.backup_and_link(work, *args), 200)
    plain_ms = _time_ms(
        lambda: cuda_backup.backup_and_link_reference(work, *args), 200)
    b, m = work.shape
    idx, upd = _scatter_yardstick(*args, m)
    padded = torch.zeros(b, m + 1, device=dev)
    library_ms = _time_ms(lambda: padded.scatter_add_(1, idx, upd), 200)
    # bound: arguments read once, each touched cell read and written once;
    # one add per update
    adds, cells = _touched(idx, m)
    nbytes = sum(d1[k].numel() * d1[k].element_size() for k in ARGS) \
        + cells * 8
    results["backup_link"] = dict(
        name="backup_link", route="cuda", source=SOURCE, replaces=REPLACES,
        entry="azr_backup_link", main_path=False,
        shape="B=1024 N=33 P=24 L=1", exact_l1=True, max_rel_err_l4=rel4,
        max_abs_err=max_err, ms=device_ms, issue_ms=issue_ms,
        plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=_bound_ms(nbytes, adds), bound_by="bytes",
        bound_bytes=nbytes, launches=0)


ROUND_ARGS = ("stats", "pn", "pa", "pt", "eval_tomove", "value", "leaves",
              "leaf_acts", "slot0", "root_to_move", "root_visit", "root_vsum")


def _round_tensors(d, device) -> dict:
    return {k: v if k == "slot0" else torch.from_numpy(np.array(v)).to(device)
            for k, v in d.items()}


def _round_call(fn, t) -> None:
    fn(*(t[k] for k in ROUND_ARGS))


def check_round_kernel(results: dict) -> None:
    """azr_round_backup (the search's entry point: a round's whole backup,
    links and root totals) vs its plain version at the flagship's last
    stage (B=1024, N=33, 24 levels; also 8 levels at L=4): bit-exact against
    the plain version on the CPU at L=1, at L=4 with in-round duplicates,
    and with nodes past the tree and actions outside [0, 65); bit-exact
    against the plain version on the card at L=1; a captured-graph replay of
    one launch equals the eager launch."""
    from alphazero_reversi_tpu_torch.mcts import cuda_backup
    from torch_round_inputs import round_inputs

    dev = torch.device("cuda")
    outs = ("stats", "root_visit", "root_vsum")
    max_err = 0.0
    cases = ((1, 24, False), (4, 8, False), (4, 24, False), (4, 8, True),
             (4, 24, True))  # one-step path at P <= 32, stepwise at P=96
    for seed, (links, levels, odd) in enumerate(cases):
        d = round_inputs(np.random.default_rng(seed), 1024, 33, levels,
                         links, odd=odd)
        got = _round_tensors(d, dev)
        _round_call(cuda_backup.round_backup, got)
        cpu = _round_tensors(d, "cpu")
        _round_call(cuda_backup.round_backup_reference, cpu)
        torch.cuda.synchronize()
        for k in outs:
            max_err = max(max_err, (got[k].cpu() - cpu[k]).abs().max().item())
            if not torch.equal(got[k].cpu(), cpu[k]):
                raise AssertionError(f"round kernel != CPU plain version in "
                                     f"{k} (L={links}, levels={levels}, "
                                     f"odd={odd})")
        if links == 1:
            card = _round_tensors(d, dev)
            _round_call(cuda_backup.round_backup_reference, card)
            if not all(torch.equal(got[k], card[k]) for k in outs):
                raise AssertionError("round kernel != card plain version at "
                                     "L=1")
            d1 = d

    graph_t = _round_tensors(d1, dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _round_call(cuda_backup.round_backup, graph_t)
    graph.replay()
    eager = _round_tensors(d1, dev)
    _round_call(cuda_backup.round_backup, eager)
    torch.cuda.synchronize()
    if not all(torch.equal(graph_t[k], eager[k]) for k in outs):
        raise AssertionError("graph replay of the round kernel != eager")

    # timing at the L=1 flagship shape (in place, repeated on one buffer)
    t = _round_tensors(d1, dev)
    args = [t[k] for k in ROUND_ARGS]
    device_ms = _graph_ms(lambda: cuda_backup.round_backup(*args))
    issue_ms = _time_ms(lambda: cuda_backup.round_backup(*args), 200)
    plain_ms = _time_ms(
        lambda: cuda_backup.round_backup_reference(*args), 200)
    # library yardstick: one scatter_add_ over the round's flat updates
    b, m = t["stats"].shape
    sign = torch.where(t["pt"] == t["eval_tomove"].float(), 1.0, -1.0)
    link_ok = t["leaf_acts"] >= 0  # L=1: no in-round duplicates
    idx, upd = _scatter_yardstick(
        t["pn"], t["pa"], sign * t["value"], t["leaves"],
        t["leaf_acts"].clamp_min(0), torch.full_like(t["leaves"], d1["slot0"]),
        link_ok, m)
    padded = torch.zeros(b, m + 1, device=dev)
    library_ms = _time_ms(lambda: padded.scatter_add_(1, idx, upd), 200)
    # bound: every argument read once (int64 indices, pt, the [B, L] and [B]
    # arrays), root_visit and root_vsum also written once, each touched
    # cell read and written once; one add per update and per lane's value
    adds, cells = _touched(idx, m)
    read = ("pn", "pa", "pt", "eval_tomove", "value", "leaves", "leaf_acts",
            "root_to_move", "root_visit", "root_vsum")
    nbytes = sum(t[k].numel() * t[k].element_size() for k in read) \
        + (t["root_visit"].numel() * 4 + t["root_vsum"].numel() * 4) \
        + cells * 8
    adds += t["value"].numel() * 2
    results["round_backup"] = dict(
        name="round_backup", route="cuda", source=SOURCE, replaces=REPLACES,
        entry="azr_round_backup", main_path=True,
        shape="B=1024 N=33 levels=24 L=1", exact_l1=True, exact_l4=True,
        graph_replay_equal=True, max_abs_err=max_err, ms=device_ms,
        issue_ms=issue_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=_bound_ms(nbytes, adds), bound_by="bytes",
        bound_bytes=nbytes)


def flagship_selfplay(results: dict, carry: dict) -> None:
    """One flagship self-play batch through the port's public entry point;
    the config, net and trajectory go on to ``flagship_training``."""
    from alphazero_reversi_tpu_torch import selfplay
    from alphazero_reversi_tpu_torch.config import Config
    from alphazero_reversi_tpu_torch.env import bitboard as env
    from alphazero_reversi_tpu_torch.mcts import cuda_backup
    from alphazero_reversi_tpu_torch.models import resnet

    cfg = Config.load(str(ROOT / "configs" / "flagship_run.json"))
    torch.manual_seed(cfg.seed)
    net = resnet.build_network(cfg.model).cuda()
    kw = selfplay.search_kwargs(cfg.mcts, cfg.self_play, cfg.env_compat)
    games = cfg.self_play.num_parallel_games
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    # warm-up move (cuDNN plans, first launches); not counted below
    selfplay.play_games(net, num_games=games, generator=gen,
                        **{**kw, "max_moves": 1})

    torch.cuda.synchronize()
    cuda_backup.LAUNCHES = cuda_backup.ROUND_LAUNCHES = 0
    t0 = time.perf_counter()
    traj = selfplay.play_games(net, num_games=games, generator=gen, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = cuda_backup.ROUND_LAUNCHES
    results["round_backup"]["launches"] = launches
    results["backup_link"]["launches"] = cuda_backup.LAUNCHES

    tensors = [*traj[:5], *traj.final_state, traj.actions]
    if any(t.device.type != "cuda" for t in tensors):
        raise AssertionError("self-play output left the card")
    live_slots = int(traj.valid.any(1).sum())
    rounds = cfg.mcts.num_simulations // cfg.mcts.batch_size
    if launches != rounds * live_slots:
        raise AssertionError(f"round kernel launched {launches} times, "
                             f"expected {rounds} x {live_slots} live slots")
    if cuda_backup.LAUNCHES:
        raise AssertionError("the search launched azr_backup_link; its "
                             "rounds should take azr_round_backup")
    valid = traj.valid
    policy = traj.policy[valid]
    if not (torch.isfinite(policy).all() and torch.isfinite(traj.value).all()):
        raise AssertionError("non-finite policy or value")
    torch.testing.assert_close(policy.sum(-1),
                               torch.ones(policy.shape[0], device="cuda"))
    if not traj.final_state.done.all():
        raise AssertionError("a game did not finish in 60 moves")
    # replay the played moves through the env on the CPU: same final state
    s = env.initial_state((games,))
    for t in range(traj.actions.shape[0]):
        act = traj.actions[t].cpu()
        stepped, ok = env.step(s, act.clamp_min(0), compat=cfg.env_compat)
        live = act >= 0
        if not bool(ok[live].all()):
            raise AssertionError(f"an illegal move was played at slot {t}")
        s = env.where_state(live, stepped, s)
    for x, y in zip(s, traj.final_state):
        if not torch.equal(x, y.cpu()):
            raise AssertionError("replayed final state differs")
    positions = int(valid.sum())
    carry.update(cfg=cfg, net=net, traj=traj, kw=kw)
    results["selfplay"] = dict(
        config="configs/flagship_run.json", games=games,
        move_slots=int(traj.actions.shape[0]), live_slots=live_slots,
        positions=positions, seconds=seconds,
        moves_per_s=games * live_slots / seconds,
        positions_per_s=positions / seconds, round_backup_launches=launches)


def cuda_matches_cpu(results: dict) -> None:
    """Small float32 self-play on the card and on the CPU, same weights and
    Gumbel draws, TF32 off: actions and trajectories agree."""
    from alphazero_reversi_tpu_torch import selfplay
    from alphazero_reversi_tpu_torch.config import Config
    from alphazero_reversi_tpu_torch.models import resnet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config.load(str(ROOT / "configs" / "flagship_run.json"))
    cfg.model.compute_dtype = "float32"
    cfg.model.num_res_blocks = 2
    cfg.model.num_filters = 32
    games, moves = 16, 8
    torch.manual_seed(1)
    net_cpu = resnet.build_network(cfg.model)
    net_gpu = copy.deepcopy(net_cpu).cuda()
    kw = {**selfplay.search_kwargs(cfg.mcts, cfg.self_play),
          "max_moves": moves}
    noise = torch.from_numpy(np.random.default_rng(2).gumbel(
        size=(moves, games, 65)).astype(np.float32))
    gpu = selfplay.play_games(net_gpu, num_games=games,
                              gumbel_noise=noise.cuda(), **kw)
    cpu = selfplay.play_games(net_cpu, num_games=games, gumbel_noise=noise,
                              device="cpu", **kw)
    for name in ("actions", "valid", "to_move", "value", "planes"):
        if not torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)):
            raise AssertionError(f"CUDA and CPU self-play differ in {name}")
    for x, y in zip(gpu.final_state, cpu.final_state):
        if not torch.equal(x.cpu(), y):
            raise AssertionError("CUDA and CPU final states differ")
    policy_err = (gpu.policy.cpu() - cpu.policy).abs().max().item()
    if policy_err > 1e-5:
        raise AssertionError(f"CUDA vs CPU policy differs by {policy_err}")
    results["cuda_vs_cpu"] = dict(games=games, moves=moves,
                                  actions_equal=True, policy_max_abs=policy_err)


def _sync_s(t0: float) -> float:
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _check_relabel(traj, relabelled, stats: dict, cfg, rng) -> int:
    """The relabel had candidates and solved some; every value target is in
    {-1, 0, 1}; at 64 solved positions the new label is the sign of a
    full-window solve. Returns the number of positions checked."""
    from alphazero_reversi_tpu_torch import selfplay
    from alphazero_reversi_tpu_torch.env import endgame

    if stats["candidates"] == 0 or stats["solved"] == 0:
        raise AssertionError(f"relabel solved nothing: {stats}")
    valid = traj.valid.cpu().numpy()
    value = relabelled.value.cpu().numpy()
    if not set(np.unique(value[valid])) <= {-1.0, 0.0, 1.0}:
        raise AssertionError("a relabelled value is outside {-1, 0, 1}")
    mine, theirs = (x.cpu().numpy() for x in
                    selfplay.pack_stone_boards(traj.planes))
    to_move = traj.to_move.cpu().numpy()
    empties = 64 - selfplay._popcount64_np((mine | theirs).view(np.uint64))
    # positions are solved empties-ascending: those below the deepest
    # solved count were all solved, even if the budget cut the rest
    limit = stats["max_empties_solved"] - (stats["skipped"] > 0)
    ts, bs = np.nonzero(valid & (empties <= limit))
    pick = rng.choice(len(ts), min(64, len(ts)), replace=False)
    solver = endgame.EndgameSolver(compat=cfg.env_compat)
    for t, b in zip(ts[pick], bs[pick]):
        black, white = (mine[t, b], theirs[t, b]) if to_move[t, b] == 1 \
            else (theirs[t, b], mine[t, b])
        exact = solver.solve(int(black), int(white), int(to_move[t, b]))
        if np.sign(exact.value) != value[t, b]:
            raise AssertionError(f"relabel at ({t}, {b}) is {value[t, b]}, "
                                 f"a full solve gives {exact.value}")
    return len(pick)


def _learner_tensors(learner):
    yield from learner.net.parameters()
    yield from learner.net.buffers()
    for state in learner.state.optimizer.state.values():
        # AdamW keeps its step count on the host unless capturable
        yield from (v for k, v in state.items() if k != "step")


def flagship_training(results: dict, carry: dict) -> None:
    """The training half of the flagship iteration on the card, in the order
    the JAX pipeline runs it: relabel the self-play batch with the exact
    solver (<= 12 empties, 60 s budget), save and reload it, insert it into
    a 200,000-row replay buffer, run ceil(positions / 128) SGD steps
    rounded up to whole chunks of 64, hand the learner's weights and
    running averages to the self-play net, and play one more move."""
    import math
    import tempfile

    from alphazero_reversi_tpu_torch import learner as learner_lib
    from alphazero_reversi_tpu_torch import replay, selfplay

    cfg, net, traj, kw = (carry[k] for k in ("cfg", "net", "traj", "kw"))
    sp, tc = cfg.self_play, cfg.training
    rng = np.random.default_rng(cfg.seed)

    t0 = time.perf_counter()
    relabelled, rstats = selfplay.relabel_exact_values_with_stats(
        traj, sp.exact_value_empties, compat=cfg.env_compat,
        budget_s=sp.exact_value_budget_s or None)
    relabel_s = _sync_s(t0)
    if relabelled.value.device.type != "cuda":
        raise AssertionError("relabelled values left the card")
    checked = _check_relabel(traj, relabelled, rstats, cfg, rng)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = selfplay.save_trajectory(relabelled, tmp, "it000000_b0")
        save_s = time.perf_counter() - t0
        loaded = selfplay.load_trajectory_arrays(path)
        save_bytes = Path(path).stat().st_size
    for name, arr in loaded.items():
        want = getattr(relabelled, name).cpu().numpy()
        if not np.array_equal(arr, want):
            raise AssertionError(f"saved trajectory differs in {name}")

    planes, policy, value, valid = selfplay.flatten_trajectory(relabelled)
    positions = int(valid.sum())
    buf = replay.create(tc.replay_capacity)
    t0 = time.perf_counter()
    buf = replay.add(buf, planes, policy, value, valid)
    add_s = _sync_s(t0)
    if buf.size != positions:
        raise AssertionError(f"buffer holds {buf.size}, expected {positions}")
    if any(t.device.type != "cuda" for t in buf[:3]):
        raise AssertionError("the replay buffer is not on the card")

    chunk = max(1, tc.steps_per_dispatch)
    n_chunks = math.ceil(max(1, math.ceil(positions / tc.batch_size))
                         / chunk)
    learner = learner_lib.Learner(net, tc)
    learner.set_iteration(0)
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    auxes = [learner.steps(buf, gen, chunk, tc.batch_size)
             for _ in range(n_chunks)]
    sgd_s = _sync_s(t0)
    if any(t.device.type != "cuda" for t in _learner_tensors(learner)):
        raise AssertionError("a learner tensor is not on the card")
    host = [{k: v.item() for k, v in a.items()} for a in auxes]
    if not all(np.isfinite(v) for a in host for v in a.values()):
        raise AssertionError(f"non-finite loss or grad_norm: {host}")
    if not host[-1]["loss"] < host[0]["loss"]:
        raise AssertionError(f"the last chunk's mean loss "
                             f"{host[-1]['loss']} is not below the first's "
                             f"{host[0]['loss']}")

    learner.copy_to(net)
    got = net.state_dict()
    for name, t in learner.state_dict().items():
        if not torch.equal(got[name], t):
            raise AssertionError(f"self-play net differs from the learner "
                                 f"in {name}")
    move = selfplay.play_games(net, num_games=sp.num_parallel_games,
                               generator=gen, **{**kw, "max_moves": 1})
    if not (torch.isfinite(move.policy).all()
            and move.valid.all() and (move.actions >= 0).all()):
        raise AssertionError("the trained net's move is not a legal search "
                             "result")

    steps = n_chunks * chunk
    results["training"] = dict(
        relabel={**rstats, "wall_s": relabel_s, "checked_full_solves":
                 checked},
        save_s=save_s, save_bytes=save_bytes, replay_add_s=add_s,
        replay_size=buf.size, replay_capacity=tc.replay_capacity,
        sgd_steps=steps, batch_size=tc.batch_size, sgd_s=sgd_s,
        steps_per_s=steps / sgd_s, samples_per_s=steps * tc.batch_size
        / sgd_s, first_chunk=host[0], last_chunk=host[-1],
        chunk_losses=[a["loss"] for a in host],
        iteration_s_without_gate=results["selfplay"]["seconds"] + relabel_s
        + save_s + add_s + sgd_s)


def learner_cuda_matches_cpu(results: dict, carry: dict) -> None:
    """The learner on the card against the learner on the CPU: a small
    float32 net (2x32), TF32 off, 3 steps on the same batches from the
    flagship trajectory. Losses and grad_norm within 1e-4 relative; BN
    running averages within 1e-4; parameters within 1e-5, except entries
    whose gradient fell below 1e-6 in some step, where Adam's step
    (~lr * g / (|g| + 1e-8)) turns on the rounding of g: there at most
    2 * lr per step."""
    from alphazero_reversi_tpu_torch import learner as learner_lib
    from alphazero_reversi_tpu_torch import selfplay
    from alphazero_reversi_tpu_torch.models import resnet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = carry["cfg"]
    mcfg = copy.deepcopy(cfg.model)
    mcfg.compute_dtype, mcfg.num_res_blocks, mcfg.num_filters = \
        "float32", 2, 32
    torch.manual_seed(3)
    net = resnet.build_network(mcfg)
    states = {d: learner_lib.create_train_state(net, cfg.training, device=d)
              for d in ("cuda", "cpu")}
    planes, policy, value, valid = selfplay.flatten_trajectory(carry["traj"])
    rows = torch.nonzero(valid).squeeze(1).cpu().numpy()
    rng = np.random.default_rng(4)
    steps, lr = 3, cfg.training.learning_rate
    small = {}
    max_aux = 0.0
    for _ in range(steps):
        idx = torch.from_numpy(rng.choice(rows, cfg.training.batch_size))
        batch = [x[idx.cuda()] for x in (planes, policy, value)]
        aux = {d: learner_lib.train_step(
            st, *(x.to(d) for x in batch)) for d, st in states.items()}
        for k, v in aux["cpu"].items():
            rel = abs(aux["cuda"][k].item() - v.item()) / abs(v.item())
            max_aux = max(max_aux, rel)
            if rel > 1e-4:
                raise AssertionError(f"card vs CPU {k}: relative {rel}")
        for name, p in states["cpu"].net.named_parameters():
            small[name] = small.get(name, False) | (p.grad.abs() < 1e-6)
    cpu = states["cpu"].net.state_dict()
    max_param = max_loose = max_stat = 0.0
    for name, t in states["cuda"].net.state_dict().items():
        diff = (t.cpu().double() - cpu[name].double()).abs()
        if name not in small:
            max_stat = max(max_stat, diff.max().item())
            continue
        loose = small[name].cpu()
        max_param = max(max_param, torch.where(loose, 0, diff).max().item())
        max_loose = max(max_loose, torch.where(loose, diff, 0).max().item())
    if max_param > 1e-5 or max_loose > 2 * lr * steps or max_stat > 1e-4:
        raise AssertionError(f"card vs CPU learner: params {max_param}, "
                             f"tiny-gradient params {max_loose}, BN stats "
                             f"{max_stat}")
    results["learner_cuda_vs_cpu"] = dict(
        steps=steps, batch=cfg.training.batch_size, net="2x32 float32",
        max_aux_rel=max_aux, max_param_abs=max_param,
        max_tiny_grad_param_abs=max_loose, max_bn_stat_abs=max_stat)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "alphazero_reversi_tpu_torch").is_dir():
        print("chip_smoke: alphazero_reversi_tpu_torch/ not found beside "
              "this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))  # torch_round_inputs (JAX-free)
    results: dict = {}
    carry: dict = {}  # flagship config, net and trajectory between phases
    failed = []

    def phase(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # report every phase, then fail the run
            failed.append(name)
            traceback.print_exc()
        print(f"phase {name}: {'FAILED' if name in failed else 'ok'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    def build():
        from alphazero_reversi_tpu_torch.kernels import build as kbuild
        t0 = time.perf_counter()
        kbuild.build(["backup_link"], solver=True)
        results["build_s"] = time.perf_counter() - t0
        print(f"build_s {results['build_s']:.2f}", flush=True)

    phase("build", build)
    if not failed:
        phase("kernel_check", lambda: (check_backup_kernel(results),
                                       check_round_kernel(results)))
    if not failed:
        phase("flagship_selfplay", lambda: flagship_selfplay(results, carry))
        if "traj" in carry:
            phase("flagship_training",
                  lambda: flagship_training(results, carry))
        phase("cuda_vs_cpu", lambda: cuda_matches_cpu(results))
        if "traj" in carry:
            phase("learner_cuda_vs_cpu",
                  lambda: learner_cuda_matches_cpu(results, carry))

    kernels = [results[k] for k in ("backup_link", "round_backup")
               if k in results]
    if kernels:
        print(json.dumps({"kernels": kernels}))
    if "selfplay" in results:
        print(json.dumps({"selfplay": results["selfplay"]}))
    if "cuda_vs_cpu" in results:
        print(json.dumps({"cuda_vs_cpu": results["cuda_vs_cpu"]}))
    if "training" in results:
        print(json.dumps({"training": {
            **results["training"],
            "learner_cuda_vs_cpu": results.get("learner_cuda_vs_cpu")}}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}")
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
