#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 1 if any failed):

1. ``build``: build every kernel of the path from the checkout (one
   ``nvcc`` per ``alphazero_reversi_tpu_torch/csrc`` source, and the host
   endgame solver, started together);
2. ``kernel_check``: hold each kernel entry point against its plain PyTorch
   version, on the card and on the CPU (``azr_backup_link``, the
   JAX-shaped interface, and ``azr_round_backup``, the search's round tail,
   at the flagship self-play's shape B=1024 and the gate's B=10 with 32
   path levels; the round inputs come from ``tests/torch_round_inputs.py``,
   which imports no JAX), check a captured-graph replay, and time each:
   device time per launch from a replayed CUDA graph of 200 launches, the
   wrapper's issue rate back to back, the plain version, one library call,
   and the bound; ``azr_round_backup`` also at the default config's PUCT
   shapes (N=401, 60 levels a lane: B=1024 self-play, B=1 ``analyze``, and
   B=64 at L=4 with forced in-round duplicates), where P > 32 takes the
   kernel's stepwise path, and at the bench's multi-leaf shapes (B=1024:
   PUCT-400 at L=16, N=401, 24 levels, P=384; the tiny-net points at L=8,
   N=33, 4 levels, P=32);
3. ``flagship_selfplay``: one flagship self-play batch
   (``configs/flagship_run.json``: 1024 games, Gumbel-32, 4 stages, tree
   reuse, 60 moves, the 5x128 bf16 ResNet with seeded random weights);
   every simulation round must go through ``azr_round_backup``, once;
4. ``flagship_training``: the training half of the iteration on that batch
   (exact-value relabel, ``.npz`` save and reload, 200,000-row replay
   insert, 512 SGD steps at batch 128 whose last chunk must have a lower
   loss than the first, the weights back into the self-play net, one more
   move);
5. ``flagship_gate``: the promotion gate, ``Arena.run_tournament`` at the
   flagship's tournament config (current = the trained net, best = the
   initial net, random; 30 games in 6 merged units, Gumbel-32 at max_depth
   64); every game must finish, the ELO replay must give the leaderboard,
   and each search round must launch ``azr_round_backup`` once;
6. ``checkpoint_roundtrip``: the iteration's checkpoint saved as the
   pipeline saves it and restored into a fresh pipeline: weights, AdamW,
   best, replay and generators equal;
7. ``flagship_iteration_cli``: one whole flagship iteration through
   ``cli.main(["train", "-c", "configs/flagship_run.json", "--iterations",
   "1", ...])``, everything built by the pipeline: the metrics row, the
   checkpoint of iteration 1, and one ``azr_round_backup`` launch per
   search round;
8. ``cuda_vs_cpu``: a small float32 self-play batch on the card and on the
   CPU with the same weights and Gumbel draws (TF32 off): actions and
   trajectories must agree (the CPU path is the one the CPU tests hold
   against the JAX package);
9. ``learner_cuda_vs_cpu``: 3 float32 learner steps on the card and on the
   CPU;
10. ``gate_cuda_vs_cpu``: a tiny float32 merged gate on the card and on
    the CPU with the same weights and sampling draws: per-unit scores
    equal;
11. ``pipeline_cli``: ``cli.main(["train", ...])`` for 2 iterations, then
    ``cli.main(["continue", ...])`` for a third, at a tiny config
    (``tests/torch_configs.py``): iteration counter, metric names, one
    checkpoint per iteration, pruning;
12. ``default_selfplay``: ``configs/default_config.json`` as written (1024
    games, PUCT-400 with Dirichlet noise, the temperature schedule,
    max_depth 64, the 5x128 bf16 net), cut to 3 move slots: 400 fresh
    visits on every live root, legal moves, 400 ``azr_round_backup``
    launches a slot, kernel launches per 60-level round (profiled);
13. ``default_iteration_cli``: ``cli train`` for one iteration and
    ``continue`` for a second at the default config (PUCT self-play and
    the PUCT gate), cut in games, simulations and gate rounds;
14. ``puct_cuda_vs_cpu``: a float32 PUCT search (leaf_batch 4, injected
    noise, warm root) and a small PUCT merged gate on the card and on the
    CPU: visit counts and per-unit scores equal;
15. ``host_play``: ``import-checkpoint`` of a reference-format ``.pth``,
    ``analyze`` at 400 simulations, ``analyze --solve 14``, ``play`` driven
    through stdin for four agent moves, and a transposition-table hit;
16. ``bench``: the benchmark module's functions (env, the tiny-net PUCT
    and Gumbel points, the PUCT-400 and flagship Gumbel points cut, one
    roofline cell, the solvers, a profiled search), each row checked and
    its cut named;
17. ``pipeline_leftovers``: three flagship iterations through ``cli
    train``, cut in games, simulations and SGD steps, with the background
    checkpoint fetch and ``replay_checkpoint_interval`` 2: which saves
    carry a fresh buffer, and every checkpoint holds the state at its save;
18. ``multi_gpu``: the data-parallel path, with the fetch watchdog on
    (its gathers and copies on the watchdog's thread). One iteration of
    the same cut flagship config through ``cli train`` without a process
    group, as a process group of one rank over NCCL (``--coordinator``),
    and without one again: checkpoint, trajectory and metrics equal bit
    for bit (cuDNN deterministic; a float leaf that is not is named and
    held to ``MULTI_GPU_TOL``), and the pipeline's collectives counted;
    ``benchmarks.bench_scaling`` over the cards there are; with two cards
    or more, a two-rank NCCL iteration (``two_ranks``: equal weights, rank
    0 the only writer), else the line says why not. With arguments (``--rank r --world d --port p --out
    dir``) the script is one rank of that two-rank run;
19. ``tournament``: ``cli tournament`` over two flagship-width
    checkpoints written by the port's checkpoint module (``it_000001``,
    ``best_model``) and the random baseline, in the flagship's merged
    Gumbel mode and the default config's per-round PUCT mode, cut to 1
    round at Gumbel-8 and PUCT-4; each plainly and as an NCCL process
    group of one rank: equal ratings, games played and history, the
    collectives issued, ``azr_round_backup`` launches counted by shape.
    ``tournament_ranks(*worlds)`` (not a phase; on a host of four cards,
    ``python -c "import chip_smoke; print(chip_smoke.tournament_ranks(2,
    4))"``) runs the same command over each world of NCCL ranks against
    one card and reports both ELO tables, the games that differ, each
    rank's files and each rank's play and gather-wait seconds.

Prints the ``kernels``, ``selfplay``, ``cuda_vs_cpu``, ``gate``,
``checkpoint``, ``pipeline_cli``, ``iteration_cli``, ``default_selfplay``,
``default_iteration_cli``, ``puct_cuda_vs_cpu``, ``host_play``, ``bench``,
``pipeline_leftovers``, ``multi_gpu``, ``tournament`` and ``training``
JSON lines
(``training.iteration_s`` sums the separately timed phases 3-6;
``iteration_cli_s`` is the pipeline's own iteration from phase 7; each
kernel row's ``launches`` counts the main paths' launches at its shape, and
``launches_other_shapes`` the rest, each with its shape), the card's name
and power limit, and last ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the package beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

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
        bound_bytes=nbytes)


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
    one launch equals the eager launch; and at the gate's shape (B=10,
    32 levels) and phase 19's (B=2 N=9 at 8 levels, B=1 N=5 at 4)
    bit-exact against both plain versions. Timed at the flagship's and the
    gate's shapes."""
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

    # the gate's shape, then phase 19's: a merged Gumbel-8 unit pair and a
    # per-round PUCT-4 search
    for seed, (b, n, levels) in enumerate(((10, 33, 32), (2, 9, 8),
                                           (1, 5, 4)), 10):
        case = round_inputs(np.random.default_rng(seed), b, n, levels, 1)
        got = _round_tensors(case, dev)
        _round_call(cuda_backup.round_backup, got)
        cpu = _round_tensors(case, "cpu")
        _round_call(cuda_backup.round_backup_reference, cpu)
        card = _round_tensors(case, dev)
        _round_call(cuda_backup.round_backup_reference, card)
        torch.cuda.synchronize()
        for k in outs:
            max_err = max(max_err,
                          (got[k].cpu() - cpu[k]).abs().max().item())
            if not (torch.equal(got[k].cpu(), cpu[k])
                    and torch.equal(got[k], card[k])):
                raise AssertionError(f"round kernel != plain version in {k} "
                                     f"at B={b} N={n} levels={levels}")
        if b == 10:
            gate = case

    flagship = _time_round(_round_tensors(d1, dev), d1["slot0"])
    at_gate = _time_round(_round_tensors(gate, dev), gate["slot0"])
    results["round_backup"] = dict(
        name="round_backup", route="cuda", source=SOURCE, replaces=REPLACES,
        entry="azr_round_backup", main_path=True,
        shape="B=1024 N=33 levels=24 L=1", exact_l1=True, exact_l4=True,
        graph_replay_equal=True, max_abs_err=max_err, **flagship,
        gate_shape="B=10 N=33 levels=32 L=1", gate_exact=True,
        exact_tournament_shapes=["B=2 N=9 levels=8 L=1",
                                 "B=1 N=5 levels=4 L=1"],
        **{f"gate_{k}": v for k, v in at_gate.items()})


def _time_round(t: dict, slot0: int) -> dict:
    """Device ms per launch (replayed graph), wrapper issue ms, the plain
    version's ms, one library call's ms and the bound, for the round
    arguments ``t`` (timed in place, repeated on one buffer)."""
    from alphazero_reversi_tpu_torch.mcts import cuda_backup

    dev = torch.device("cuda")
    args = [t[k] for k in ROUND_ARGS]
    device_ms = _graph_ms(lambda: cuda_backup.round_backup(*args))
    issue_ms = _time_ms(lambda: cuda_backup.round_backup(*args), 200)
    plain_ms = _time_ms(
        lambda: cuda_backup.round_backup_reference(*args), 200)
    # library yardstick: one scatter_add_ over the round's flat updates
    # (signs, per-lane values, slots and the in-round duplicate mask made
    # beforehand)
    b, m = t["stats"].shape
    L = t["leaves"].shape[1]
    levels = t["pn"].shape[1] // L
    sign = torch.where(t["pt"] == t["eval_tomove"].float().repeat_interleave(
        levels, 1), 1.0, -1.0)
    same = (t["leaves"][:, :, None] == t["leaves"][:, None, :]) & (
        t["leaf_acts"][:, :, None] == t["leaf_acts"][:, None, :])
    earlier = torch.ones(L, L, dtype=torch.bool, device=dev).tril(-1)
    link_ok = (t["leaf_acts"] >= 0) & ~(same & earlier).any(-1)
    slots = slot0 + torch.arange(L, device=dev).expand_as(t["leaves"])
    idx, upd = _scatter_yardstick(
        t["pn"], t["pa"], sign * t["value"].repeat_interleave(levels, 1),
        t["leaves"], t["leaf_acts"].clamp_min(0), slots, link_ok, m)
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
    return dict(ms=device_ms, issue_ms=issue_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=_bound_ms(nbytes, adds),
                bound_by="bytes", bound_bytes=nbytes)


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
    results["round_backup"]["launches_by_path"] = {
        "flagship_selfplay": launches}
    results["backup_link"]["launches_by_path"] = {
        "flagship_selfplay": cuda_backup.LAUNCHES}

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
    # the seeded initial net is the gate's "best" player
    carry.update(cfg=cfg, net=net, traj=traj, kw=kw,
                 initial_net=copy.deepcopy(net))
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
    carry.update(learner=learner, buffer=buf, generator=gen)
    results["training"] = dict(
        relabel={**rstats, "wall_s": relabel_s, "checked_full_solves":
                 checked},
        save_s=save_s, save_bytes=save_bytes, replay_add_s=add_s,
        replay_size=buf.size, replay_capacity=tc.replay_capacity,
        sgd_steps=steps, batch_size=tc.batch_size, sgd_s=sgd_s,
        steps_per_s=steps / sgd_s, samples_per_s=steps * tc.batch_size
        / sgd_s, first_chunk=host[0], last_chunk=host[-1],
        chunk_losses=[a["loss"] for a in host])


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


def flagship_gate(results: dict, carry: dict) -> None:
    """The flagship's promotion gate on the card, through
    ``Arena.run_tournament`` at ``configs/flagship_run.json``'s tournament
    config (5 rounds x 2 games for each of 3 pairs: 30 games in 6
    single-colour units, merged pairings, Gumbel-32 over 16 considered
    actions at temperature 0.1, tree reuse, the 5x128 bf16 net): current
    (the learner after the SGD phase), best (the seeded initial net) and
    random. Every game must finish, every score lie in {0, 0.5, 1}, the ELO
    replay of the games must give the leaderboard, and every search round
    must have launched azr_round_backup once."""
    from alphazero_reversi_tpu_torch.arena import Arena
    from alphazero_reversi_tpu_torch.elo import ELORatingSystem
    from alphazero_reversi_tpu_torch.mcts import cuda_backup

    cfg = carry["cfg"]
    tcfg = cfg.tournament
    ar = Arena(tcfg, compat=cfg.env_compat)
    ar.add_player("current", carry["learner"].net)
    ar.add_player("best", carry["initial_net"])
    ar.add_player("random", None)
    torch.cuda.synchronize()
    cuda_backup.LAUNCHES = cuda_backup.ROUND_LAUNCHES = 0
    t0 = time.perf_counter()
    board = ar.run_tournament(cfg.seed)
    seconds = _sync_s(t0)
    launches = cuda_backup.ROUND_LAUNCHES
    results["round_backup"]["launches_by_path"]["flagship_gate"] = launches
    results["backup_link"]["launches_by_path"]["flagship_gate"] = \
        cuda_backup.LAUNCHES
    info = dict(ar.play_info)

    games = tcfg.rounds * tcfg.games_per_pair * 3
    if len(ar.elo.history) != games or info["unfinished"]:
        raise AssertionError(f"{len(ar.elo.history)} games scored of "
                             f"{games}, {info['unfinished']} unfinished")
    if not {h["score_a"] for h in ar.elo.history} <= {0.0, 0.5, 1.0}:
        raise AssertionError("a game score is outside {0, 0.5, 1}")
    replay = ELORatingSystem(k=tcfg.elo_k_factor,
                             initial_rating=tcfg.elo_initial)
    for h in ar.elo.history:
        replay.update_ratings(h["player_a"], h["player_b"], h["score_a"])
    if replay.get_leaderboard() != board:
        raise AssertionError("the ELO replay differs from the leaderboard")
    rounds = tcfg.num_simulations  # leaf_batch 1: one round per simulation
    if launches != rounds * info["searches"] or cuda_backup.LAUNCHES:
        raise AssertionError(f"round kernel launched {launches} times for "
                             f"{info['searches']} searches of {rounds} "
                             "rounds")
    ratings = {p["player_id"]: p["rating"] for p in board}
    carry["gate_board"] = ratings
    results["gate"] = dict(
        config="configs/flagship_run.json tournament", games=games,
        units=6, seconds=seconds, searches=info["searches"],
        half_plies=info["half_plies"],
        searched_games=info["searched_games"], moves=info["moves"],
        moves_per_s=info["moves"] / seconds,
        s_per_search=seconds / info["searches"],
        kernel_launches=launches,
        launches_per_search=launches / info["searches"],
        leaderboard=board,
        promoted=ratings["current"] > ratings["best"]
        + tcfg.promotion_elo_margin)


def _pipeline_state_equal(a, b) -> None:
    """Raise unless two pipelines hold the same training state."""
    pairs = [(a.learner.state_dict(), b.learner.state_dict(), "learner"),
             (a.best_net.state_dict(), b.best_net.state_dict(), "best")]
    for x, y, what in pairs:
        if x.keys() != y.keys() or not all(torch.equal(x[k], y[k])
                                           for k in x):
            raise AssertionError(f"restored {what} weights differ")
    sa, sb = (p.learner.state.optimizer.state_dict() for p in (a, b))
    if sa["param_groups"] != sb["param_groups"] or not all(
            torch.equal(v, sb["state"][i][k])
            for i, st in sa["state"].items() for k, v in st.items()):
        raise AssertionError("restored AdamW state differs")
    if not all(torch.equal(x, y) for x, y in zip(a.buffer[:3], b.buffer[:3])) \
            or a.buffer[3:] != b.buffer[3:]:
        raise AssertionError("restored replay buffer differs")
    for g in ("generator", "host_generator"):
        if not torch.equal(getattr(a, g).get_state(),
                           getattr(b, g).get_state()):
            raise AssertionError(f"restored {g} state differs")
    if (a.iteration, a.best_elo, a.learner.state.step) != \
            (b.iteration, b.best_elo, b.learner.state.step):
        raise AssertionError("restored counters differ")


def checkpoint_roundtrip(results: dict, carry: dict) -> None:
    """The flagship iteration's checkpoint: a pipeline holding the state the
    phases above left (the learner after SGD, the 200,000-row buffer, best
    = the initial net, the SGD generator) saves it as the pipeline does
    after the gate, and a fresh pipeline restores it; every part must be
    equal. Reports the seconds the loop waits (the host copy) and the whole
    save's seconds, and the file's bytes."""
    import tempfile

    from alphazero_reversi_tpu_torch import checkpoint as ckpt
    from alphazero_reversi_tpu_torch.pipeline import AlphaZeroPipeline

    cfg = copy.deepcopy(carry["cfg"])
    with tempfile.TemporaryDirectory() as tmp:
        cfg.training.checkpoint_dir = str(Path(tmp) / "checkpoints")
        cfg.logging.log_dir = str(Path(tmp) / "logs")
        cfg.logging.verbose = False
        pipe = AlphaZeroPipeline(cfg, run_name="smoke")
        pipe.learner = carry["learner"]
        pipe.buffer = carry["buffer"]
        pipe.best_net = carry["initial_net"]
        pipe.generator = carry["generator"]
        pipe.iteration = 1
        pipe.best_elo = carry.get("gate_board", {}).get("best", 1200.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = pipe.save_checkpoint()
        blocking_s = time.perf_counter() - t0
        pipe._join_bg_save()  # background_checkpoint_fetch: the worker
        ckpt.wait_for_saves()
        total_s = time.perf_counter() - t0
        nbytes = (Path(path) / ckpt.STATE_FILE).stat().st_size
        fresh = AlphaZeroPipeline(cfg, run_name="smoke")
        t0 = time.perf_counter()
        if not fresh.load_checkpoint():
            raise AssertionError("no checkpoint found")
        restore_s = _sync_s(t0)
        _pipeline_state_equal(pipe, fresh)
        if fresh.buffer.planes.device.type != "cuda":
            raise AssertionError("the restored buffer is not on the card")
    results["checkpoint"] = dict(
        async_save=cfg.training.async_checkpointing,
        background_fetch=cfg.training.background_checkpoint_fetch,
        blocking_s=blocking_s,
        total_s=total_s, restore_s=restore_s, bytes=nbytes, equal=True)


JAX_METRIC_NAMES = {  # the JAX pipeline's (pipeline.py train() and eval)
    "train/loss", "train/policy_loss", "train/value_loss", "train/lr",
    "train/grad_norm", "selfplay/positions", "selfplay/live_fraction",
    "selfplay/seconds", "train/seconds", "eval/seconds", "replay/size",
    "eval/elo", "eval/best_elo", "eval/random_elo", "eval/promoted"}
RELABEL_STATS = ("candidates", "solved", "unique_solves", "skipped",
                 "seconds", "max_empties_solved", "changed")


def pipeline_cli(results: dict) -> None:
    """``cli.main(["train", ...])`` for 2 iterations, then
    ``cli.main(["continue", ...])`` to 3, on the card, at a tiny config
    (``tests/torch_configs.py``: a 2x32 net, 16 games of Gumbel-4 self-play
    with relabel at <= 10 empties, SGD in chunks of 2, a Gumbel-2 gate of
    1 round x 2 games per pair). Checks the iteration counter, the metric
    names (the JAX pipeline's plus ``checkpoint/seconds``), one checkpoint
    saved per iteration, and that only the newest is kept."""
    import tempfile

    from alphazero_reversi_tpu_torch import checkpoint as ckpt
    from alphazero_reversi_tpu_torch import cli
    from torch_configs import tiny_run_config

    with tempfile.TemporaryDirectory() as tmp:
        cfg = tiny_run_config(tmp, blocks=2, filters=32, games=16,
                              max_moves=60, exact_value_empties=10,
                              gate_simulations=2, use_tensorboard=True)
        cfg_path = str(Path(tmp) / "config.json")
        cfg.save(cfg_path)
        t0 = time.perf_counter()
        for command, total in (("train", "2"), ("continue", "3")):
            if cli.main([command, "-c", cfg_path, "--iterations", total,
                         "--run-name", "smoke"]) != 0:
                raise AssertionError(f"cli {command} failed")
        seconds = _sync_s(t0)
        run = Path(tmp) / "logs" / "smoke"
        rows = [json.loads(line) for line in
                (run / "metrics.jsonl").read_text().splitlines()]
        if [r["step"] for r in rows] != [0, 1, 2]:
            raise AssertionError(f"steps {[r['step'] for r in rows]}")
        want = JAX_METRIC_NAMES | {"checkpoint/seconds"} | {
            f"selfplay/relabel_{k}" for k in RELABEL_STATS}
        for r in rows:
            if set(r) - {"step"} != want:
                raise AssertionError(f"metric names {sorted(set(r))}")
        log = (run / "training.log").read_text()
        for it in (1, 2, 3):
            if f"it_{it:06d}" not in log:
                raise AssertionError(f"no checkpoint of iteration {it}")
        kept = sorted(p.name for p in (Path(tmp) / "checkpoints")
                      .glob("it_*"))
        if kept != ["it_000003"]:
            raise AssertionError(f"checkpoints kept: {kept}")
        tree = ckpt.restore_checkpoint(
            ckpt.latest_checkpoint(cfg.training.checkpoint_dir))
        if tree["iteration"] != 3:
            raise AssertionError(f"iteration {tree['iteration']}")
    results["pipeline_cli"] = dict(
        iterations=3, seconds=seconds,
        s_per_iteration=[r["selfplay/seconds"] + r["train/seconds"]
                         + r["eval/seconds"] + r["checkpoint/seconds"]
                         for r in rows],
        promoted=[r["eval/promoted"] for r in rows], kept=kept)


def flagship_iteration_cli(results: dict) -> None:
    """One whole flagship iteration through the command a user runs:
    ``cli.main(["train", "-c", "configs/flagship_run.json", "--iterations",
    "1", "--run-dir", <tmp>])``: self-play of 1024 games, relabel, save,
    replay insert, SGD, the merged gate of current, best and random, and
    the checkpoint, all built by the pipeline itself. Checks the one
    metrics row (the JAX pipeline's names plus ``checkpoint/seconds``,
    finite, the buffer holding the new positions), the checkpoint of
    iteration 1, and that every search round launched ``azr_round_backup``
    once (a positive multiple of the rounds a search) and nothing
    launched ``azr_backup_link``. Reports the pipeline's own phase seconds,
    their sum and the call's wall clock."""
    import math
    import tempfile

    from alphazero_reversi_tpu_torch import checkpoint as ckpt
    from alphazero_reversi_tpu_torch import cli
    from alphazero_reversi_tpu_torch.config import Config
    from alphazero_reversi_tpu_torch.mcts import cuda_backup

    cfg_path = ROOT / "configs" / "flagship_run.json"
    cfg = Config.load(str(cfg_path))
    # leaf_batch 1: one round a simulation, in self-play and in the gate
    rounds = math.gcd(cfg.mcts.num_simulations,
                      cfg.tournament.num_simulations)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        cuda_backup.LAUNCHES = cuda_backup.ROUND_LAUNCHES = 0
        t0 = time.perf_counter()
        if cli.main(["train", "-c", str(cfg_path), "--iterations", "1",
                     "--run-dir", tmp, "--run-name", "smoke"]) != 0:
            raise AssertionError("cli train failed")
        wall_s = _sync_s(t0)
        launches = cuda_backup.ROUND_LAUNCHES
        results["round_backup"]["launches_by_path"][
            "flagship_iteration_cli"] = launches
        results["backup_link"]["launches_by_path"][
            "flagship_iteration_cli"] = cuda_backup.LAUNCHES
        (run,) = Path(tmp).glob("run_*")
        rows = [json.loads(line) for line in
                (run / "logs" / "smoke" / "metrics.jsonl").read_text()
                .splitlines()]
        if [r["step"] for r in rows] != [0]:
            raise AssertionError(f"steps {[r['step'] for r in rows]}")
        m = rows[0]
        want = JAX_METRIC_NAMES | {"checkpoint/seconds"} | {
            f"selfplay/relabel_{k}" for k in RELABEL_STATS}
        if set(m) - {"step"} != want:
            raise AssertionError(f"metric names {sorted(m)}")
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"a non-finite metric: {m}")
        if not 0 < m["selfplay/positions"] == m["replay/size"]:
            raise AssertionError(f"{m['selfplay/positions']} positions, "
                                 f"buffer {m['replay/size']}")
        kept = sorted(p.name for p in (run / "checkpoints").iterdir())
        if "it_000001" not in kept:
            raise AssertionError(f"checkpoints: {kept}")
        tree = ckpt.restore_checkpoint(str(run / "checkpoints" /
                                           "it_000001"))
        if tree["iteration"] != 1 or tree["replay"]["size"] != \
                m["replay/size"]:
            raise AssertionError("the checkpoint is not iteration 1's")
    if launches <= 0 or launches % rounds or cuda_backup.LAUNCHES:
        raise AssertionError(f"round kernel launched {launches} times (not "
                             f"a positive multiple of {rounds}); "
                             f"backup_link {cuda_backup.LAUNCHES} times")
    parts = {k: m[f"{k}/seconds"]
             for k in ("selfplay", "train", "eval", "checkpoint")}
    results["iteration_cli"] = dict(
        config="configs/flagship_run.json", iterations=1, wall_s=wall_s,
        **{f"{k}_s": v for k, v in parts.items()},
        metrics_sum_s=sum(parts.values()),
        positions=m["selfplay/positions"], loss=m["train/loss"],
        eval_elo=m["eval/elo"], eval_best_elo=m["eval/best_elo"],
        eval_random_elo=m["eval/random_elo"],
        promoted=m["eval/promoted"], checkpoints=kept,
        round_backup_launches=launches,
        searches=launches // rounds if cfg.mcts.num_simulations
        == cfg.tournament.num_simulations else None)


def gate_cuda_matches_cpu(results: dict) -> None:
    """A tiny float32 merged gate (two 1x16 nets and the random player, 6
    units of 3 games, Gumbel-8, tree reuse, temperature 0.5) on the card and
    on the CPU with the same weights and injected sampling draws, TF32 off:
    per-unit scores must be equal."""
    from alphazero_reversi_tpu_torch import arena
    from alphazero_reversi_tpu_torch.config import ModelConfig
    from alphazero_reversi_tpu_torch.env import bitboard as env
    from alphazero_reversi_tpu_torch.models import resnet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(5)
    nets = [resnet.build_network(ModelConfig(
        num_res_blocks=1, num_filters=16, compute_dtype="float32"))
        for _ in range(2)] + [None]
    units = [(i, j, 3, c) for i, j in ((0, 1), (0, 2), (1, 2))
             for c in (env.BLACK, env.WHITE)]
    kw = dict(num_simulations=8, temperature=0.5, algorithm="gumbel",
              max_considered_actions=4, tree_reuse="root")
    pairs = (60 + 16 + 1) // 2
    noise = [torch.from_numpy(np.random.default_rng(u).gumbel(
        size=(2 * pairs, 3, 65)).astype(np.float32)) for u in range(6)]
    cpu = arena.play_units(nets, units, sample_noise=noise, device="cpu",
                           **kw)
    gpu = arena.play_units([n if n is None else n.cuda() for n in nets],
                           units, sample_noise=[x.cuda() for x in noise],
                           **kw)
    for u, (x, y) in enumerate(zip(gpu, cpu)):
        if not np.array_equal(x, y):
            raise AssertionError(f"card vs CPU gate: unit {u} scores {x} "
                                 f"!= {y}")
    results["gate_cuda_vs_cpu"] = dict(units=6, games=18,
                                       scores_equal=True)


PUCT_SHAPES = (  # (entry, batch, nodes, levels, links, forced duplicates)
    ("round_backup_puct", 1024, 401, 60, 1, False),
    ("round_backup_analyze", 1, 401, 60, 1, False),
    ("round_backup_dups", 64, 401, 60, 4, True),
    # the bench's multi-leaf points: PUCT-400 at leaf_batch 16 (its last
    # stage: 24 levels, P=384) and the tiny-net PUCT-32 / Gumbel-32 at
    # leaf_batch 8 (one stage of 4 levels, P=32)
    ("round_backup_lb16", 1024, 401, 24, 16, False),
    ("round_backup_lb8", 1024, 33, 4, 8, False))


def check_round_kernel_puct(results: dict) -> None:
    """azr_round_backup at the default config's PUCT-400 shapes: N=401 and
    60 path levels a lane (max_depth 64: every stage unrolls 60 levels), so
    P = 60 L > 32 takes the kernel's stepwise path. Default self-play
    (B=1024, L=1) and ``analyze`` (B=1) must equal the plain version on the
    CPU and on the card bit for bit; B=64 at L=4 with lane 1 repeating lane
    0 in every game (in-round duplicates, linked once) the CPU plain
    version. And at the bench's multi-leaf shapes (B=1024): PUCT-400 at
    L=16 (N=401, 24 levels, P=384: twelve 32-entry chunks) and the tiny-net
    points at L=8 (N=33, 4 levels, P=32), with in-round duplicates, equal
    to the CPU plain version. Each shape is timed as the flagship's is."""
    from alphazero_reversi_tpu_torch.mcts import cuda_backup
    from torch_round_inputs import round_inputs

    dev = torch.device("cuda")
    outs = ("stats", "root_visit", "root_vsum")
    for seed, (name, batch, nodes_n, levels, links, dups) in enumerate(
            PUCT_SHAPES):
        d = round_inputs(np.random.default_rng(20 + seed), batch, nodes_n,
                         levels, links, dups=dups)
        got = _round_tensors(d, dev)
        _round_call(cuda_backup.round_backup, got)
        cpu = _round_tensors(d, "cpu")
        _round_call(cuda_backup.round_backup_reference, cpu)
        card = None
        if links == 1:
            card = _round_tensors(d, dev)
            _round_call(cuda_backup.round_backup_reference, card)
        torch.cuda.synchronize()
        max_err = 0.0
        for k in outs:
            max_err = max(max_err, (got[k].cpu() - cpu[k]).abs().max().item())
            if not torch.equal(got[k].cpu(), cpu[k]) or (
                    card is not None and not torch.equal(got[k], card[k])):
                raise AssertionError(f"round kernel != plain version in {k} "
                                     f"at {name} (B={batch}, L={links}, "
                                     f"levels={levels})")
        del cpu, card
        results[name] = dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES,
            entry="azr_round_backup", main_path=name != "round_backup_dups",
            shape=f"B={batch} N={nodes_n} levels={levels} L={links}"
            + (" lane 1 = lane 0" if dups else ""),
            exact_cpu=True, exact_card=links == 1, max_abs_err=max_err,
            **_time_round(_round_tensors(d, dev), d["slot0"]),
            launches_by_path={}, launches_other_shapes={})
    # the PUCT-400 search's 6 stages unroll 4-24 levels: its launches run at
    # P = 64-384, the row is timed at the last stage's P=384
    results["round_backup_lb16"]["launches_shape"] = \
        "B=1024 N=401 levels 4-24 (6 stages) L=16, P<=384"


def default_selfplay(results: dict) -> None:
    """``configs/default_config.json`` as written: 1024 games, PUCT-400,
    c_puct 1, Dirichlet alpha 0.03 / epsilon 0.25, the temperature
    schedule, max_depth 64, 6 stages, leaf_batch 1, the 5x128 bf16 ResNet
    with random weights from the config's seed; cut to 3 move slots (each
    its own ``play_games`` call from the last one's states, so each is
    timed; the first also warms up). Every search must give each live root
    400 fresh visits, every round launch ``azr_round_backup`` once, every
    played move be legal. A profiled 60-round search at the same width and
    depth counts the kernel launches a round."""
    from torch.profiler import ProfilerActivity, profile

    from alphazero_reversi_tpu_torch import selfplay
    from alphazero_reversi_tpu_torch.config import Config
    from alphazero_reversi_tpu_torch.env import bitboard as env
    from alphazero_reversi_tpu_torch.mcts import cuda_backup
    from alphazero_reversi_tpu_torch.mcts import search
    from alphazero_reversi_tpu_torch.models import resnet

    cfg = Config.load(str(ROOT / "configs" / "default_config.json"))
    mc = cfg.mcts
    if (mc.algorithm, mc.num_simulations, mc.max_depth, mc.num_stages,
            mc.batch_size) != ("puct", 400, 64, 6, 1):
        raise AssertionError(f"default config changed: {mc}")
    torch.manual_seed(cfg.seed)
    net = resnet.build_network(cfg.model).cuda()
    kw = selfplay.search_kwargs(mc, cfg.self_play, cfg.env_compat)
    games, slots = cfg.self_play.num_parallel_games, 3
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    searches = []
    real = search.run_search

    def recording(*args, **kwargs):
        res = real(*args, **kwargs)
        searches.append(res.visit_counts.sum(-1))
        return res

    states = env.initial_state((games,), device="cuda")
    slot_s, actions = [], []
    selfplay.search_lib.run_search = recording
    try:
        torch.cuda.synchronize()
        cuda_backup.ROUND_LAUNCHES = 0
        for _ in range(slots):
            t0 = time.perf_counter()
            traj = selfplay.play_games(net, num_games=games, generator=gen,
                                       init_states=states,
                                       **{**kw, "max_moves": 1})
            slot_s.append(_sync_s(t0))
            if not traj.valid.all():
                raise AssertionError("a game ended in the opening")
            states = traj.final_state
            actions.append(traj.actions[0])
    finally:
        selfplay.search_lib.run_search = real
    launches = cuda_backup.ROUND_LAUNCHES
    results["round_backup_puct"]["launches_by_path"]["default_selfplay"] = \
        launches
    if launches != 400 * slots:
        raise AssertionError(f"round kernel launched {launches} times for "
                             f"{slots} searches of 400 rounds")
    if not all(bool((v == 400).all()) for v in searches):
        raise AssertionError("a live root's fresh visits do not sum to 400")
    s = env.initial_state((games,))
    for act in actions:
        s, ok = env.step(s, act.cpu(), compat=cfg.env_compat)
        if not bool(ok.all()):
            raise AssertionError("an illegal move was played")
    for x, y in zip(s, states):
        if not torch.equal(x, y.cpu()):
            raise AssertionError("replayed states differ")
    if not (torch.isfinite(traj.policy).all() and torch.isfinite(
            traj.planes).all()):
        raise AssertionError("non-finite self-play output")

    # launches per round at 60 levels: 60 rounds of one stage, 60 levels
    roots = env.initial_state((games,), device="cuda")
    run = dict(num_simulations=60, c_puct=mc.c_puct,
               dirichlet_alpha=mc.dirichlet_alpha,
               dirichlet_epsilon=mc.dirichlet_epsilon, max_depth=64,
               num_stages=1, generator=gen)
    search.run_search(net, roots, **run)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        search.run_search(net, roots, **run)
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    per_slot = sum(slot_s[1:]) / (slots - 1)
    results["default_selfplay"] = dict(
        config="configs/default_config.json", games=games,
        cut="max_moves 60 -> 3 move slots (3 play_games calls of 1 slot)",
        slot_s=slot_s, s_per_move_slot=per_slot,
        moves_per_s=games / per_slot,
        round_backup_launches=launches, round_backup_per_slot=launches //
        slots, kernels_per_round_60_levels=kernels / 60,
        batch_60_slots_s_extrapolated=60 * per_slot)


def default_iteration_cli(results: dict) -> None:
    """``cli train`` for one iteration on ``configs/default_config.json``
    at its 5x128 net, then ``continue`` for a second: PUCT self-play with
    Dirichlet noise, relabel-free training, and the PUCT gate (per-round
    tournament of current, best and random). Cut for time: 32 games (the
    SGD steps follow: ceil(positions / 128)), mcts.num_simulations 400 ->
    8, tournament.num_simulations 400 -> 4, tournament.rounds 10 -> 1.
    Checks the metrics rows, the checkpoints and that rounds went through
    azr_round_backup."""
    import tempfile

    from alphazero_reversi_tpu_torch import checkpoint as ckpt
    from alphazero_reversi_tpu_torch import cli
    from alphazero_reversi_tpu_torch.config import Config
    from alphazero_reversi_tpu_torch.mcts import cuda_backup

    cfg = Config.load(str(ROOT / "configs" / "default_config.json"))
    cuts = {"self_play.num_games": 32, "self_play.num_parallel_games": 32,
            "mcts.num_simulations": 8, "tournament.num_simulations": 4,
            "tournament.rounds": 1}
    cfg.self_play.num_games = cfg.self_play.num_parallel_games = 32
    cfg.mcts.num_simulations = 8
    cfg.tournament.num_simulations, cfg.tournament.rounds = 4, 1
    with tempfile.TemporaryDirectory() as tmp:
        cfg.training.checkpoint_dir = str(Path(tmp) / "checkpoints")
        cfg.logging.log_dir = str(Path(tmp) / "logs")
        cfg.self_play.save_dir = str(Path(tmp) / "self_play_data")
        cfg.tournament.output_dir = str(Path(tmp) / "tournament")
        cfg.logging.use_tensorboard = False
        cfg_path = str(Path(tmp) / "config.json")
        cfg.save(cfg_path)
        seconds = {}
        torch.cuda.synchronize()
        cuda_backup.ROUND_LAUNCHES = 0
        for command, total in (("train", "1"), ("continue", "2")):
            t0 = time.perf_counter()
            if cli.main([command, "-c", cfg_path, "--iterations", total,
                         "--run-name", "default"]) != 0:
                raise AssertionError(f"cli {command} failed")
            seconds[command] = _sync_s(t0)
        launches = cuda_backup.ROUND_LAUNCHES
        rows = [json.loads(line) for line in
                (Path(tmp) / "logs" / "default" / "metrics.jsonl")
                .read_text().splitlines()]
        if [r["step"] for r in rows] != [0, 1]:
            raise AssertionError(f"steps {[r['step'] for r in rows]}")
        for r in rows:
            if not all(np.isfinite(v) for v in r.values()):
                raise AssertionError(f"a non-finite metric: {r}")
        tree = ckpt.restore_checkpoint(
            ckpt.latest_checkpoint(cfg.training.checkpoint_dir))
        if tree["iteration"] != 2:
            raise AssertionError(f"iteration {tree['iteration']}")
    # every search: 8 (self-play) or 4 (gate) rounds, one launch each
    if launches <= 0 or launches % 4:
        raise AssertionError(f"round kernel launched {launches} times")
    # not this row's shape: filed with the shapes they ran at
    results["round_backup_puct"]["launches_other_shapes"][
        "default_iteration_cli (self-play B=32 N=9 levels<=8; gate N=5 "
        "levels<=4)"] = launches
    results["default_iteration_cli"] = dict(
        config="configs/default_config.json", cuts=cuts, iterations=2,
        train_s=seconds["train"], continue_s=seconds["continue"],
        round_backup_launches=launches,
        rows=[{k: r[k] for k in ("selfplay/positions", "selfplay/seconds",
                                 "train/seconds", "train/loss",
                                 "eval/seconds", "eval/elo",
                                 "eval/promoted", "checkpoint/seconds")}
              for r in rows])


def puct_cuda_matches_cpu(results: dict) -> None:
    """A float32 PUCT search (1x16 net, 8 games, PUCT-16, leaf_batch 4,
    injected log-gamma draws, a warm root at discount 0.25) and a small
    PUCT merged gate (two 1x16 nets and random, 6 units of 3 games,
    PUCT-8, tree reuse at discount 0.5, injected sampling draws) on the
    card and on the CPU, TF32 off: visit counts and per-unit scores
    equal."""
    from alphazero_reversi_tpu_torch import arena
    from alphazero_reversi_tpu_torch.config import ModelConfig
    from alphazero_reversi_tpu_torch.env import bitboard as env
    from alphazero_reversi_tpu_torch.mcts import search
    from alphazero_reversi_tpu_torch.models import resnet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(6)
    mcfg = ModelConfig(num_res_blocks=1, num_filters=16,
                       compute_dtype="float32")
    net = resnet.build_network(mcfg)
    rng = np.random.default_rng(7)
    roots = env.initial_state((8,))
    legal = env.legal_action_mask(roots)
    wv = torch.where(legal, torch.from_numpy(rng.integers(0, 6, (8, 65))),
                     0).float()
    log_gamma = torch.from_numpy(rng.normal(0, 5, (8, 65)).astype(
        np.float32))
    kw = dict(num_simulations=16, c_puct=1.0, dirichlet_alpha=0.03,
              dirichlet_epsilon=0.25, max_depth=16, leaf_batch=4,
              warm_discount=0.25)
    cpu = search.run_search(net, roots, warm_root=(wv, 0.3 * wv),
                            log_gamma=log_gamma, device="cpu", **kw)
    gpu = search.run_search(
        copy.deepcopy(net).cuda(), env.EnvState(*(t.cuda() for t in roots)),
        warm_root=(wv.cuda(), 0.3 * wv.cuda()), log_gamma=log_gamma.cuda(),
        **kw)
    if not torch.equal(gpu.visit_counts.cpu(), cpu.visit_counts):
        raise AssertionError("card vs CPU PUCT visit counts differ")
    value_err = (gpu.root_value.cpu() - cpu.root_value).abs().max().item()

    nets = [net, resnet.build_network(mcfg), None]
    units = [(i, j, 3, c) for i, j in ((0, 1), (0, 2), (1, 2))
             for c in (env.BLACK, env.WHITE)]
    gkw = dict(num_simulations=8, temperature=0.5, algorithm="puct",
               c_puct=1.5, tree_reuse="root", tree_reuse_discount=0.5)
    pairs = (60 + 16 + 1) // 2
    noise = [torch.from_numpy(np.random.default_rng(30 + u).gumbel(
        size=(2 * pairs, 3, 65)).astype(np.float32)) for u in range(6)]
    cpu_scores = arena.play_units(nets, units, sample_noise=noise,
                                  device="cpu", **gkw)
    gpu_scores = arena.play_units(
        [n if n is None else copy.deepcopy(n).cuda() for n in nets], units,
        sample_noise=[x.cuda() for x in noise], **gkw)
    for u, (x, y) in enumerate(zip(gpu_scores, cpu_scores)):
        if not np.array_equal(x, y):
            raise AssertionError(f"card vs CPU PUCT gate: unit {u} scores "
                                 f"{x} != {y}")
    results["puct_cuda_vs_cpu"] = dict(
        search="8 games PUCT-16 leaf_batch 4 warm 0.25 injected noise",
        visits_equal=True, root_value_max_abs=value_err,
        gate="6 units x 3 games PUCT-8 reuse 0.5", scores_equal=True)


class _ScriptedStdin:
    """``cli play``'s standard input, written as the game goes: it reads
    the agent's moves from what the command printed, keeps its own board,
    answers with the first legal move, and sends 'q' once the agent has
    moved ``agent_moves`` times."""

    def __init__(self, out, agent_moves: int):
        from alphazero_reversi_tpu_torch.env.game import Board

        self.out, self.left = out, agent_moves
        self.board, self.read = Board(), 0
        self.lines = []

    def readline(self) -> str:
        from alphazero_reversi_tpu_torch import cli

        text = self.out.getvalue()
        for line in text[self.read:].splitlines():
            if line.startswith("agent plays "):
                r, c = cli._parse_move_token(line.split()[2])
                if not self.board.make_move(r, c):
                    raise AssertionError(f"agent move {line!r} is illegal")
                self.left -= 1
        self.read = len(text)
        if self.left <= 0 or self.board.game_over:
            token = "q"
        else:
            moves = self.board.get_valid_moves()
            r, c = moves[0]
            self.board.make_move(r, c)
            token = f"{chr(ord('a') + c)}{r + 1}"
        self.lines.append(token)
        return token + "\n"


def host_play(results: dict) -> None:
    """The host play commands on the card, at the default config: the
    seeded 5x128 net written as a reference-format .pth
    (``interop.export_torch_checkpoint``) and ``import-checkpoint``-ed;
    ``analyze -d`` at 400 simulations after d3 c5 (timed; 400
    azr_round_backup launches at B=1); ``analyze --solve 14`` on a position
    12 empties from the end (the exact path, its disc differential checked
    against the solver); ``play -d --sims 32`` driven through stdin for four
    agent moves; and a repeated ``MCTS.get_action_probs`` query that must
    hit the transposition table."""
    import contextlib
    import io
    import tempfile

    from alphazero_reversi_tpu_torch import checkpoint as ckpt
    from alphazero_reversi_tpu_torch import cli, interop
    from alphazero_reversi_tpu_torch.config import Config, MCTSConfig
    from alphazero_reversi_tpu_torch.env import endgame
    from alphazero_reversi_tpu_torch.env.game import Board
    from alphazero_reversi_tpu_torch.mcts import cuda_backup, search
    from alphazero_reversi_tpu_torch.mcts.transposition import \
        TranspositionTable
    from alphazero_reversi_tpu_torch.models import resnet

    cfg_path = str(ROOT / "configs" / "default_config.json")
    cfg = Config.load(cfg_path)
    torch.manual_seed(cfg.seed)
    net = resnet.build_network(cfg.model)
    counts = results["round_backup_analyze"]["launches_by_path"]
    # the other searches of this phase, filed with the shapes they ran at
    others = results["round_backup_analyze"]["launches_other_shapes"]

    def run(argv, stdin=None):
        out = io.StringIO()
        old = sys.stdin
        if stdin is not None:
            sys.stdin = stdin(out)
        try:
            with contextlib.redirect_stdout(out):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc = cli.main(argv)
                secs = _sync_s(t0)
        finally:
            sys.stdin, used = old, sys.stdin
        if rc != 0:
            raise AssertionError(f"cli {argv[0]} exited {rc}: "
                                 f"{out.getvalue()[-500:]}")
        return out.getvalue(), secs, used

    with tempfile.TemporaryDirectory() as tmp:
        pth, ckdir = str(Path(tmp) / "best_model.pth"), str(Path(tmp) / "ck")
        interop.export_torch_checkpoint(net.state_dict(), pth, cfg.model)
        out, import_s, _ = run(["import-checkpoint", pth, "-d", ckdir])
        if "5x128 net, board 8" not in out:
            raise AssertionError(f"import-checkpoint printed {out!r}")
        restored = ckpt.restore_best(ckdir)
        if not all(torch.equal(restored[k], v)
                   for k, v in net.state_dict().items()):
            raise AssertionError("imported weights differ from the net's")

        cuda_backup.ROUND_LAUNCHES = 0
        run(["analyze", "-c", cfg_path, "-d", ckdir, "--sims", "8", "d3"])
        others["analyze_warmup (B=1 N=9 levels<=8)"] = warm = \
            cuda_backup.ROUND_LAUNCHES
        cuda_backup.ROUND_LAUNCHES = 0
        out, analyze_s, _ = run(["analyze", "-c", cfg_path, "-d", ckdir,
                                 "d3", "c5"])
        launches = cuda_backup.ROUND_LAUNCHES
        counts["analyze"] = launches
        if launches != 400 or "[400 simulations]" not in out:
            raise AssertionError(f"analyze: {launches} launches, "
                                 f"{out[-300:]!r}")
        top = [line for line in out.splitlines() if "visits" in line]
        if not top or sum(int(x.split()[2]) for x in top) > 400:
            raise AssertionError(f"analyze top moves {top}")

        rng = np.random.default_rng(3)
        board, tokens = Board(), []
        while sum(board.get_score()) < 52 and not board.game_over:
            moves = board.get_valid_moves()
            r, c = moves[int(rng.integers(len(moves)))]
            board.make_move(r, c)
            tokens.append(f"{chr(ord('a') + c)}{r + 1}")
        exact = endgame.EndgameSolver().solve(
            board.black, board.white, board.current_player)
        out, solve_s, _ = run(["analyze", "-c", cfg_path, "-d", ckdir,
                               "--solve", "14", *tokens])
        if f"{exact.value:+d} discs under optimal play" not in out:
            raise AssertionError(f"analyze --solve printed {out[-300:]!r}")

        cuda_backup.ROUND_LAUNCHES = 0
        out, play_s, stdin = run(
            ["play", "-c", cfg_path, "-d", ckdir, "--sims", "32"],
            stdin=lambda o: _ScriptedStdin(o, 4))
        play_launches = cuda_backup.ROUND_LAUNCHES
        others["play (B=1 N=33 levels<=32)"] = play_launches
        if out.count("agent plays ") != 4 or "game aborted" not in out:
            raise AssertionError(f"play printed {out[-500:]!r}")

    tt = TranspositionTable()
    mcts = search.MCTS(net, MCTSConfig(num_simulations=64, max_depth=64),
                       transposition_table=tt)
    times = []
    cuda_backup.ROUND_LAUNCHES = 0
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, res = mcts.get_action_probs(Board().state, add_noise=False)
        times.append(_sync_s(t0))
    others["tt_query (B=1 N=65 levels<=60)"] = cuda_backup.ROUND_LAUNCHES
    if (tt.hits, tt.misses) != (1, 1) or res.tree is not None or \
            cuda_backup.ROUND_LAUNCHES != 64:
        raise AssertionError(f"TT hits {tt.hits}, misses {tt.misses}, "
                             f"launches {cuda_backup.ROUND_LAUNCHES}")
    results["host_play"] = dict(
        config="configs/default_config.json", net="5x128 bf16 seeded",
        import_s=import_s, analyze_400_sims_s=analyze_s,
        analyze_warmup_launches=warm, analyze_launches=launches,
        solve_empties=64 - sum(board.get_score()), solve_s=solve_s,
        solve_disc_diff=exact.value, solve_nodes=exact.nodes,
        play_sims=32, play_agent_moves=4, play_s=play_s,
        play_human_moves=stdin.lines, play_launches=play_launches,
        tt_first_s=times[0], tt_hit_s=times[1], tt_hits=tt.hits)


def _rates_ok(row: dict) -> None:
    """Every rate (``*_per_s``) and time (``time_per_*``, ``seconds``) of a
    bench row must be finite and positive."""
    for k, v in row.items():
        if (k.endswith("_per_s") or k.startswith("time_per_")
                or k == "seconds") and not (np.isfinite(v) and v > 0):
            raise AssertionError(f"bench row {k}={v}: {row}")


def bench(results: dict) -> None:
    """The port's benchmark module (``alphazero_reversi_tpu_torch.
    benchmarks``) on the card, each call with the round kernel's counter
    set to 0 before it and read after: ``bench_env`` at full size (B=8192,
    512 steps, best of 5; it raises if a final board has a square held by
    both colours); the tiny-net PUCT-32 and Gumbel-32 points at full size
    (B=1024, leaf_batch 8, 16 moves, best of 3); the PUCT-400 point at
    leaf_batch 16 cut to 1 move and 1 repeat; Gumbel-32 on the flagship
    net cut to 2 moves and 1 repeat; one roofline cell (the flagship net,
    PUCT-400 at leaf_batch 16, 1 repeat); ``bench_solver`` at 12 empties;
    ``solver-batch`` cut to 256 positions (it raises unless every position
    is solved, and its values must equal a one-by-one ``solve_wdl`` on a
    sample); ``profile_search`` cut to 8 simulations, whose trace must hold
    one backup kernel event a round. Every row's rates must be finite and
    positive; each search round must launch ``azr_round_backup`` once."""
    import tempfile

    from alphazero_reversi_tpu_torch import benchmarks as bm
    from alphazero_reversi_tpu_torch.env import endgame
    from alphazero_reversi_tpu_torch.mcts import cuda_backup

    points = {point: kw for _, point, _, _, kw in bm.HEADLINE}
    flagship_net = {"name": "flagship-5x128", "blocks": 5, "filters": 128}
    with tempfile.TemporaryDirectory() as tmp:
        calls = (  # name, cut, call, kernel row, rounds a search
            ("env", "none", lambda: bm.bench_env(**points["env"]), None, 0),
            ("mcts_peak", "none",
             lambda: bm.bench_mcts_sustained(**points["mcts_peak"]),
             "round_backup_lb8", 4),
            ("gumbel", "none",
             lambda: bm.bench_mcts_sustained(**points["gumbel"]),
             "round_backup_lb8", 4),
            ("mcts", "moves 4 -> 1, repeats 3 -> 1",
             lambda: bm.bench_mcts_sustained(**{
                 **points["mcts"], "leaf_batch": 16, "moves": 1,
                 "repeats": 1}), "round_backup_lb16", 25),
            ("gumbel_flagship", "moves 16 -> 2, repeats 3 -> 1",
             lambda: bm.bench_mcts_sustained(**{
                 **points["gumbel_flagship"], "moves": 2, "repeats": 1}),
             "round_backup", 32),
            ("roofline", "one cell (flagship net, 400 sims, leaf_batch 16), "
             "repeats 3 -> 1",
             lambda: bm.bench_roofline(1024, [400], [16], [flagship_net],
                                       repeats=1), "round_backup_lb16", 25),
            ("solver", "empties [8, 12, 14, 16] -> [12]",
             lambda: bm.bench_solver([12]), None, 0),
            ("solver_batch", "positions 2048 -> 256",
             lambda: bm.bench_solver_batch(256, 12), None, 0),
            ("profile", "simulations 400 -> 8",
             lambda: bm.profile_search(tmp, num_simulations=8),
             "other", 8))
        out = {}
        for name, cut, call, row_name, rounds in calls:
            torch.cuda.synchronize()
            cuda_backup.ROUND_LAUNCHES = 0
            t0 = time.perf_counter()
            rows = call()
            wall_s = _sync_s(t0)
            launches = cuda_backup.ROUND_LAUNCHES
            if (launches == 0) != (rounds == 0) or (
                    rounds and launches % rounds):
                raise AssertionError(f"bench {name}: {launches} round "
                                     f"kernel launches, {rounds} a search")
            if row_name == "other":  # a PUCT search at another shape
                results["round_backup_puct"]["launches_other_shapes"][
                    "bench profile (B=1024 N=9 levels<=8 L=1)"] = launches
            elif row_name is not None:
                results[row_name]["launches_by_path"][f"bench_{name}"] = \
                    launches
            for row in rows if isinstance(rows, list) else [rows]:
                _rates_ok(row)
            out[name] = dict(cut=cut, wall_s=wall_s,
                             round_backup_launches=launches, rows=rows)

        prof = out["profile"]["rows"]
        if prof["round_backup_kernels"] != 8:
            raise AssertionError(f"profile: {prof['round_backup_kernels']} "
                                 "backup kernel events for 8 rounds")
        with open(prof["trace"]) as f:
            named = sum(bm.ROUND_BACKUP_KERNEL in e.get("name", "")
                        for e in json.load(f)["traceEvents"])
        if named < 8:
            raise AssertionError(f"the trace file holds {named} backup "
                                 "kernel events")
        prof["trace_file_backup_events"] = named

    # solver-batch: a sample of its positions solved one by one
    black, white, mover = bm.endgame_positions(256, 12)
    values, solved, _ = endgame.EndgameSolver().solve_wdl_batch(
        black, white, mover)
    solver = endgame.EndgameSolver()
    for i in range(0, 256, 16):
        one = solver.solve_wdl(int(black[i]), int(white[i]), int(mover[i]))
        if not solved[i] or np.sign(one.value) != np.sign(values[i]):
            raise AssertionError(f"solver-batch position {i}: {values[i]} "
                                 f"vs solve_wdl {one.value}")
    out["solver_batch"]["one_by_one_sample_equal"] = 16
    results["bench"] = out


def _cut_flagship_config():
    """``configs/flagship_run.json`` cut for time (64 games of Gumbel-8
    self-play, SGD in one chunk of 16 steps at batch 256, a 1-round gate at
    Gumbel-2, no console log) and the cuts, by field."""
    from alphazero_reversi_tpu_torch.config import Config

    cfg = Config.load(str(ROOT / "configs" / "flagship_run.json"))
    cuts = {"self_play.num_games": 64, "mcts.num_simulations": 8,
            "training.batch_size": 256, "training.steps_per_dispatch": 16,
            "tournament.rounds": 1, "tournament.num_simulations": 2,
            "logging.verbose": False}
    cfg.self_play.num_games = cfg.self_play.num_parallel_games = 64
    cfg.mcts.num_simulations = 8
    cfg.training.batch_size, cfg.training.steps_per_dispatch = 256, 16
    cfg.tournament.rounds, cfg.tournament.num_simulations = 1, 2
    cfg.logging.verbose = False
    return cfg, cuts


def pipeline_leftovers(results: dict) -> None:
    """Three iterations through ``cli train`` of ``configs/flagship_run
    .json`` with ``background_checkpoint_fetch`` on (as the flagship ships
    it) and ``replay_checkpoint_interval`` 2, cut for time: 64 games of
    Gumbel-8 self-play, SGD in one chunk of 16 steps at batch 256 (64
    games give at most 3,840 positions), a 1-round gate at Gumbel-2, every
    checkpoint kept; the replay capacity (200,000 rows, the ~115 MB host
    copy) and the rest stay the flagship's. Each save is recorded (the
    state a host copy taken as ``save_checkpoint`` returns, before the loop
    goes on). Checks: save 1 is due and holds the live buffer; save 2 is
    not due and holds save 1's buffer; save 3, the run's last, holds the
    live buffer; each checkpoint's weights and AdamW state equal the state
    at its save, though SGD ran after it. Reports the seconds the loop
    waited in each save against the worker's host copy."""
    import re
    import tempfile

    from alphazero_reversi_tpu_torch import checkpoint as ckpt
    from alphazero_reversi_tpu_torch import cli
    from alphazero_reversi_tpu_torch import pipeline

    cfg, cuts = _cut_flagship_config()
    if not cfg.training.background_checkpoint_fetch:
        raise AssertionError("the flagship config no longer fetches "
                             "checkpoints in the background")
    cuts.update({"training.replay_checkpoint_interval": 2,
                 "logging.save_best_only": False})
    cfg.training.replay_checkpoint_interval = 2
    cfg.logging.save_best_only = False

    real = pipeline.AlphaZeroPipeline.save_checkpoint
    saves = []

    def recording(self, fresh_replay=False):
        t0 = time.perf_counter()
        path = real(self, fresh_replay=fresh_replay)
        blocking_s = time.perf_counter() - t0
        state, buf = self.learner.state, self.buffer
        saves.append(dict(
            path=path, blocking_s=blocking_s, fresh_replay=fresh_replay,
            net=ckpt.to_host(state.net.state_dict()),
            optimizer=ckpt.to_host(state.optimizer.state_dict()),
            replay=ckpt.to_host({"planes": buf.planes, "policy": buf.policy,
                                 "value": buf.value, "cursor": buf.cursor,
                                 "size": buf.size})))
        return path

    def equal(a, b) -> bool:
        return not _tree_diffs(a, b)

    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = str(Path(tmp) / "config.json")
        cfg.save(cfg_path)
        pipeline.AlphaZeroPipeline.save_checkpoint = recording
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if cli.main(["train", "-c", cfg_path, "--iterations", "3",
                         "--run-dir", tmp, "--run-name", "leftovers"]) != 0:
                raise AssertionError("cli train failed")
            wall_s = _sync_s(t0)
        finally:
            pipeline.AlphaZeroPipeline.save_checkpoint = real
        (run,) = Path(tmp).glob("run_*")
        log = (run / "logs" / "leftovers" / "training.log").read_text()
        rows = [json.loads(line) for line in
                (run / "logs" / "leftovers" / "metrics.jsonl").read_text()
                .splitlines()]
        if [x["fresh_replay"] for x in saves] != [False, False, True] \
                or [r["step"] for r in rows] != [0, 1, 2]:
            raise AssertionError(f"{len(saves)} saves, steps "
                                 f"{[r['step'] for r in rows]}")
        trees = [ckpt.restore_checkpoint(s["path"]) for s in saves]
    for i, (tree, rec) in enumerate(zip(trees, saves), 1):
        if tree["iteration"] != i:
            raise AssertionError(f"save {i} holds iteration "
                                 f"{tree['iteration']}")
        if not (equal(tree["learner"]["net"], rec["net"])
                and equal(tree["learner"]["optimizer"], rec["optimizer"])):
            raise AssertionError(f"save {i}: weights or AdamW state differ "
                                 "from the state at the save")
    if equal(saves[0]["net"], saves[1]["net"]):
        raise AssertionError("no SGD ran between saves 1 and 2")
    replay_want = (saves[0]["replay"], saves[0]["replay"],
                   saves[2]["replay"])
    for i, (tree, want) in enumerate(zip(trees, replay_want), 1):
        if not equal(tree["replay"], want):
            raise AssertionError(f"save {i}'s replay buffer is not the "
                                 "expected one")
    if equal(saves[1]["replay"], saves[0]["replay"]):
        raise AssertionError("the buffer did not change between saves")
    copies = [float(x) for x in re.findall(r"host copy ([0-9.]+) s", log)]
    fresh = re.findall(r"replay (fresh|reused)", log)
    if fresh != ["fresh", "reused", "fresh"]:
        raise AssertionError(f"replay copies {fresh}")
    results["pipeline_leftovers"] = dict(
        config="configs/flagship_run.json", cuts=cuts, iterations=3,
        wall_s=wall_s, saves_due=fresh,
        save_blocking_s=[x["blocking_s"] for x in saves],
        worker_host_copy_s=copies,
        checkpoint_metric_s=[r["checkpoint/seconds"] for r in rows],
        iteration_s=[sum(r[f"{k}/seconds"] for k in
                         ("selfplay", "train", "eval", "checkpoint"))
                     for r in rows],
        replay_rows=[x["replay"]["size"] for x in saves],
        states_equal_at_save=True)


def _tree_diffs(a, b, path="") -> dict:
    """Every leaf of two nested trees that differs: ``{path: max abs
    difference}`` for tensors of one shape and dtype, ``{path: None}``
    otherwise."""
    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            return {path: None}
        if torch.equal(a, b):
            return {}
        return {path: (a.double() - b.double()).abs().max().item()}
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return {path: None}
        return {k: v for key in a
                for k, v in _tree_diffs(a[key], b[key],
                                        f"{path}.{key}").items()}
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return {path: None}
        return {k: v for i, (x, y) in enumerate(zip(a, b))
                for k, v in _tree_diffs(x, y, f"{path}[{i}]").items()}
    return {} if a == b else {path: None}


MULTI_GPU_TOL = 1e-5  # a float leaf of phase 18's two runs that is not
# bit-exact must stay within this of the other run, and is named


FETCH_TIMEOUT_S = 180.0  # phase 18's training.fetch_timeout_s (as in
# refbench/flagship_r4_run): the trajectory gather, the relabel fetch and
# the checkpoint copy run under the watchdog, on its thread


def _rank_run(rank: int, world: int, port: int, out: str) -> None:
    """One rank of phase 18's two-rank run (``chip_smoke.py --rank r
    --world d --port p --out dir``): ``_cut_flagship_config`` with the
    fetch watchdog on, through ``AlphaZeroPipeline`` for one iteration,
    every output under ``<out>/rank<r>``; writes the weights' digest to
    ``<out>/rank<r>.json``."""
    import hashlib

    sys.path.insert(0, str(ROOT))
    from alphazero_reversi_tpu_torch.parallel import mesh
    from alphazero_reversi_tpu_torch.pipeline import AlphaZeroPipeline

    mesh.initialize_distributed(f"127.0.0.1:{port}", world, rank)
    try:
        cfg, _ = _cut_flagship_config()
        cfg.training.fetch_timeout_s = FETCH_TIMEOUT_S
        base = Path(out) / f"rank{rank}"
        cfg.training.checkpoint_dir = str(base / "checkpoints")
        cfg.logging.log_dir = str(base / "logs")
        cfg.self_play.save_dir = str(base / "self_play_data")
        cfg.tournament.output_dir = str(base / "tournament_results")
        pipe = AlphaZeroPipeline(cfg, run_name="ranks")
        pipe.train(1)
        digest = hashlib.sha256()
        for name, t in sorted(pipe.learner.state_dict().items()):
            digest.update(name.encode())
            digest.update(t.detach().cpu().contiguous().numpy().tobytes())
        metrics = [{k: v for k, v in m.items() if not k.endswith("seconds")}
                   for m in pipe.metrics_history]
        (Path(out) / f"rank{rank}.json").write_text(json.dumps(dict(
            params_sha256=digest.hexdigest(), metrics=metrics,
            units=pipe._last_eval_units)))
    finally:
        torch.distributed.destroy_process_group()


def two_ranks(world: int) -> dict:
    """``world`` NCCL ranks of ``_rank_run``, each a process of this script
    (``mesh.spawn_ranks``, a hard timeout of 300 s): equal weights and
    metrics on every rank, the gate units shared out, and only rank 0's
    directory holding files."""
    import tempfile

    sys.path.insert(0, str(ROOT))
    from alphazero_reversi_tpu_torch.parallel import mesh

    script = str(Path(__file__).resolve())
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mesh.spawn_ranks(
            lambda r, port: [sys.executable, script, "--rank", str(r),
                             "--world", str(world), "--port", str(port),
                             "--out", tmp],
            world, 300, what="two_ranks")
        wall_s = time.perf_counter() - t0
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(world)]
        wrote = {r: sorted(str(f.relative_to(Path(tmp) / f"rank{r}"))
                           for f in (Path(tmp) / f"rank{r}").rglob("*")
                           if f.is_file())
                 for r in range(world) if (Path(tmp) / f"rank{r}").exists()}
    if any(r["params_sha256"] != ranks[0]["params_sha256"] for r in ranks):
        raise AssertionError("the ranks' weights differ")
    if any(r["metrics"] != ranks[0]["metrics"] for r in ranks):
        raise AssertionError("the ranks' metrics differ")
    units = sorted(u for r in ranks for u in r["units"])
    if units != list(range(len(units))):
        raise AssertionError(f"gate units played {units}")
    if not wrote.get(0) or any(wrote.get(r) for r in range(1, world)):
        raise AssertionError(f"files written by rank: {wrote}")
    return dict(world=world, wall_s=wall_s,
                fetch_timeout_s=FETCH_TIMEOUT_S,
                params_sha256=ranks[0]["params_sha256"],
                units_by_rank=[r["units"] for r in ranks],
                rank0_files=len(wrote[0]))


def multi_gpu(results: dict) -> None:
    """Phase 18, the port's data-parallel path on the card:

    (a) one iteration of ``_cut_flagship_config`` with the fetch watchdog
    on (``FETCH_TIMEOUT_S``) through ``cli train`` three times, all with
    cuDNN deterministic: without a process group,
    as a process group of one rank over NCCL (``--coordinator
    127.0.0.1:<port> --num-processes 1 --process-id 0``), and without one
    again (the NCCL run's wall clock compares with this one: both run
    warm). The checkpoint (weights, AdamW, best, replay, generators), the
    saved trajectory and the metrics (all but the seconds) must equal the
    first run's bit for bit, or a float leaf be within ``MULTI_GPU_TOL``
    and named; the NCCL run must have issued the pipeline's collectives
    (counted by kind);

    (b) ``benchmarks.bench_scaling`` over the cards there are (one process,
    an NCCL rank, per card), cut to one timed call at 8 simulations;

    (c) with two cards or more, ``two_ranks(2)`` over NCCL; with one, the
    line says it was not run and why."""
    import glob
    import tempfile

    from alphazero_reversi_tpu_torch import benchmarks as bm
    from alphazero_reversi_tpu_torch import checkpoint as ckpt
    from alphazero_reversi_tpu_torch import cli
    from alphazero_reversi_tpu_torch.mcts import cuda_backup
    from alphazero_reversi_tpu_torch.parallel import mesh
    from alphazero_reversi_tpu_torch.parallel import multihost as mh

    cfg, cuts = _cut_flagship_config()
    cfg.training.fetch_timeout_s = FETCH_TIMEOUT_S
    cuts = {**cuts, "training.fetch_timeout_s": FETCH_TIMEOUT_S}
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    runs, launches = {}, 0
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg_path = str(Path(tmp) / "config.json")
            cfg.save(cfg_path)
            for name in ("plain", "nccl_world1", "plain_again"):
                extra = []
                if name == "nccl_world1":
                    extra = ["--coordinator",
                             f"127.0.0.1:{mesh.free_port()}",
                             "--num-processes", "1", "--process-id", "0"]
                out = Path(tmp) / name
                mh.COLLECTIVES.clear()
                cuda_backup.ROUND_LAUNCHES = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if cli.main(["train", "-c", cfg_path, "--iterations", "1",
                             "--run-dir", str(out), "--run-name", "mg"]
                            + extra) != 0:
                    raise AssertionError(f"cli train ({name}) failed")
                wall_s = _sync_s(t0)
                launches += cuda_backup.ROUND_LAUNCHES
                if mesh.is_initialized():
                    raise AssertionError("cli train left its process group")
                (run,) = out.glob("run_*")
                rows = [json.loads(line) for line in
                        (run / "logs" / "mg" / "metrics.jsonl").read_text()
                        .splitlines()]
                (traj,) = glob.glob(str(run / "self_play_data" / "*.npz"))
                with np.load(traj) as f:
                    traj = {k: torch.from_numpy(f[k]) for k in f.files}
                runs[name] = dict(
                    wall_s=wall_s, collectives=dict(mh.COLLECTIVES),
                    tree=ckpt.restore_checkpoint(
                        str(run / "checkpoints" / "it_000001")),
                    traj=traj,
                    metrics=[{k: v for k, v in r.items()
                              if not k.endswith("seconds")} for r in rows],
                    seconds=[{k: v for k, v in r.items()
                              if k.endswith("seconds")} for r in rows])
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    plain, group, again = (runs[k] for k in ("plain", "nccl_world1",
                                             "plain_again"))
    if plain["collectives"] or again["collectives"]:
        raise AssertionError("a run without a process group issued "
                             "collectives")
    for kind in ("all_gather", "all_reduce", "broadcast", "barrier"):
        if not group["collectives"].get(kind):
            raise AssertionError(f"the NCCL run issued no {kind}: "
                                 f"{group['collectives']}")

    def differences(other):
        return {**_tree_diffs(plain["tree"], other["tree"], "checkpoint"),
                **_tree_diffs(plain["traj"], other["traj"], "trajectory"),
                **_tree_diffs(plain["metrics"], other["metrics"],
                              "metrics")}

    diffs, repeat_diffs = differences(group), differences(again)
    bad = {k: v for k, v in {**diffs, **repeat_diffs}.items()
           if v is None or v > MULTI_GPU_TOL}
    if bad:
        raise AssertionError(f"a run differs from the first plain run: "
                             f"{bad}")
    results["round_backup"].setdefault("launches_other_shapes", {})[
        "multi_gpu (cut flagship, 3 runs: self-play B=64 N=9, gate N=3)"] \
        = launches

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scaling = bm.bench_scaling(sp_sims=8, repeats=1)
    scaling_s = _sync_s(t0)
    for key, rate in (("env", "env_steps_per_s"),
                      ("selfplay", "moves_per_s")):
        if not scaling[key] or not all(
                np.isfinite(r[rate]) and r[rate] > 0 for r in scaling[key]):
            raise AssertionError(f"scaling {key} rows: {scaling[key]}")
    if torch.cuda.device_count() >= 2:
        ranks = two_ranks(2)
    else:
        ranks = {"run": False, "why": "one CUDA device: NCCL refuses two "
                 "ranks on one device, so the two-rank run needs two cards"}
    results["multi_gpu"] = dict(
        config="configs/flagship_run.json", cuts=cuts, iterations=1,
        world1=dict(bit_exact=not diffs, within_tol=diffs,
                    plain_repeat_bit_exact=not repeat_diffs,
                    tolerance=MULTI_GPU_TOL,
                    compared=["checkpoint", "trajectory", "metrics"],
                    collectives=group["collectives"],
                    wall_s={k: r["wall_s"] for k, r in runs.items()},
                    seconds={k: r["seconds"] for k, r in runs.items()},
                    round_backup_launches=launches),
        scaling=dict(cut="sp_sims 8, repeats 1 (else the defaults)",
                     wall_s=scaling_s, **scaling),
        two_ranks=ranks)


# phase 19's two tournament modes: the config each is cut from, and the
# cuts (each in the phase's JSON line)
TOURNAMENT_MODES = {
    "merged_gumbel": ("configs/flagship_run.json",
                      {"tournament.rounds": 1,
                       "tournament.num_simulations": 8}),
    "per_round_puct": ("configs/default_config.json",
                       {"tournament.rounds": 1,
                        "tournament.num_simulations": 4}),
}
TOURNAMENT_PLAYERS = ("it_000001", "best_model", "random")


def _tournament_models(root: Path) -> str:
    """Two flagship-width nets (the 5x128 bf16 ResNet, random weights from
    seeds 1 and 2) written as ``it_000001`` and ``best_model`` by the
    port's checkpoint module."""
    from alphazero_reversi_tpu_torch import checkpoint as ckpt
    from alphazero_reversi_tpu_torch.config import Config
    from alphazero_reversi_tpu_torch.models import resnet

    model = Config.load(str(ROOT / "configs" / "flagship_run.json")).model
    nets = []
    for seed in (1, 2):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            nets.append(resnet.build_network(model).state_dict())
    ckpt.save_checkpoint(str(root), 1, {"learner": {"net": nets[0]},
                                        "iteration": 1})
    ckpt.save_best(str(root), nets[1])
    ckpt.wait_for_saves()
    return str(root)


def _tournament_config(mode: str, output_dir: Path, path: Path,
                       rounds: Optional[int] = None,
                       sims: Optional[int] = None) -> str:
    """``TOURNAMENT_MODES[mode]``'s config, cut, its ELO file under
    ``output_dir`` (``rounds`` and ``sims`` override the cut's), saved at
    ``path``."""
    from alphazero_reversi_tpu_torch.config import Config

    source, cuts = TOURNAMENT_MODES[mode]
    cfg = Config.load(str(ROOT / source))
    cfg.tournament.rounds = rounds or cuts["tournament.rounds"]
    cfg.tournament.num_simulations = (sims or
                                      cuts["tournament.num_simulations"])
    cfg.tournament.output_dir = str(output_dir)
    cfg.save(str(path))
    return str(path)


def _elo_result(output_dir: Path) -> dict:
    """An ELO file's ratings, games played and history, the history's
    wall-clock timestamps left out."""
    data = json.loads((output_dir / "elo_ratings.json").read_text())
    return dict(ratings=data["ratings"], games_played=data["games_played"],
                history=[{k: v for k, v in h.items() if k != "timestamp"}
                         for h in data["history"]])


@contextlib.contextmanager
def _round_launches_by_shape():
    """Tally ``azr_round_backup`` launches by ``B`` and ``N`` (the
    wrapper's own count, read around each call) while the block runs."""
    from alphazero_reversi_tpu_torch.mcts import cuda_backup

    real = cuda_backup.round_backup
    tally: dict = {}

    def counting(stats, *args, **kwargs):
        before = cuda_backup.ROUND_LAUNCHES
        real(stats, *args, **kwargs)
        key = (f"B={stats.shape[0]} "
               f"N={stats.shape[1] // cuda_backup.STRIDE}")
        tally[key] = tally.get(key, 0) + cuda_backup.ROUND_LAUNCHES - before

    cuda_backup.round_backup = counting
    try:
        yield tally
    finally:
        cuda_backup.round_backup = real


def tournament(results: dict) -> None:
    """Phase 19, ``cli tournament`` on the card over two flagship-width
    checkpoints and the random baseline, in two pairing modes: the
    flagship's merged Gumbel tournament and the default config's
    per-round PUCT one, each cut (``TOURNAMENT_MODES``). Each mode runs
    plainly, then as a process group of one rank over NCCL
    (``--coordinator 127.0.0.1:<port> --num-processes 1 --process-id 0``):
    the ELO files must hold equal ratings, games played and history (the
    history's timestamps aside), every game a score in {0, 0.5, 1}, the
    NCCL run must have issued its collectives and left no process group,
    and every search round must have launched ``azr_round_backup`` (one a
    simulation at leaf_batch 1), counted by shape."""
    import tempfile

    from alphazero_reversi_tpu_torch import cli
    from alphazero_reversi_tpu_torch.mcts import cuda_backup
    from alphazero_reversi_tpu_torch.parallel import mesh
    from alphazero_reversi_tpu_torch.parallel import multihost as mh

    others = results["round_backup"].setdefault("launches_other_shapes", {})
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        models = _tournament_models(Path(tmp) / "models")
        for mode, (source, cuts) in TOURNAMENT_MODES.items():
            runs = {}
            for run in ("plain", "nccl_world1"):
                out = Path(tmp) / mode / run
                argv = ["tournament", "-c", _tournament_config(
                    mode, out, Path(tmp) / f"{mode}_{run}.json"),
                        "--model-dir", models]
                if run == "nccl_world1":
                    argv += ["--coordinator",
                             f"127.0.0.1:{mesh.free_port()}",
                             "--num-processes", "1", "--process-id", "0"]
                mh.COLLECTIVES.clear()
                cuda_backup.ROUND_LAUNCHES = 0
                with _round_launches_by_shape() as shapes:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if cli.main(argv) != 0:
                        raise AssertionError(f"cli tournament ({mode}, "
                                             f"{run}) failed")
                    wall_s = _sync_s(t0)
                if mesh.is_initialized():
                    raise AssertionError("cli tournament left its process "
                                         "group")
                runs[run] = dict(wall_s=wall_s, elo=_elo_result(out),
                                 launches=cuda_backup.ROUND_LAUNCHES,
                                 by_shape=shapes,
                                 collectives=dict(mh.COLLECTIVES))
            plain, group = runs["plain"], runs["nccl_world1"]
            if plain["elo"] != group["elo"]:
                raise AssertionError(f"{mode}: the NCCL run's ELO file "
                                     f"differs: {plain['elo']['ratings']} "
                                     f"vs {group['elo']['ratings']}")
            history = plain["elo"]["history"]
            rounds = cuts["tournament.rounds"]
            games = 3 * rounds * 2  # 3 pairings, 2 games a pair a round
            if len(history) != games or not {
                    h["score_a"] for h in history} <= {0.0, 0.5, 1.0}:
                raise AssertionError(f"{mode}: {len(history)} games of "
                                     f"{games}, or a score out of range")
            if sorted(plain["elo"]["ratings"]) != sorted(TOURNAMENT_PLAYERS):
                raise AssertionError(f"{mode}: players "
                                     f"{sorted(plain['elo']['ratings'])}")
            sims = cuts["tournament.num_simulations"]
            launches = [r["launches"] for r in runs.values()]
            if (launches[0] <= 0 or launches[0] != launches[1]
                    or launches[0] % sims
                    or sum(plain["by_shape"].values()) != launches[0]):
                raise AssertionError(f"{mode}: round kernel launches "
                                     f"{launches}, by shape "
                                     f"{plain['by_shape']}")
            if plain["collectives"] or not all(
                    group["collectives"].get(k) for k in
                    ("all_gather", "all_reduce", "broadcast", "barrier")):
                raise AssertionError(f"{mode}: collectives "
                                     f"{plain['collectives']} / "
                                     f"{group['collectives']}")
            for shape, n in plain["by_shape"].items():
                others[f"tournament {mode} (2 runs, {shape})"] = 2 * n
            report[mode] = dict(
                config=source, cuts=cuts, games=games,
                wall_s={k: r["wall_s"] for k, r in runs.items()},
                round_backup_launches=launches,
                launches_by_shape=plain["by_shape"],
                collectives=group["collectives"],
                ratings=plain["elo"]["ratings"],
                games_played=plain["elo"]["games_played"])
    results["tournament"] = dict(
        modes=report, players=list(TOURNAMENT_PLAYERS),
        model="configs/flagship_run.json 5x128 bf16, random weights "
              "(seeds 1, 2)",
        compared=["ratings", "games_played", "history"], equal=True)


# one process of ``tournament_ranks``: ``cli tournament`` (argv[2:]) with
# the process group's timeout cut to argv[1] s when that is above 0; prints
# the seconds its matches took (``play_s``) and its whole ``run_tournament``
# (``tournament_s``: play, the wait at the score gather and the ELO replay)
# on a line starting ``RANK_TIMES``
RANK_LAUNCHER = """
import datetime, json, sys, time
from alphazero_reversi_tpu_torch import arena, cli
from alphazero_reversi_tpu_torch.parallel import mesh
if float(sys.argv[1]) > 0:
    mesh.TIMEOUT = datetime.timedelta(seconds=float(sys.argv[1]))
times = dict(play_s=0.0, tournament_s=0.0)
def timed(fn, key):
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            times[key] += time.perf_counter() - t0
    return run
A = arena.Arena
A.play_games = timed(A.play_games, "play_s")
A.play_units_merged = timed(A.play_units_merged, "play_s")
A.run_tournament = timed(A.run_tournament, "tournament_s")
code = cli.main(sys.argv[2:])
print("RANK_TIMES", json.dumps(times), flush=True)
sys.exit(code)
"""


def _rank_times(out: str) -> dict:
    line = [l for l in out.splitlines() if l.startswith("RANK_TIMES ")][-1]
    return json.loads(line.split(" ", 1)[1])


def tournament_ranks(*worlds: int, rounds=2,
                     sims: Optional[dict] = None,
                     group_timeout_s: float = 0.0) -> dict:
    """``cli tournament`` over ``world`` NCCL ranks for each of ``worlds``
    (a process each, rank ``r`` on ``cuda:r``; ``mesh.spawn_ranks``, a
    hard timeout of 1200 s) against one card (the same command in one
    process, started the same way), in both of phase 19's modes at
    ``rounds`` rounds (an int, or a dict by mode; ``sims[mode]`` overrides
    a mode's simulations).
    ``group_timeout_s`` above 0 cuts every run's process-group timeout to
    it (``RANK_LAUNCHER``), so a rank that waits longer for another's share
    shows that the score gather does not depend on it. Each rank has its
    own output directory, so a write by a rank other than 0 shows. Reports
    both ELO tables, whether they are equal, the games whose score or
    players differ, each rank's files, which ranks printed the
    leaderboard, the wall seconds of each start (start-up included) and
    each rank's play and tournament seconds, or the error of a failed
    world. Checks nothing: a merged
    unit's searches concatenate other units on each rank than on one card,
    so a bf16 forward at another batch shape may differ in its last bit
    and change a move."""
    import os
    import tempfile

    sys.path.insert(0, str(ROOT))
    from alphazero_reversi_tpu_torch.kernels import build as kbuild
    from alphazero_reversi_tpu_torch.parallel import mesh

    kbuild.build(["backup_link"])  # once, before the ranks load it
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    command = [sys.executable, "-c", RANK_LAUNCHER, str(group_timeout_s),
               "tournament"]
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        models = _tournament_models(Path(tmp) / "models")
        for mode in TOURNAMENT_MODES:
            base = Path(tmp) / mode
            n_sims = (sims or {}).get(mode)
            n_rounds = rounds[mode] if isinstance(rounds, dict) else rounds

            def cfg(name: str) -> str:
                return _tournament_config(mode, base / name,
                                          base.with_suffix(f".{name}.json"),
                                          n_rounds, n_sims)

            one_cfg = cfg("one")
            t0 = time.perf_counter()
            (one_out,) = mesh.spawn_ranks(lambda r, port: command + [
                "-c", one_cfg, "--model-dir", models], 1, 1200, env=env,
                what=f"{mode} on one card")
            one_s = time.perf_counter() - t0
            one = _elo_result(base / "one")
            by_world = {}
            for world in worlds:
                names = [f"w{world}_rank{r}" for r in range(world)]
                cfgs = [cfg(name) for name in names]
                t0 = time.perf_counter()
                try:
                    outs = mesh.spawn_ranks(lambda r, port: command + [
                        "-c", cfgs[r], "--model-dir", models,
                        "--coordinator", f"127.0.0.1:{port}",
                        "--num-processes", str(world), "--process-id",
                        str(r)], world, 1200, env=env,
                        what=f"{mode} over {world} ranks")
                except RuntimeError as e:  # reported; the next world runs
                    by_world[world] = dict(error=str(e)[-3000:])
                    continue
                ranks_s = time.perf_counter() - t0
                many = _elo_result(base / names[0])
                differ = sum(
                    (a["player_a"], a["player_b"], a["score_a"])
                    != (b["player_a"], b["player_b"], b["score_a"])
                    for a, b in zip(one["history"], many["history"]))
                times = [_rank_times(o) for o in outs]
                waits = [t["tournament_s"] - t["play_s"] for t in times]
                by_world[world] = dict(
                    wall_s=ranks_s, rank_times=times,
                    play_s_max=max(t["play_s"] for t in times),
                    gather_wait_s_max=max(waits),
                    waited_past_group_timeout=(
                        group_timeout_s > 0 and max(waits) > group_timeout_s),
                    equal=one == many,
                    games_differ=differ + abs(len(one["history"])
                                              - len(many["history"])),
                    ratings=many["ratings"],
                    games_played=many["games_played"],
                    rank_files={r: sorted(
                        str(f.relative_to(base)) for f in
                        (base / names[r]).rglob("*") if f.is_file())
                        for r in range(world)
                        if (base / names[r]).exists()},
                    leaderboard_printed_by=[r for r, o in enumerate(outs)
                                            if "ratings saved" in o])
            report[mode] = dict(
                rounds=n_rounds, games=len(one["history"]),
                sims=n_sims or TOURNAMENT_MODES[mode][1][
                    "tournament.num_simulations"],
                group_timeout_s=group_timeout_s or None,
                one_card=dict(wall_s=one_s, **_rank_times(one_out),
                              ratings=one["ratings"],
                              games_played=one["games_played"]),
                ranks=by_world)
    return report


def main() -> int:
    if len(sys.argv) > 1:  # one rank of phase 18's two-rank run
        import argparse

        ap = argparse.ArgumentParser()
        for flag in ("--rank", "--world", "--port"):
            ap.add_argument(flag, type=int, required=True)
        ap.add_argument("--out", required=True)
        a = ap.parse_args()
        _rank_run(a.rank, a.world, a.port, a.out)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "alphazero_reversi_tpu_torch").is_dir():
        print("chip_smoke: alphazero_reversi_tpu_torch/ not found beside "
              "this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    # torch_round_inputs and torch_configs (both JAX-free)
    sys.path.insert(0, str(ROOT / "tests"))
    results: dict = {}
    carry: dict = {}  # flagship config, nets, trajectory, learner, buffer
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
                                       check_round_kernel(results),
                                       check_round_kernel_puct(results)))
    if not failed:
        phase("flagship_selfplay", lambda: flagship_selfplay(results, carry))
        if "traj" in carry:
            phase("flagship_training",
                  lambda: flagship_training(results, carry))
        if "learner" in carry:
            phase("flagship_gate", lambda: flagship_gate(results, carry))
            phase("checkpoint_roundtrip",
                  lambda: checkpoint_roundtrip(results, carry))
        phase("flagship_iteration_cli",
              lambda: flagship_iteration_cli(results))
        phase("cuda_vs_cpu", lambda: cuda_matches_cpu(results))
        if "traj" in carry:
            phase("learner_cuda_vs_cpu",
                  lambda: learner_cuda_matches_cpu(results, carry))
        phase("gate_cuda_vs_cpu", lambda: gate_cuda_matches_cpu(results))
        phase("pipeline_cli", lambda: pipeline_cli(results))
        phase("default_selfplay", lambda: default_selfplay(results))
        phase("default_iteration_cli",
              lambda: default_iteration_cli(results))
        phase("puct_cuda_vs_cpu", lambda: puct_cuda_matches_cpu(results))
        phase("host_play", lambda: host_play(results))
        phase("bench", lambda: bench(results))
        phase("pipeline_leftovers", lambda: pipeline_leftovers(results))
        phase("multi_gpu", lambda: multi_gpu(results))
        phase("tournament", lambda: tournament(results))

    kernels = [results[k] for k in ("backup_link", "round_backup",
                                    *(x[0] for x in PUCT_SHAPES))
               if k in results]
    for k in kernels:  # the main paths at the row's shape; launches at
        # other shapes stand apart in ``launches_other_shapes``
        k["launches"] = sum(k.get("launches_by_path", {}).values())
    if kernels:
        print(json.dumps({"kernels": kernels}))
    if "selfplay" in results:
        print(json.dumps({"selfplay": results["selfplay"]}))
    if "cuda_vs_cpu" in results:
        print(json.dumps({"cuda_vs_cpu": results["cuda_vs_cpu"]}))
    if "gate" in results:
        print(json.dumps({"gate": {
            **results["gate"],
            "gate_cuda_vs_cpu": results.get("gate_cuda_vs_cpu")}}))
    if "checkpoint" in results:
        print(json.dumps({"checkpoint": results["checkpoint"]}))
    if "pipeline_cli" in results:
        print(json.dumps({"pipeline_cli": results["pipeline_cli"]}))
    if "iteration_cli" in results:
        print(json.dumps({"iteration_cli": results["iteration_cli"]}))
    for name in ("default_selfplay", "default_iteration_cli",
                 "puct_cuda_vs_cpu", "host_play", "bench",
                 "pipeline_leftovers", "multi_gpu", "tournament"):
        if name in results:
            print(json.dumps({name: results[name]}))
    if "training" in results:
        tr = results["training"]
        parts = dict(selfplay_s=results["selfplay"]["seconds"],
                     relabel_s=tr["relabel"]["wall_s"], save_s=tr["save_s"],
                     replay_add_s=tr["replay_add_s"], sgd_s=tr["sgd_s"],
                     gate_s=results.get("gate", {}).get("seconds"),
                     checkpoint_s=results.get("checkpoint", {}).get(
                         "blocking_s"))
        whole = None if None in parts.values() else sum(parts.values())
        print(json.dumps({"training": {
            **tr, "iteration_parts": parts, "iteration_s": whole,
            "iteration_cli_s": results.get("iteration_cli", {}).get(
                "metrics_sum_s"),
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
