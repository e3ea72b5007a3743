#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 1 if any failed):

1. build every CUDA kernel of the path from ``alphazero_reversi_tpu_torch/
   csrc`` (one ``nvcc`` per source, started together);
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the flagship self-play gives it, and time kernel, plain version,
   one library call, and the bound;
3. play one flagship self-play batch (``configs/flagship_run.json``: 1024
   games, Gumbel-32, 4 stages, tree reuse, 60 moves, the 5x128 bf16 ResNet
   with seeded random weights) and check that every simulation round went
   through the kernel;
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


def check_backup_kernel(results: dict) -> None:
    """Kernel vs plain version at the flagship's last stage (B=1024, N=33,
    P=24): L=1 must be bit-exact; L=4 (colliding cells, the plain version's
    CUDA scatter_add_ adds them in atomic order) within 1e-6 relative to
    max(|value|, 1), and bit-exact against the plain version on the CPU,
    which adds in the kernel's order."""
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
    max_err = max(max_err, diff4.max().item())
    if rel4 > 1e-6:
        raise AssertionError(f"backup kernel vs plain version at L=4: max "
                             f"relative diff {rel4} > 1e-6")
    if not torch.equal(got4.cpu(), cpu4):
        raise AssertionError("backup kernel != CPU plain version at L=4")

    # timing at the L=1 flagship shape (in place, repeated on one buffer)
    work = d1["stats"].clone()
    args = [d1[k] for k in ARGS]
    kernel_ms = _time_ms(lambda: cuda_backup.backup_and_link(work, *args),
                         200)
    plain_ms = _time_ms(
        lambda: cuda_backup.backup_and_link_reference(work, *args), 200)
    # library yardstick: one scatter_add_ over the same flat indices
    b, m = work.shape
    ok = d1["nodes"] >= 0
    base = d1["nodes"].clamp_min(0).long() * 130 + d1["actions"].long()
    idx = torch.cat([torch.where(ok, base, m), torch.where(ok, base + 65, m),
                     torch.where(d1["do_link"], d1["link_nodes"].long() * 130
                                 + d1["link_actions"].long(), m)], -1)
    upd = torch.cat([torch.full(d1["nodes"].shape, 1024.0, device=dev),
                     d1["incs"], d1["link_slots"].float()], -1)
    padded = torch.zeros(b, m + 1, device=dev)
    library_ms = _time_ms(lambda: padded.scatter_add_(1, idx, upd), 200)
    # bound: indices and increments read once, each touched cell read and
    # written once; 1 add per touched cell
    live = int(ok.sum()) * 2 + int(d1["do_link"].sum())
    index_bytes = sum(d1[k].numel() * d1[k].element_size() for k in ARGS)
    nbytes = index_bytes + live * 8
    bound_ms = max(nbytes / H100_BYTES_PER_S, live / H100_F32_FLOPS) * 1e3
    results["backup_link"] = dict(
        name="backup_link", route="cuda",
        source="alphazero_reversi_tpu_torch/csrc/backup_link.cu",
        replaces="alphazero_reversi_tpu/mcts/pallas_backup.py:44",
        shape="B=1024 N=33 P=24 L=1",
        exact_l1=True, max_rel_err_l4=rel4, max_abs_err=max_err,
        ms=kernel_ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=bound_ms, bound_by="bytes",
        bound_bytes=nbytes)


def flagship_selfplay(results: dict) -> None:
    """One flagship self-play batch through the port's public entry point."""
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
    cuda_backup.LAUNCHES = 0
    t0 = time.perf_counter()
    traj = selfplay.play_games(net, num_games=games, generator=gen, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = cuda_backup.LAUNCHES
    results["backup_link"]["launches"] = launches

    tensors = [*traj[:5], *traj.final_state, traj.actions]
    if any(t.device.type != "cuda" for t in tensors):
        raise AssertionError("self-play output left the card")
    live_slots = int(traj.valid.any(1).sum())
    rounds = cfg.mcts.num_simulations // cfg.mcts.batch_size
    if launches != rounds * live_slots:
        raise AssertionError(f"backup kernel launched {launches} times, "
                             f"expected {rounds} x {live_slots} live slots")
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
    results["selfplay"] = dict(
        config="configs/flagship_run.json", games=games,
        move_slots=int(traj.actions.shape[0]), live_slots=live_slots,
        positions=positions, seconds=seconds,
        moves_per_s=games * live_slots / seconds,
        positions_per_s=positions / seconds, backup_launches=launches)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "alphazero_reversi_tpu_torch").is_dir():
        print("chip_smoke: alphazero_reversi_tpu_torch/ not found beside "
              "this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    results: dict = {}
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
        kbuild.build(["backup_link"])
        results["build_s"] = time.perf_counter() - t0
        print(f"build_s {results['build_s']:.2f}", flush=True)

    phase("build", build)
    if not failed:
        phase("kernel_check", lambda: check_backup_kernel(results))
    if not failed:
        phase("flagship_selfplay", lambda: flagship_selfplay(results))
        phase("cuda_vs_cpu", lambda: cuda_matches_cpu(results))

    if "backup_link" in results:
        print(json.dumps({"kernels": [results["backup_link"]]}))
    if "selfplay" in results:
        print(json.dumps({"selfplay": results["selfplay"]}))
    if "cuda_vs_cpu" in results:
        print(json.dumps({"cuda_vs_cpu": results["cuda_vs_cpu"]}))
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
