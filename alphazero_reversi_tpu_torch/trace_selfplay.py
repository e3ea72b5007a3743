"""Where a flagship self-play move and a flagship SGD step spend their
time on the card.

    python -m alphazero_reversi_tpu_torch.trace_selfplay [--moves 2]
        [--sgd-steps 16]

Plays one warm-up move of the flagship self-play batch
(``configs/flagship_run.json``, 1024 games, random weights), times
``--moves`` moves without the profiler, then traces ``--moves`` more with
``torch.profiler`` (CPU and CUDA activities). Prints one JSON line: wall
seconds per move with and without the profiler, the device's busy time per
move (union of kernel intervals) and its idle share of the unprofiled wall
time, kernel launches per simulation round, the backup kernel's device time
per launch, and the kernels with the most device time. (A Chrome trace of
even two flagship moves exceeds 64 MiB, so none is written.)

Then it inserts the traced moves' positions into a flagship replay buffer
and does the same for the learner (``sgd``: batch 128, AdamW, random
weights): 8 warm-up steps, ``--sgd-steps`` timed steps, ``--sgd-steps``
traced steps; wall and device-busy milliseconds per step, the idle share,
kernel launches per step and the top kernels.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from . import learner as learner_lib
from . import replay, selfplay
from .config import Config
from .models import resnet

ROOT = Path(__file__).resolve().parent.parent


def _busy_us(events) -> float:
    """Length of the union of the device kernels' [start, end) intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _kernel_summary(prof, wall_s: float, plain_s: float, units: int):
    """Busy time (union of kernel intervals), idle share of the unprofiled
    wall time, kernels per unit and the 12 kernels with the most time."""
    # device events minus the GPU-side spans of ``record_function`` ranges
    # (``Optimizer.step`` opens one), which are not kernels
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_s = _busy_us(kernels) * 1e-6
    totals: dict = {}
    for e in kernels:
        n, t = totals.get(e.name, (0, 0.0))
        totals[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(totals.items(), key=lambda kv: -kv[1][1])[:12]
    return totals, dict(
        wall_s=plain_s, profiled_wall_s=wall_s, device_busy_s=busy_s,
        device_idle_share=1 - busy_s / plain_s,
        kernels_per_unit=len(kernels) / units,
        top_kernels_ms=[{"name": k[:80], "launches": n, "total_ms": t / 1e3}
                        for k, (n, t) in top])


def trace_sgd(cfg: Config, net, traj, steps: int) -> dict:
    """Learner steps on a buffer holding ``traj``'s positions."""
    buf = replay.add(replay.create(cfg.training.replay_capacity),
                     *selfplay.flatten_trajectory(traj))
    learner = learner_lib.Learner(net, cfg.training)
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    batch = cfg.training.batch_size
    learner.steps(buf, gen, 8, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learner.steps(buf, gen, steps, batch)
    torch.cuda.synchronize()
    plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        learner.steps(buf, gen, steps, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _, s = _kernel_summary(prof, wall, plain, steps)
    return {"steps": steps, "batch": batch, "buffer_rows": buf.size,
            "wall_ms_per_step": s["wall_s"] / steps * 1e3,
            "profiled_wall_ms_per_step": s["profiled_wall_s"] / steps * 1e3,
            "device_busy_ms_per_step": s["device_busy_s"] / steps * 1e3,
            "device_idle_share": s["device_idle_share"],
            "kernels_per_step": s["kernels_per_unit"],
            "top_kernels_ms": s["top_kernels_ms"]}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--moves", type=int, default=2)
    parser.add_argument("--sgd-steps", type=int, default=16)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_selfplay needs a CUDA device")

    cfg = Config.load(str(ROOT / "configs" / "flagship_run.json"))
    torch.manual_seed(cfg.seed)
    net = resnet.build_network(cfg.model).cuda()
    kw = selfplay.search_kwargs(cfg.mcts, cfg.self_play, cfg.env_compat)
    games = cfg.self_play.num_parallel_games
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    selfplay.play_games(net, num_games=games, generator=gen,
                        **{**kw, "max_moves": 1})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    selfplay.play_games(net, num_games=games, generator=gen,
                        **{**kw, "max_moves": args.moves})
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        traj = selfplay.play_games(net, num_games=games, generator=gen,
                                   **{**kw, "max_moves": args.moves})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    rounds = args.moves * cfg.mcts.num_simulations // cfg.mcts.batch_size
    totals, s = _kernel_summary(prof, wall, plain_wall, rounds)
    backup = [v for k, v in totals.items() if "backup_link_kernel" in k]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "games": games,
        "moves": args.moves, "wall_s_per_move": plain_wall / args.moves,
        "profiled_wall_s_per_move": wall / args.moves,
        "device_busy_s_per_move": s["device_busy_s"] / args.moves,
        "device_idle_share": s["device_idle_share"],
        "kernels_per_round": s["kernels_per_unit"],
        "backup_us_per_launch": (backup[0][1] / backup[0][0]
                                 if backup else None),
        "top_kernels_ms": s["top_kernels_ms"],
        "sgd": trace_sgd(cfg, net, traj, args.sgd_steps),
    }))


if __name__ == "__main__":
    main()
