"""Readings that set the limits of a cell's checks, on the chip.

    python3 azbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 6 [--out chiprun_out/<file>.jsonl]

For each seed, in one process: a run of the cell with a short window, its
compared numbers (the program's readings, the lower ends of the limits), and
on the first ``--control-seeds`` seeds the same numbers with the reference in a precision below the
configuration's standing in the program's place (the control), and for SGD
cells with the planted fault (half of each batch left out of the loss). One
JSON line per seed.
The benchmark's own runs never compute these.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--control-seeds", type=int, default=1000,
                    help="read the control on the first this many seeds")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    cell = harness.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print("not enough CUDA devices", file=sys.stderr)
        return 2
    kind = harness.kind_module(cell["traffic_data"]["kind"])
    sink = open(args.out, "a") if args.out else None
    t0 = T_START
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        out = kind.run(cell, seed, args.seconds, False,
                       torch.device("cuda", 0), t0,
                       control=i < args.control_seeds)
        line = json.dumps(dict(
            workload=args.workload, seed=seed, numbers=out["numbers"],
            control=out.get("control"), metrics=out["metrics"],
            setup_s=out["setup_s"], window_s=out["window_s"],
            card=torch.cuda.get_device_name(0)))
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
        t0 = time.perf_counter()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
