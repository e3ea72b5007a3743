"""One run of one cell of the benchmark of the PyTorch/CUDA port.

    python3 azbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. Sets up the cell (weights and inputs from
the seed, one warm-up at the cell's shapes), measures for ``--seconds``,
checks what the timed path produced against the plain reference in
``azbench/reference``, and prints one JSON line last on standard output:
the end-to-end metrics with ``--trace 0``, the per-layer metrics (read from
a profiled slice after the window) with ``--trace 1``. Exits non-zero and
prints no result without enough CUDA cards, or when JAX or the JAX package
was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.cell(args.workload)

    import torch
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {harness.power_limit()}", file=sys.stderr, flush=True)
    kind = harness.kind_module(cell["traffic_data"]["kind"])
    out = kind.run(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START)

    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    result = compose(cell, out, bool(args.trace), torch)
    checks = harness.judge(out["numbers"], cell["limits"])
    result["correct"] = harness.passes(checks)
    harness.emit(result, checks)
    return 0


def compose(cell: dict, out: dict, trace: bool, torch) -> dict:
    """The result line's keys from a kind's output."""
    name = cell["name"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    print(f"window {out['window_s']:.3f} s, {out['units']} {out['unit']}s, "
          f"set-up {out['setup_s']:.3f} s",
          file=sys.stderr, flush=True)
    metrics = {}
    units = {m["name"]: m["unit"] for m in
             harness.load_json(harness.ROOT / "BENCHMARK.json")["end_to_end"]}
    result = {"correct": False, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if not trace:
        for k, v in out["metrics"].items():
            metrics[k] = {"value": v, "unit": units[k]}
        metrics["setup_s"] = {"value": out["setup_s"], "unit": "s"}
        return result
    ctx = out["trace_ctx"]
    summary = ctx["summary"]
    for m in harness.per_layer_metrics(name):
        value = harness.read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device["busy_s"] = summary["busy_s"]
    device["window_s"] = summary["window_s"]
    result["breakdown"] = {"device_ops": summary["top_ops"],
                           "idle_gaps": summary["idle_gaps"]}
    return result


if __name__ == "__main__":
    sys.exit(main())
