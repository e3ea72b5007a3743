"""What every cell of the benchmark shares: the files it reads, the guards
it runs, the device it reports and the line it prints.

A cell is ``azbench/workloads/<name>.json``: its configuration
(``azbench/configs/<config>.json``), its traffic (``azbench/traffic/
<traffic>.json``, whose ``kind`` names the module ``azbench/kinds/
<kind>.py`` that drives it), its chips and the limits of its checks. A
per-layer metric is ``azbench/metrics/<name>.py`` with ``read(ctx)``,
which returns a number or None; the metrics a cell reports are those
``BENCHMARK.json`` lists for it.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "alphazero_reversi_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> dict:
    """The cell ``name`` with its configuration and traffic read in."""
    spec = load_json(HERE / "workloads" / f"{name}.json")
    spec["name"] = name
    spec["config_data"] = load_json(HERE / "configs"
                                    / f"{spec['config']}.json")
    spec["traffic_data"] = load_json(HERE / "traffic"
                                     / f"{spec['traffic']}.json")
    return spec


def kind_module(kind: str):
    return importlib.import_module(f"kinds.{kind}")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def per_layer_metrics(cell_name: str) -> List[dict]:
    """``BENCHMARK.json``'s per-layer metrics that list this cell."""
    manifest = load_json(ROOT / "BENCHMARK.json")
    return [m for m in manifest["per_layer"] if cell_name in m["workloads"]]


def read_metric(name: str, ctx: dict) -> Optional[float]:
    module = _load(HERE / "metrics" / f"{name}.py",
                   "azbench_metric_" + name.replace(".", "_").replace("-", "_"))
    return module.read(ctx)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """``{name: {"value", "limit"}}`` in the limits' order; a number absent
    or not finite fails."""
    return {k: {"value": numbers.get(k, float("inf")), "limit": limit}
            for k, limit in limits.items()}


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def emit(result: dict, checks: dict) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output, with the
    checks as its last key."""
    for k, c in checks.items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r}) {ok}",
              file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
