"""The arithmetic of the per-layer metrics, from a run's trace context.

A context (``ctx``) holds the profiled slice's ``summary`` (``trace.py``),
its ``units`` (move slots or SGD steps), the untraced window's seconds per
unit (``unit_wall_s``) and whatever a kind adds for its own metrics. Each
reader returns a number, or None where the context has nothing to read.
"""
from __future__ import annotations

from typing import Optional

import yardstick


def idle_share(ctx: dict, kind: str) -> Optional[float]:
    """% of a unit's untraced wall time in which no device operation ran:
    busy seconds per unit in the slice against wall seconds per unit."""
    if ctx.get("kind") != kind or not ctx["units"]:
        return None
    busy = ctx["summary"]["busy_s"] / ctx["units"]
    return 100.0 * (1.0 - busy / ctx["unit_wall_s"])


def launches_per_unit(ctx: dict, kind: str) -> Optional[float]:
    if ctx.get("kind") != kind or not ctx["units"]:
        return None
    return ctx["summary"]["launches"] / ctx["units"]


def mfu(ctx: dict, kind: str, passes: float) -> Optional[float]:
    """% of the bf16 peak: ``passes`` x the forward FLOPs of every row the
    net took in the untraced window, over the window's seconds."""
    if ctx.get("kind") != kind or not ctx.get("rows_window"):
        return None
    flops = passes * ctx["rows_window"] * ctx["flops_per_row"]
    return 100.0 * flops / ctx["window_s"] / yardstick.PEAK_BF16_FLOPS


def span_roofline(ctx: dict, kind: str, span: str) -> Optional[float]:
    """% of the bf16 peak that the device time of the operations launched
    inside ``span`` reached on the forward FLOPs of the slice's rows."""
    if ctx.get("kind") != kind:
        return None
    device_s = ctx["summary"]["spans"].get(span, {}).get("device_s", 0.0)
    if not device_s or not ctx.get("rows_slice"):
        return None
    flops = ctx["rows_slice"] * ctx["flops_per_row"]
    return 100.0 * flops / device_s / yardstick.PEAK_BF16_FLOPS


def op_time(ctx: dict, fragment: str) -> float:
    return sum(v["seconds"] for k, v in ctx["summary"]["op_s"].items()
               if fragment in k)
