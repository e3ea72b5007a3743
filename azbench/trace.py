"""A profiled slice of work and what the benchmark reads from its trace.

``profile(fn)`` runs ``fn`` under ``torch.profiler`` (host and device) and
returns its result with a summary of the trace:

* ``busy_s``: the union of every device operation's ``[start, end)``
  (kernels, copies, fills), the arithmetic of the program's
  ``trace_selfplay._busy_us``; ``window_s``: the slice's host seconds;
* ``launches``: host calls into the CUDA runtime or driver that put work
  on the device (kernel, copy, fill and graph launches);
* ``op_s``: device seconds and count per operation name;
* ``spans``: for each benchmark span name (``azbench.*``), the device
  seconds of the operations launched while it was open and the launches;
* ``top_ops`` and ``idle_gaps``: the ten device operations with the most
  time, and the ten longest device idle gaps, each named by the host
  operation that launched the work that ended it.
"""
from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Tuple

import torch

LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaMemcpyAsync",
    "cudaMemsetAsync", "cudaMemcpy", "cudaMemset", "cudaMemcpy2DAsync",
    "cudaGraphLaunch", "cuGraphLaunch"))
SPAN_PREFIX = "azbench."


def profile(fn: Callable, device) -> Tuple[object, dict]:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with _profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    return out, summarise(prof.profiler.kineto_results.events(), window)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def summarise(events, window_s: float) -> dict:
    cuda = torch.autograd.DeviceType.CUDA
    device_ops, host_ops, launches, spans = [], [], [], []
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device_ops.append((e.start_ns(), e.end_ns(), name,
                                   e.correlation_id()))
        elif name in LAUNCH_CALLS:
            launches.append((e.start_ns(), e.correlation_id()))
        elif name.startswith(SPAN_PREFIX):
            spans.append((e.start_ns(), e.end_ns(), name))
        else:
            host_ops.append((e.start_ns(), e.end_ns(), name))
    busy = _union([(s, e) for s, e, _, _ in device_ops])
    op_s: Dict[str, List[float]] = {}
    for s, e, name, _ in device_ops:
        acc = op_s.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += (e - s) * 1e-9

    launches.sort()
    launch_t = [t for t, _ in launches]
    dev_by_corr: Dict[int, List[Tuple[int, int]]] = {}
    for s, e, _, c in device_ops:
        dev_by_corr.setdefault(c, []).append((s, e))
    span_out: Dict[str, dict] = {}
    for s, e, name in spans:
        lo, hi = bisect.bisect_left(launch_t, s), bisect.bisect_right(
            launch_t, e)
        acc = span_out.setdefault(name, {"device_s": 0.0, "launches": 0,
                                         "count": 0})
        acc["count"] += 1
        acc["launches"] += hi - lo
        for _, corr in launches[lo:hi]:
            for ds, de in dev_by_corr.get(corr, ()):
                acc["device_s"] += (de - ds) * 1e-9

    return dict(
        busy_s=sum(e - s for s, e in busy) * 1e-9, window_s=window_s,
        launches=len(launches), device_ops=len(device_ops),
        op_s={k: {"count": v[0], "seconds": v[1]} for k, v in op_s.items()},
        spans=span_out,
        top_ops=[[k, v[1]] for k, v in sorted(
            op_s.items(), key=lambda kv: -kv[1][1])[:10]],
        idle_gaps=_gaps(busy, device_ops, launches, host_ops))


def _gaps(busy, device_ops, launches, host_ops) -> List[list]:
    """The ten longest idle gaps between device work, each named by the
    innermost host operation around the launch of the work that ended it
    (``launch`` when none encloses it)."""
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)[:10]
    start_corr = {}
    for s, _, _, c in device_ops:
        if s not in start_corr:
            start_corr[s] = c
    launch_at = {c: t for t, c in launches}
    out = []
    for gap, end in gaps:
        t = launch_at.get(start_corr.get(end))
        label = "launch"
        if t is not None:
            inner = [(e - s, name) for s, e, name in host_ops if s <= t <= e]
            if inner:
                label = min(inner)[1]
        out.append([label, gap * 1e-9])
    return out
