"""The device trace of a run: ``torch.profiler`` around the traced units,
reduced to device ops, busy time and idle gaps.

Busy time is the union of the device ops' intervals inside the traced
window (ops on two streams, such as NCCL's beside the compute stream, do
not count twice). An idle gap is named by what the host was doing at its
middle: the innermost host op whose interval holds it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

Op = Tuple[str, float, float, int]  # name, start s, end s, stream
WINDOW = "portbench.window"


def merged(intervals: Sequence[Tuple[float, float]], lo: float, hi: float
           ) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to [lo, hi], as sorted disjoint
    intervals."""
    out: List[List[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(device_ops: Sequence[Op], lo: float, hi: float) -> float:
    return sum(e - s for s, e in merged([(o[1], o[2]) for o in device_ops],
                                        lo, hi))


def gaps(device_ops: Sequence[Op], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The idle intervals of [lo, hi]."""
    out, t = [], lo
    for s, e in merged([(o[1], o[2]) for o in device_ops], lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def labels(host_ops: Sequence[Tuple[str, float, float]],
           times: Sequence[float]) -> List[str]:
    """For each time, the innermost host op running then (the shortest
    whose interval holds it)."""
    import numpy as np

    if not host_ops:
        return ["host, no op"] * len(times)
    start = np.array([o[1] for o in host_ops])
    end = np.array([o[2] for o in host_ops])
    span = end - start
    out = []
    for t in times:
        held = np.flatnonzero((start <= t) & (end >= t))
        out.append(host_ops[held[np.argmin(span[held])]][0] if held.size
                   else "host, no op")
    return out


def breakdown(device_ops: Sequence[Op],
              host_ops: Sequence[Tuple[str, float, float]],
              lo: float, hi: float, top: int = 10, named: int = 500) -> dict:
    """The device ops that took most time, summed by name, and the idle
    time summed by what the host was doing, ``top`` of each, in seconds.
    The ``named`` longest gaps are named; the rest count as "shorter
    gaps"."""
    by_op: Dict[str, float] = {}
    for name, s, e, _ in device_ops:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            by_op[name] = by_op.get(name, 0.0) + d
    idle = sorted(gaps(device_ops, lo, hi), key=lambda g: g[0] - g[1])
    by_gap: Dict[str, float] = {}
    for (s, e), key in zip(idle, labels(host_ops, [0.5 * (s + e) for s, e
                                                   in idle[:named]])):
        by_gap[key] = by_gap.get(key, 0.0) + (e - s)
    rest = sum(e - s for s, e in idle[named:])
    if rest > 0:
        by_gap["shorter gaps"] = rest

    def first(d):
        return [[k[:200], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": first(by_op), "idle_gaps": first(by_gap)}


def capture(run: Callable[[], None],
            start: Optional[Callable[[], object]] = None) -> dict:
    """Run ``run`` (which ends in a device synchronize) under the profiler,
    after ``start`` (outside the window); its device ops, host ops and
    window (seconds on the profiler's clock)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if start is not None:
            start()
        with record_function(WINDOW):
            run()
            torch.cuda.synchronize()
    # the raw events: the profiler's own per-event objects would take
    # minutes to build for the ~10^5 launches of a fit
    device, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        name = ev.name()
        if str(ev.device_type()).endswith("CUDA"):
            if name == WINDOW or ev.is_user_annotation():
                continue  # the span's own mark on the device's timeline
            device.append((name, s, e, int(ev.device_resource_id())))
        elif name == WINDOW:
            window = (s, e)
        else:
            host.append((name, s, e))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    return {"device_ops": device, "host_ops": host, "window": window}
