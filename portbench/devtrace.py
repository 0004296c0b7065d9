"""Reduction of a ``torch.profiler`` trace (its Chrome trace export) to what
the per-layer metrics read: the device operations with their intervals, the
union of those intervals (busy and idle time), the idle gaps with the host
operation that ran meanwhile, and the device operations that took most time.

Busy time is the union of the intervals of every operation on the device,
over all streams, never a sum of their durations: kernels of two streams
(NCCL beside compute) that overlap count once.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

# categories of device operations in the Chrome trace: kernels, and the
# copies and fills the device runs between them
KERNEL_CATS = ("kernel",)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
# the host's calls that put work on the device, tied to it by correlation id
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass(frozen=True)
class Op:
    name: str
    cat: str
    start: float  # us
    end: float    # us


@dataclass
class Trace:
    device: List[Op]  # device operations, sorted by start
    host: List[Op]    # host operations, sorted by start

    @property
    def kernels(self) -> List[Op]:
        return [op for op in self.device if op.cat in KERNEL_CATS]


def load(path) -> Trace:
    with open(path) as f:
        data = json.load(f)
    return from_events(data.get("traceEvents", data)
                       if isinstance(data, dict) else data)


def from_events(events: Iterable[dict]) -> Trace:
    """The device operations that the traced steps launched, and the
    host's operations. A device operation whose launch the trace does not
    hold (the tail of the step before the traced ones, still running when
    tracing began) is left out."""
    device, host, launched = [], [], set()
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        op = Op(str(ev.get("name", "")), cat, float(ev["ts"]),
                float(ev["ts"]) + float(ev["dur"]))
        if cat in DEVICE_CATS:
            device.append((op, ev.get("args", {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            launched.add(ev.get("args", {}).get("correlation"))
        elif cat in HOST_CATS and not op.name.startswith("ProfilerStep#"):
            host.append(op)
    if launched:
        device = [op for op, corr in device if corr in launched]
    else:
        device = [op for op, _ in device]
    device.sort(key=lambda o: o.start)
    host.sort(key=lambda o: o.start)
    return Trace(device, host)


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float,
                                                                  float]]:
    """The disjoint, sorted union of ``(start, end)`` intervals."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def length(intervals: Iterable[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in intervals)


def intersect_length(a: List[Tuple[float, float]],
                     b: List[Tuple[float, float]]) -> float:
    """The length of the intersection of two disjoint, sorted unions."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def window(trace: Trace) -> Optional[Tuple[float, float]]:
    """The traced window on the device: from the start of its first
    operation to the end of its last; None if none ran."""
    if not trace.device:
        return None
    return trace.device[0].start, max(op.end for op in trace.device)


def busy_idle_us(trace: Trace) -> Tuple[float, float]:
    """(busy, window) in us: the union of all device operations, and the
    window's length."""
    win = window(trace)
    if win is None:
        return 0.0, 0.0
    return length(union((op.start, op.end) for op in trace.device)), \
        win[1] - win[0]


def host_op_at(trace: Trace, t: float) -> str:
    """The innermost host operation running at time ``t`` (us); where none
    runs, ``after <the last one to end before t>``."""
    best: Optional[Op] = None
    last: Optional[Op] = None
    for op in trace.host:
        if op.start > t:
            break
        if op.end >= t:
            if best is None or op.end - op.start < best.end - best.start:
                best = op
        elif last is None or op.end > last.end:
            last = op
    if best is not None:
        return best.name
    return "after " + last.name if last is not None else "none"


def idle_gaps(trace: Trace, top: int = 10) -> List[list]:
    """The ``top`` longest idle gaps inside the window, each as [the host
    operation running at its middle, seconds]."""
    busy = union((op.start, op.end) for op in trace.device)
    gaps = [(busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
            for i in range(len(busy) - 1)]
    gaps.sort(reverse=True)
    return [[host_op_at(trace, (s + e) / 2), g / 1e6]
            for g, s, e in gaps[:top]]


def top_ops(trace: Trace, top: int = 10) -> List[list]:
    """The ``top`` device operations by total time, as [name, seconds]."""
    by_name: Dict[str, float] = {}
    for op in trace.device:
        by_name[op.name] = by_name.get(op.name, 0.0) + op.end - op.start
    ranked = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
    return [[name[:160], us / 1e6] for name, us in ranked[:top]]


def matching(trace: Trace, patterns: Iterable[str]) -> List[Op]:
    """Kernels whose name contains any of ``patterns``."""
    patterns = tuple(patterns)
    return [op for op in trace.kernels
            if any(p in op.name for p in patterns)]
