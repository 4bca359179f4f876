"""Reduction of a torch.profiler chrome trace to what the per-layer
metrics read: the device's busy time inside the traced window, the busy
time inside each of the program's `isp_*` ranges, and the breakdown (the
device operations that took most time, the longest idle gaps by what the
host was doing).

Busy time is the union of the intervals of kernels, copies and sets, so
no time counts twice. A range's busy time is that union clipped to the
range's spans on the device's timeline ("gpu_user_annotation"), over
every traced call. The window runs from the start of the harness's first
wait (WAIT_RANGE: by then the loop has its calls in flight, so the
submission of the first one, which the device waits for, is left out)
to the end of its last, on the same clock as the device's intervals.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
# the harness's record_function ranges around each call and each wait
SUBMIT_RANGE, WAIT_RANGE = "bench.submit", "bench.wait"
TOP = 10
NAME_CHARS = 120  # a device operation's name as the breakdown gives it


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def clip(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


@dataclass
class TraceSummary:
    """What a trace says about its window, in seconds."""

    window_s: float
    busy_s: float
    # isp_* range -> busy seconds inside its spans on the device
    stage_busy_s: Dict[str, float] = field(default_factory=dict)
    # kernel or copy name -> summed device seconds
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    # the longest idle gaps, named by the innermost host range around them
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def summarize(trace: dict) -> TraceSummary:
    work, ops, stages, host = [], [], {}, []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        if cat in DEVICE_WORK:
            work.append((s, e))
            ops.append((s, e, name))
        elif cat == "gpu_user_annotation" and name.startswith("isp_"):
            stages.setdefault(name, []).append((s, e))
        elif cat == "user_annotation":
            host.append((s, e, name))
    marks = [(s, e) for s, e, n in host if n == WAIT_RANGE]
    if not marks or not work:
        raise ValueError("trace: no wait ranges or no device work")
    lo, hi = min(s for s, _ in marks), max(e for _, e in marks)
    inside = clip(work, lo, hi)
    op_time: Dict[str, float] = {}
    for s, e, name in ops:
        if lo <= s < hi:
            key = name[:NAME_CHARS]
            op_time[key] = op_time.get(key, 0.0) + e - s
    stage_busy = {name: sum(union_us(clip(work, s, e)) for s, e in occ) * 1e-6
                  for name, occ in stages.items()}
    return TraceSummary(
        window_s=(hi - lo) * 1e-6, busy_s=union_us(inside) * 1e-6,
        stage_busy_s=stage_busy,
        device_ops=sorted(((n, t * 1e-6) for n, t in op_time.items()),
                          key=lambda kv: -kv[1])[:TOP],
        idle_gaps=_idle_gaps(inside, host, lo, hi))


def _idle_gaps(work, host, lo: float, hi: float) -> List[Tuple[str, float]]:
    """The TOP longest gaps between device work inside [lo, hi), each named
    by the innermost host range that holds its midpoint ("host" where none
    does)."""
    gaps, reach = [], lo
    for s, e in sorted(work):
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    if hi > reach:
        gaps.append((reach, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    named = []
    for s, e in gaps:
        mid = (s + e) / 2
        around = [(he - hs, n) for hs, he, n in host if hs <= mid < he]
        named.append((min(around)[1] if around else "host", (e - s) * 1e-6))
    return named
