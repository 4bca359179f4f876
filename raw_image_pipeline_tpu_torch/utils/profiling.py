"""Profiling helpers (the port of raw_image_pipeline_tpu/utils/profiling.py).

The reference ships no tracing (SURVEY.md §5). Here:

  * every ISP stage runs inside a span("isp_<stage>"), a
    record_function range (pipeline.py), so a profiler's trace attributes
    host and device time per stage (tools/profile_chains.py reads them):
    each call of a built pipeline is the root span "isp_call", every pack
    of planes into a [B, H, W, 3] output the span "isp_pack";
  * while a torch.profiler session is active, each span also adds its
    host seconds to an in-memory table (span_table()), and each kernel
    launch its C entry's host seconds (kernels.Kernel.launch);
  * trace_profile() captures a torch.profiler trace around a callable and
    writes it as a chrome trace (Perfetto, chrome://tracing);
  * stage_timings() gives coarse per-stage wall times by running the chain
    truncated after each stage, where a profiler is not wanted. The card
    runs asynchronously, so every timed call ends in
    torch.cuda.synchronize() (the JAX version fetched a checksum instead).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

from raw_image_pipeline_tpu_torch.ops.common import resolve_device

ORDER = [
    "debayer", "flip", "white_balance", "color_calibration",
    "gamma_correction", "vignetting_correction", "color_enhancer",
    "undistortion",
]


CALL_SPAN = "isp_call"  # the root span: one call of a built pipeline


@dataclasses.dataclass
class SpanTotals:
    """One span name's row of the span table, over every recorded span of
    that name: how many, their host seconds, their self seconds (the
    seconds in which the span was its thread's innermost open span, so
    its duration less the time its child spans cover), and the host
    seconds and number of the kernel launches (the C entries' calls alone)
    made while it was innermost."""

    count: int = 0
    total_s: float = 0.0
    self_s: float = 0.0
    launch_s: float = 0.0
    launches: int = 0


class _Open(threading.local):
    """A thread's recorded spans still open, innermost last, and the host
    time of its last span entry or exit."""

    def __init__(self):
        self.spans: list = []
        self.mark = 0.0


OPEN = _Open()
_TABLE: Dict[str, SpanTotals] = {}
_TABLE_LOCK = threading.Lock()


class span:
    """`with span(name):` the record_function range `name` and, inside a
    recorded call, a row of the span table. A call is recorded where a
    torch.profiler session is active when its root span (CALL_SPAN) opens,
    so a call is recorded whole or not at all; outside a recorded call a
    span costs the range and one check. Spans nest per thread; the chain's
    generators may close them out of order (parallel/spatial.py runs
    several slabs' chains in turns), and a thread's time always goes to
    its innermost open span."""

    __slots__ = ("name", "_range", "_recorded", "_t0", "_self_s", "_launch_s", "_launches")

    def __init__(self, name: str):
        self.name = name
        self._range = record_function(name)

    def __enter__(self):
        self._range.__enter__()
        open_ = OPEN.spans
        self._recorded = bool(open_) or (self.name == CALL_SPAN
                                         and _autograd_profiler._is_profiler_enabled)
        if self._recorded:
            now = time.perf_counter()
            if open_:
                open_[-1]._self_s += now - OPEN.mark
            OPEN.mark = self._t0 = now
            self._self_s = self._launch_s = 0.0
            self._launches = 0
            open_.append(self)
        return self

    def __exit__(self, *exc):
        open_ = OPEN.spans
        if self._recorded and self in open_:
            now = time.perf_counter()
            open_[-1]._self_s += now - OPEN.mark
            OPEN.mark = now
            open_.remove(self)
            with _TABLE_LOCK:
                row = _TABLE.setdefault(self.name, SpanTotals())
                row.count += 1
                row.total_s += now - self._t0
                row.self_s += self._self_s
                row.launch_s += self._launch_s
                row.launches += self._launches
        return self._range.__exit__(*exc)


def launched(seconds: float) -> None:
    """Book one kernel launch of `seconds` host time to the thread's
    innermost open span (kernels.Kernel.launch, inside a recorded call)."""
    top = OPEN.spans[-1]
    top._launch_s += seconds
    top._launches += 1


def span_table() -> Dict[str, SpanTotals]:
    """A copy of the span table: span name -> its totals."""
    with _TABLE_LOCK:
        return {name: dataclasses.replace(row) for name, row in _TABLE.items()}


def reset_span_table() -> None:
    with _TABLE_LOCK:
        _TABLE.clear()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def trace_profile(fn: Callable, *args, log_dir: str = os.path.join("build", "trace")):
    """Run fn(*args) under torch.profiler (the host, and the card where
    there is one), write the trace to log_dir/trace.json and return fn's
    result."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        out = fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    return out


def _timed(call: Callable, device: torch.device, repeats: int) -> float:
    """Least wall seconds of `repeats` calls, each ended by a device
    synchronize, after one warm-up call."""
    call()
    _sync(device)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        call()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def stage_timings(
    config,
    encoding: str,
    pixels: np.ndarray,
    stages: Optional[List[str]] = None,
    repeats: int = 3,
    *,
    device="cuda",
) -> Dict[str, float]:
    """Cumulative-difference per-stage wall times (seconds) for the chain,
    including the fixed cost of a synchronized call as key "overhead".
    pixels: [B, H, W] or [B, H, W, C] numpy frames, copied to `device`
    once."""
    from raw_image_pipeline_tpu_torch.pipeline import build_pipeline

    dev = resolve_device(device)
    stages = stages or ORDER
    px = torch.as_tensor(np.ascontiguousarray(pixels), device=dev)

    # overhead baseline: an identity call
    overhead = _timed(lambda: {"y": px}, dev, repeats)

    results: Dict[str, float] = {"overhead": overhead}
    prev = overhead
    for upto, name in enumerate(ORDER):
        if name not in stages:
            continue
        # truncate: disable everything after `upto`
        cfg = config
        for later in ORDER[upto + 1:]:
            cfg = cfg.replace(**{later: dataclasses.replace(getattr(cfg, later), enabled=False)})
        pipe = build_pipeline(cfg, encoding, frame_hw=tuple(pixels.shape[1:3]), device=dev)
        t = _timed(lambda: pipe(px, None)[0]["processed"], dev, repeats)
        results[name] = max(t - prev, 0.0)
        prev = t
    return results
