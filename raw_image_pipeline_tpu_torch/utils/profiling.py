"""Profiling helpers (the port of raw_image_pipeline_tpu/utils/profiling.py).

The reference ships no tracing (SURVEY.md §5). Here:

  * every ISP stage runs inside a record_function("isp_<stage>") range
    (pipeline.py), so a profiler's trace attributes host and device time
    per stage (tools/profile_chains.py reads them);
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
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from raw_image_pipeline_tpu_torch.ops.common import resolve_device

ORDER = [
    "debayer", "flip", "white_balance", "color_calibration",
    "gamma_correction", "vignetting_correction", "color_enhancer",
    "undistortion",
]


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
