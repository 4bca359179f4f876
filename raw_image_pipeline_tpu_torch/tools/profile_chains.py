"""Where the device time of each chain goes, on a CUDA card.

    python -m raw_image_pipeline_tpu_torch.tools.profile_chains [--out DIR] [CHAIN ...]

Run from the root of a checkout: the chains are those of tools/workloads.py
that run at 1920x1080 (chip_smoke.py's phase 2; all of them when none is
named), each called at its per-call batch (and microbatch) on frames made
on the card. For each chain:
two warm-up calls, the wall of three unprofiled calls (the least), then one
call under torch.profiler. From that call's trace:

  * busy: the union of the device intervals of its kernels, copies and
    sets (a time never counted twice, so never above the wall);
  * idle share: 1 - busy / wall, of the profiled and the unprofiled wall;
  * per isp_* stage: the GPU span of its profiler range, the busy time
    inside that span and the kernels, copies and sets (memcpy, memset)
    that start in it; and on the host, the range's duration and the CUDA runtime and
    driver calls that start in it (count and time per API).

Prints one line per chain and, last, a JSON line of every number; writes
each call's trace and its kernel table under --out (default
build/profiles).

This module imports nothing of the package at module level:
compare_checkouts.py loads it beside another checkout's package and calls
profile_chain.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Iterable, List, Tuple

# the trace's categories of device work; "gpu_user_annotation" (the isp_*
# ranges on the device's timeline) is a span around work, not work
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_API = ("cuda_runtime", "cuda_driver")
H, W = 1080, 1920


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def _clip(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def device_time(trace: dict) -> dict:
    """From a torch.profiler chrome trace: busy us (the union of the device
    work), the sum of the work's durations, the number of kernels, the
    device window (first start to last end) and, per isp_* range, its GPU
    span, the busy time inside it and the kernels, copies and sets that
    start in it,
    its duration on the host and {API: [calls, us]} of the CUDA runtime and
    driver calls that start in it there (each summed over the range's
    occurrences)."""
    work, spans, moves = [], {}, {"kernel": [], "gpu_memcpy": [], "gpu_memset": []}
    host_spans, api = {}, []
    n_kernels = 0
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s, e = float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0))
        if cat in DEVICE_WORK:
            work.append((s, e))
            n_kernels += cat == "kernel"
            if cat in moves:
                moves[cat].append(s)
        elif cat == "gpu_user_annotation" and name.startswith("isp_"):
            spans.setdefault(name, []).append((s, e))
        elif cat == "user_annotation" and name.startswith("isp_"):
            host_spans.setdefault(name, []).append((s, e))
        elif cat in HOST_API:
            api.append((s, name, e - s))

    def starting_in(starts, occ):
        return sum(s <= t < e for s, e in occ for t in starts)

    def api_in(occ):
        calls = {}
        for t, name, dur in api:
            if any(s <= t < e for s, e in occ):
                n, us = calls.get(name, (0, 0.0))
                calls[name] = [n + 1, us + dur]
        return calls

    stages = {
        name: {"span_us": sum(e - s for s, e in occ),
               "busy_us": sum(union_us(_clip(work, s, e)) for s, e in occ),
               "kernels": starting_in(moves["kernel"], occ),
               "copies": starting_in(moves["gpu_memcpy"], occ),
               "sets": starting_in(moves["gpu_memset"], occ),
               "host_us": sum(e - s for s, e in host_spans.get(name, ())),
               "host_api": api_in(host_spans.get(name, ()))}
        for name, occ in spans.items()
    }
    return {
        "busy_us": union_us(work),
        "work_sum_us": sum(e - s for s, e in work),
        "kernels": n_kernels,
        "window_us": (max(e for _, e in work) - min(s for s, _ in work)) if work else 0.0,
        "stages": stages,
    }


def range_kernel_names(trace: dict, stage: str) -> list:
    """The names of the kernels that start in the isp_* range `stage` of a
    torch.profiler chrome trace (on the device's clock), one a launch."""
    spans = [(float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)))
             for ev in trace.get("traceEvents", [])
             if ev.get("ph") == "X" and ev.get("cat") == "gpu_user_annotation"
             and ev.get("name") == stage]
    return [ev.get("name", "") for ev in trace.get("traceEvents", [])
            if ev.get("ph") == "X" and ev.get("cat") == "kernel"
            and any(s <= float(ev["ts"]) < e for s, e in spans)]


def profile_chain(tp, torch, workloads, name: str, out_dir: str) -> dict:
    """One chain of the package `tp`, from the table of the module
    `workloads` (tools/workloads.py): its unprofiled and profiled wall and
    the trace's device time (device_time) of one call."""
    from torch.profiler import ProfilerActivity, profile

    ch = workloads.chains(tp)[name]
    batch = ch.frames // ch.calls
    pipe = tp.build_pipeline(ch.config(H, W), ch.encoding, frame_hw=(H, W), with_state=True,
                             temporal_mode="sequence", device="cuda", microbatch=ch.microbatch)
    frames = workloads.card_frames(torch, ch.kind, batch, H, W, workloads.SEED + len(name))

    def call():
        pipe(frames, tp.init_state((), device="cuda"))
        torch.cuda.synchronize()

    for _ in range(2):
        call()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        call()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        profiled = time.perf_counter() - t0
    path = os.path.join(out_dir, f"trace_{name}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        dev = device_time(json.load(f))
    with open(os.path.join(out_dir, f"kernels_{name}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    wall_us, prof_us = min(walls) * 1e6, profiled * 1e6
    return {"chain": name, "batch": batch, "microbatch": ch.microbatch,
            "wall_ms": wall_us / 1e3, "profiled_wall_ms": prof_us / 1e3,
            "busy_ms": dev["busy_us"] / 1e3, "work_sum_ms": dev["work_sum_us"] / 1e3,
            "kernels": dev["kernels"], "device_window_ms": dev["window_us"] / 1e3,
            "idle_share_profiled": 1.0 - dev["busy_us"] / prof_us,
            "idle_share_unprofiled": 1.0 - dev["busy_us"] / wall_us,
            "stages": {k: {"span_ms": v["span_us"] / 1e3, "busy_ms": v["busy_us"] / 1e3,
                           "kernels": v["kernels"], "copies": v["copies"], "sets": v["sets"],
                           "host_ms": v["host_us"] / 1e3,
                           "host_api_ms": {a: [n, us / 1e3] for a, (n, us) in
                                           v["host_api"].items()}}
                       for k, v in dev["stages"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("chains", nargs="*",
                    help="tools/workloads.py chains that run at 1920x1080 (default: all)")
    ap.add_argument("--out", default=os.path.join("build", "profiles"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profile_chains: no CUDA device", file=sys.stderr)
        return 1
    import raw_image_pipeline_tpu_torch as tp
    from raw_image_pipeline_tpu_torch.tools import workloads

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() or "nvidia-smi: no output")
    names = args.chains or [n for n, ch in workloads.chains(tp).items() if not ch.small_only]
    os.makedirs(args.out, exist_ok=True)
    rows = []
    for name in names:
        r = profile_chain(tp, torch, workloads, name, args.out)
        rows.append(r)
        stages = ", ".join(f"{k} {v['span_ms']:.3f}/{v['busy_ms']:.3f} ({v['kernels']} kernels, "
                           f"{v['copies']} copies, "
                           f"{v['sets']} sets, host {v['host_ms']:.3f})" for k, v in
                           sorted(r["stages"].items(), key=lambda kv: -kv[1]["span_ms"]))
        print(f"{name} B={r['batch']}: wall {r['wall_ms']:.3f} ms (profiled "
              f"{r['profiled_wall_ms']:.3f}), device busy {r['busy_ms']:.3f} ms in "
              f"{r['kernels']} kernels, idle {100 * r['idle_share_unprofiled']:.1f}% of the "
              f"wall ({100 * r['idle_share_profiled']:.1f}% profiled); stage span/busy ms: "
              f"{stages}", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "profiles": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
