"""The benchmark of raw_image_pipeline_tpu_torch on one CUDA card.

    python3 -m isp_bench.run --workload NAME --seed N --seconds S --trace 0|1

Runs one cell of BENCHMARK.json from the root of a checkout and prints,
as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` (and with --trace 1 the
`breakdown`), and last `checks`, each compared number beside its limit,
which also close standard error.

A run: the frames of the cell's traffic mix made on the card from the
seed (isp_bench/frames.py); the pipeline built as the ROS node's runner
builds it (`build_pipeline`, the Kalman state carried from batch to
batch, "sequence" mode); a warm-up at the cell's batch shape; then a
window of --seconds in which the loop keeps `in_flight` batches
submitted, waits on the oldest one's completion event and records its
latency, outputs staying on the card and let go once completed. --trace 1 then profiles a further
segment of `trace_frames` frames for the per-layer metrics. Every metric
is the reader metrics/<name>.py over the run's readings. Last, the
outputs of a batch drawn from the seed and of the last batch, and the
final state, are held to the plain reference (isp_bench/check.py).

Exits 2 without a result where no CUDA card (or fewer than the cell
asks for) is present: nothing falls back to the CPU.
"""

import time

_T0 = time.time()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from collections import deque  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import List, Optional  # noqa: E402

import torch  # noqa: E402
from torch.profiler import record_function  # noqa: E402

from isp_bench import check, frames, imports, spec  # noqa: E402
from isp_bench.trace import SUBMIT_RANGE, WAIT_RANGE, TraceSummary, summarize  # noqa: E402

ROOT = os.path.dirname(spec.HERE)
TRACE_DIR = os.path.join(ROOT, "build", "isp_bench")  # one trace file, read and removed


@dataclass
class Readings:
    """What a run measured; the metric readers' input."""

    config: dict
    traffic: dict
    setup_s: float
    seconds: float  # the window's length
    frames: int  # frames whose batch completed inside the window
    latencies_s: List[float]  # submit to completion seen, each batch completed inside
    enqueue_s: List[float]  # each call of the window, until it returned
    peak_bytes: int  # the allocator's peak over set-up and window, without the kept outputs
    trace: Optional[TraceSummary] = None
    traced_frames: int = 0


class PortProgram:
    """The system under test: raw_image_pipeline_tpu_torch's pipeline for
    one configuration file, as the ROS node's runner builds it."""

    def __init__(self, cfg: dict, device):
        from raw_image_pipeline_tpu_torch.models.ccc_model import load_ccc_model
        from raw_image_pipeline_tpu_torch.pipeline import build_pipeline, init_state

        self.device, self.with_state, self._init = device, cfg["with_state"], init_state
        self.pipe = build_pipeline(
            pipeline_config(cfg), cfg["encoding"], frame_hw=tuple(cfg["frame_hw"]),
            with_state=cfg["with_state"], keep_intermediates=cfg["keep_intermediates"],
            temporal_mode=cfg["temporal_mode"],
            ccc_model=load_ccc_model(check.ccc_model_path(cfg)), device=device)

    def init_state(self):
        return self._init((), device=self.device) if self.with_state else None

    def __call__(self, pixels, state):
        return self.pipe(pixels, state)


def pipeline_config(cfg: dict):
    """The port's PipelineConfig of a configuration file's "pipeline"
    (every field of every section, lists as tuples); the CCC model is the
    benchmark's copy, handed to build_pipeline."""
    from raw_image_pipeline_tpu_torch import config as C

    p = cfg["pipeline"]

    def section(cls, values):
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in values.items()})

    wb = dict(p["white_balance"], ccc_model_path=check.ccc_model_path(cfg))
    return C.PipelineConfig(
        debayer=section(C.DebayerConfig, p["debayer"]),
        flip=section(C.FlipConfig, p["flip"]),
        white_balance=section(C.WhiteBalanceConfig, wb),
        color_calibration=section(C.ColorCalibrationConfig, p["color_calibration"]),
        gamma_correction=section(C.GammaCorrectionConfig, p["gamma_correction"]),
        vignetting_correction=section(C.VignettingCorrectionConfig,
                                      p["vignetting_correction"]),
        color_enhancer=section(C.ColorEnhancerConfig, p["color_enhancer"]),
        undistortion=section(C.UndistortionConfig, p["undistortion"]),
        calibration=section(C.CameraCalibration, p["calibration"]))


class _NoEvent:
    """A CPU run's stand-in for a CUDA event: the work is done on return."""

    def synchronize(self):
        pass


@dataclass
class Stream:
    """The closed loop: batch k is pool[k % len(pool)], the state carried
    from call to call. A batch's outputs are let go once it has completed,
    as a consumer on the card lets go of what it has read, except those
    that the check compares: batch `sample_at`'s (drawn from the seed
    before the window) and the last batch's."""

    program: object
    pool: torch.Tensor
    state: object = None
    sample_at: int = -1
    k: int = 0
    inflight: deque = field(default_factory=deque)
    kept: Optional[tuple] = None
    last: Optional[tuple] = None
    peak_before_kept: int = 0
    enqueue_s: List[float] = field(default_factory=list)

    def submit(self) -> None:
        t = time.perf_counter()
        with record_function(SUBMIT_RANGE):
            out, self.state = self.program(self.pool[self.k % self.pool.shape[0]], self.state)
        self.enqueue_s.append(time.perf_counter() - t)
        if self.pool.is_cuda:
            ev = torch.cuda.Event()
            ev.record()
        else:
            ev = _NoEvent()
        self.inflight.append((self.k, t, out, ev))
        self.k += 1

    def wait(self):
        """Wait on the oldest batch: (submitted, completion seen) on the
        host clock, and (index, outputs)."""
        k, t, out, ev = self.inflight.popleft()
        with record_function(WAIT_RANGE):
            ev.synchronize()
        done = time.perf_counter()
        if k == self.sample_at:
            if self.pool.is_cuda:
                # from here on the allocator also counts the kept outputs:
                # its peak so far is read and restarted (see peak_bytes)
                self.peak_before_kept = torch.cuda.max_memory_allocated(self.pool.device)
                torch.cuda.reset_peak_memory_stats(self.pool.device)
            self.kept = (k, out)
        return t, done, (k, out)

    def run(self, in_flight: int, batches: int = None, deadline: float = None):
        """Keep in_flight batches submitted until `batches` were or the
        deadline passed, then drain: [(submitted, done)] of each batch."""
        times, first = [], self.k

        def more():
            return ((batches is not None and self.k - first < batches)
                    or (deadline is not None and time.perf_counter() < deadline))

        while True:
            while len(self.inflight) < in_flight and more():
                self.submit()
            if not self.inflight:
                return times
            t, done, item = self.wait()
            times.append((t, done))
            if not self.inflight and not more():
                self.last = item
            del item  # not held while the next batches are submitted

    def peak_bytes(self) -> int:
        """The allocator's peak over set-up and the window so far, without
        the kept batch's outputs, which no deployment holds: those are
        moved to the host, and the bytes that frees are taken off the peak
        read since they were kept."""
        device = self.pool.device
        peak = torch.cuda.max_memory_allocated(device)
        if self.kept is None:
            return peak
        held = torch.cuda.memory_allocated(device)
        k, out = self.kept
        self.kept = (k, {key: v.cpu() for key, v in out.items()})
        del out
        kept_bytes = held - torch.cuda.memory_allocated(device)
        print(f"peak bytes: {self.peak_before_kept} before batch {k} was kept, {peak} since, "
              f"{kept_bytes} of it kept", file=sys.stderr)
        return max(self.peak_before_kept, peak - kept_bytes)

    def sampled(self):
        if self.kept is None or self.kept[0] == self.last[0]:
            return [self.last]
        return [self.kept, self.last]


def _profiled(stream: Stream, in_flight: int, batches: int) -> TraceSummary:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stream.run(in_flight, batches=batches)
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return summarize(json.load(f))
    finally:
        os.remove(path)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda",
             program_factory=PortProgram, t0: float = None) -> dict:
    """One run of `cell`: the result object (see the module's docstring)."""
    t0 = _T0 if t0 is None else t0
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    cfg, traffic = cell.config, cell.traffic
    batch, in_flight = traffic["batch"], traffic["in_flight"]
    phases = [("start", time.time() - t0)]
    pool = frames.make_pool(traffic, cfg["encoding"], cfg["frame_hw"], seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    phases.append(("frames", time.time() - t0))
    program = program_factory(cfg, device)
    phases.append(("build", time.time() - t0))
    # the warm-up takes the window's path, so that the allocator's cache
    # holds the window's blocks before it starts
    warm = Stream(program, pool, program.init_state())
    warm.run(in_flight, batches=traffic["warmup_batches"])
    del warm
    sample_at = random.Random(seed).randrange(traffic["sample_within_batches"])
    stream = Stream(program, pool, program.init_state(), sample_at)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.time() - t0
    phases.append(("warm-up", setup_s))
    print("set-up s (cumulative): " + ", ".join(f"{n} {t:.3f}" for n, t in phases),
          file=sys.stderr)

    start = time.perf_counter()
    deadline = start + seconds
    times = stream.run(in_flight, deadline=deadline)
    inside = [(t, done) for t, done in times if done <= deadline]
    readings = Readings(config=cfg, traffic=traffic, setup_s=setup_s, seconds=seconds,
                        frames=batch * len(inside),
                        latencies_s=[done - t for t, done in inside],
                        enqueue_s=list(stream.enqueue_s),
                        peak_bytes=stream.peak_bytes() if cuda else 0)
    if trace:
        n = max(1, traffic["trace_frames"] // batch)
        readings.trace = _profiled(stream, in_flight, n)
        readings.traced_frames = n * batch

    sampled, final_state, n_batches = stream.sampled(), stream.state, stream.k
    del program, stream
    if cuda:
        torch.cuda.empty_cache()
    checks, compared, bad = check.compare(cfg, pool, n_batches, sampled, final_state, device)

    metrics = cell.per_layer if trace else cell.end_to_end
    values = {}
    for m in metrics:
        v = m.read(readings)
        if v is not None:
            values[m.name] = {"value": v, "unit": m.unit}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": readings.peak_bytes}
    result = {"correct": check.passes(checks) and bad == 0, "attempted": n_batches * batch,
              "failed": bad, "metrics": values, "device": dev}
    if readings.trace is not None:
        dev["busy_s"], dev["window_s"] = readings.trace.busy_s, readings.trace.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in readings.trace.device_ops],
                               "idle_gaps": [list(x) for x in readings.trace.idle_gaps]}
    result["checks"] = {"frames_compared": {"value": compared, "limit": None},
                        **{k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # one process with one CPU thread of its own: the chain's host work is
    # Python and launches, and the card's host is shared
    torch.set_num_threads(1)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"isp_bench: the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    bad_imports = imports.reference_violations()
    if bad_imports:
        print(f"isp_bench: the reference imports {bad_imports}", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    loaded = imports.forbidden_loaded()
    if loaded:
        print(f"isp_bench: JAX or the JAX package loaded: {loaded}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
