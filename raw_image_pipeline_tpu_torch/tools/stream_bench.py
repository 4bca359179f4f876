"""End-to-end StreamRunner throughput from a directory of raw frames (the
port of raw_image_pipeline_tpu/tools/stream_bench.py): native pump ->
pinned double-buffered copies to the card -> the flagship chain -> copies
back -> sink.

    python -m raw_image_pipeline_tpu_torch.tools.stream_bench [--device cuda]
        [--frames 256] [--height 1080] [--width 1920] [--batch 32]
        [--frames-dir build/stream_frames]

Writes `--frames` seeded bayer_gbrg8 raw frames into `--frames-dir` (kept
for the next run), warms the runner at the batch size, then streams them
twice: once with a sink that counts every stream's images, once with a
sink that reads one pixel of each. The frames are read by the native
FramePump where its library builds, else with numpy. Reports on stderr.
The JAX tool's persistent compilation cache has no counterpart: the port
compiles nothing per call.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames-dir", default=os.path.join("build", "stream_frames"))
    args = ap.parse_args(argv)

    from raw_image_pipeline_tpu_torch.config import flagship_config
    from raw_image_pipeline_tpu_torch.runtime.native import FramePump, native_available
    from raw_image_pipeline_tpu_torch.runtime.stream import StreamRunner

    h, w, b = args.height, args.width, args.batch
    d = args.frames_dir
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (h, w), np.uint8)
    files = []
    for i in range(args.frames):
        path = os.path.join(d, f"frame_{h}x{w}_{i:04d}.raw")
        if not os.path.exists(path):
            np.roll(frame, i, axis=1).tofile(path)  # vary content cheaply
        files.append(path)
    pump_ok = native_available()
    log(f"{args.frames} raw frames in {d}; native pump available: {pump_ok}")

    runner = StreamRunner(flagship_config(h, w), "bayer_gbrg8", (h, w), batch_size=b,
                          device=args.device)

    def frames():
        if pump_ok:
            for batch in FramePump(files, (h, w), batch=b):
                yield from batch
        else:
            for p in files:
                yield np.fromfile(p, np.uint8).reshape(h, w)

    t0 = time.perf_counter()
    runner.run([frame] * b, lambda *a: None)  # warm at the real batch shape
    log(f"warm-up: {time.perf_counter() - t0:.1f}s")

    counts = {}

    def sink(stream, idx, img):
        counts[stream] = counts.get(stream, 0) + 1

    results = {}
    for label, fn in (("counting sink", sink),
                      ("sink reads 1 px/frame", lambda s_, i, img: img[0, 0])):
        runner.reset_white_balance()
        t0 = time.perf_counter()
        n = runner.run(frames(), fn)
        dt = time.perf_counter() - t0
        results[label] = n / dt
        log(f"streamed {n} frames in {dt:.2f}s = {n / dt:.1f} frames/s end-to-end "
            f"(disk->pump->H2D->chain->D2H->sink, {label}, {args.device}, B={b})")
    log(f"sink calls: {counts}")
    return results


if __name__ == "__main__":
    main()
