"""How chip_smoke.py and the port's tools measure a kernel on a CUDA card:
its device time, its time per call, and its bound, the least time the
card could take for the same work.

This module imports nothing of the package: compare_checkouts.py loads it
beside another checkout's package.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Optional

# published peaks of one H100 SXM (NVIDIA's data sheet) at the full 700 W:
# HBM3 bytes/s and f32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# integer operations a pixel of kernels A's and D's functions, counted from
# the plain formulas (ops/debayer.py; a shift or a multiply by a constant
# is one operation, sums shared between a pixel's filters counted once).
# Bilinear: 2 rounded averages, of 4 taps at an R or B site (5 each) and of
# 2 at a G site (3 each): 8 on average. MHT: at an R or B site 33 (the tap
# sums 6, g_at_rb 5, rb_at_br 8, two round-half-even descales of 5 as
# kernel D computes them, two clamps of 2), at a G site 34 (tap sums 7,
# the shared 10x - 2*diag4 3, each filter 5, two descales and two
# clamps): 33.5 on average.
DEBAYER_OPS_PER_PIXEL = {"bilinear": 8.0, "mht": 33.5}


def bound(bytes_: float, ops: float) -> dict:
    """bound_ms, the least time the card could take for the work, and
    bound_by: the larger of bytes over the memory rate and operations (f32;
    integer for kernels A and D) over the f32 rate."""
    by_bytes, by_ops = bytes_ / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "operations" if by_ops > by_bytes else "bytes"}


def debayer_work(pixels: int, algorithm: str) -> dict:
    """The work of kernel A ("bilinear") or D ("mht") on `pixels` mosaic
    pixels: "bytes", one byte read and three written per pixel; "ops", the
    integer operations of DEBAYER_OPS_PER_PIXEL, which bound() counts at
    the f32 rate (the only scalar rate of the published table; an
    instruction may do two integer operations, e.g. a three-input add)."""
    return {"bytes": 4 * pixels, "ops": pixels * DEBAYER_OPS_PER_PIXEL[algorithm]}


def debayer16_work(pixels: int, out_bytes: int) -> dict:
    """The work of kernel P on `pixels` 16-bit mosaic pixels: "bytes", two
    bytes read and three values of out_bytes (1 in u8 mode, 2 in u16 mode)
    written per pixel; "ops", the bilinear stencil's integer operations
    (DEBAYER_OPS_PER_PIXEL, the shift of u8 mode not counted)."""
    return {"bytes": (2 + 3 * out_bytes) * pixels,
            "ops": pixels * DEBAYER_OPS_PER_PIXEL["bilinear"]}


# f32 operations an output value of kernel E's blend: four products and
# three sums (the rounding and the clamp are not counted)
REMAP_FLOAT_OPS_PER_VALUE = 7


def remap_float_work(batch: int, h: int, w: int, n: int, channels: int,
                     live: Optional[int] = None, maps: int = 1) -> dict:
    """The work of kernel E on `batch` frames of `channels` [h, w] u8 planes
    remapped to n output pixels through `maps` maps (one per camera, each
    serving batch // maps frames): "bytes", the planes read and the [batch,
    n, channels] output written once, and each map (a 4-byte base and four
    4-byte weights a pixel) read once; "ops", REMAP_FLOAT_OPS_PER_VALUE for
    each output value of the pixels that have a nonzero weight, `live` of
    them over all the maps together (default n a map), the others being 0
    without a blend."""
    live = n * maps if live is None else live
    return {"bytes": batch * channels * (h * w + n) + 20 * n * maps,
            "ops": batch // maps * channels * live * REMAP_FLOAT_OPS_PER_VALUE}


# f32 operations an output value of kernel F's functions: lerp, four mask
# products, three differences and three fmas (two each); fixed32, four
# products, three sums, the rounding offset and the scale
REMAP_LERP_OPS_PER_VALUE = {"lerp": 13, "fixed32": 9}


def remap_lerp_work(batch: int, h: int, w: int, n: int, channels: int, mode: str,
                    live: Optional[int] = None, maps: int = 1,
                    explicit: Optional[int] = None) -> dict:
    """The work of kernel F in `mode` ("lerp" or "fixed32") on `batch`
    frames of `channels` [h, w] u8 planes remapped to n output pixels
    through `maps` maps, as remap_float_work counts kernel E's: "bytes", the
    planes read, the output written and each map read once (a 4-byte base
    and six 4-byte weights a pixel in lerp mode, four in fixed32; with
    `explicit` given, fixed32's compact map: a 4-byte base and a 2-byte
    code a pixel, and the four weights of the `explicit` pixels of all the
    maps together, ops/undistortion.remap_fixed32_code, the weight table's
    rows being computed, not read); "ops", REMAP_LERP_OPS_PER_VALUE[mode] for
    each output value of the `live` pixels (a nonzero tap weight; default n
    a map)."""
    live = n * maps if live is None else live
    if mode == "fixed32" and explicit is not None:
        map_bytes = 6 * n * maps + 16 * explicit
    else:
        map_bytes = (4 + 4 * (6 if mode == "lerp" else 4)) * n * maps
    return {"bytes": batch * channels * (h * w + n) + map_bytes,
            "ops": batch // maps * channels * live * REMAP_LERP_OPS_PER_VALUE[mode]}


# integer and f32 operations a pixel of kernel G's steps, counted from the
# plain formulas (ops/ccc.apply_gains_planes, color_calibration,
# vignetting, color_enhancer, colorspace; a multiply, add, shift, compare,
# select, min, max or rounding is one operation, an fma two, a table gather
# none, the linear branch of Lab2BGR's ab_to_xz and cv2's SIMD HSV2BGR
# kernel): the gains, three products, roundings and two-sided clamps (12);
# colour calibration, three rows of three products and three sums, a
# rounding and a clamp (27); vignetting, BGR2Lab's three fixed-point dot
# products, descales and index clamps (27), L, a and b (20), the mask's
# product (4), Lab2BGR's a and b divisions (9), two ab_to_xz (14) and three
# output rows (27) (101 together); the enhancer, BGR2HSV (19) and HSV2BGR
# (25) (44). bound() counts them at the f32 rate, as it does A's and D's.
POINTWISE_OPS = {"gains": 12, "calibration": 27, "lut": 0, "vignetting": 101, "enhancer": 44,
                 "table": 0}


def pointwise_work(batch: int, h: int, w: int, steps) -> dict:
    """The work of kernel G on `batch` frames of three [h, w] u8 planes
    with `steps` (POINTWISE_OPS's keys) on: "bytes", the planes read and
    written once, the [h, w] f32 mask read once with vignetting, the gains
    ([batch, 3] f32) and the call's small tables (linearize 1 KB, LUT 256
    bytes, enhancer 768 bytes, the table step's 768 bytes a frame) read
    once; "ops", POINTWISE_OPS a pixel (the table step, a gather, none)."""
    steps = tuple(steps)
    pixels = batch * h * w
    small = {"gains": 12 * batch, "lut": 256, "vignetting": 4 * h * w + 1024,
             "enhancer": 768, "calibration": 48, "table": 768 * batch}
    return {"bytes": 6 * pixels + sum(small.get(s, 0) for s in steps),
            "ops": pixels * sum(POINTWISE_OPS[s] for s in steps)}


# integer operations a pixel of kernel K's modes, counted from the plain
# formulas (ops/white_balance, ops/learned_wb; a max, min, add, product,
# compare or select is one operation): simple, a count a channel (3);
# grey_world, max and min of three (4), the difference, two products, the
# compare and three masked adds (9 more); pca, a sum, a square, a sum of
# squares and a max a channel (12); learned, the max of three (2), the
# keep compare, the kept count and three sums (5), the pixel's sum (2) and
# its compare with the best (1)
WB_STATS_OPS = {"simple": 3, "grey_world": 13, "pca": 12, "learned": 10}
# a frame's record in bytes (ops/white_balance.RECORD)
WB_RECORD_BYTES = {"simple": 3 * 256 * 4, "grey_world": 3 * 8, "pca": 9 * 8, "learned": 7 * 8}
WB_HIST_BYTES = 4 * 64 ** 3  # learned's 64^3 int32 histogram, a frame


def wb_stats_work(batch: int, h: int, w: int, method: str) -> dict:
    """The work of kernel K in `method`'s mode on `batch` frames of three
    [h, w] u8 planes: "bytes", the planes read and the record written once
    (learned: and kernel L's histogram, which K zeroes, written once);
    "ops", WB_STATS_OPS a pixel."""
    hist = WB_HIST_BYTES if method == "learned" else 0
    return {"bytes": batch * (3 * h * w + WB_RECORD_BYTES[method] + hist),
            "ops": batch * h * w * WB_STATS_OPS[method]}


def wb_hist64_work(batch: int, h: int, w: int, kept: int) -> dict:
    """The work of kernel L on `batch` frames of three [h, w] u8 planes,
    `kept` of their pixels kept: "bytes", the planes read, the record's
    slot read and the histogram written once; "ops", the max of three and
    the keep compare a pixel (3) and the bin, three table reads, two
    shifts and two ors, and the count, a kept pixel (5)."""
    return {"bytes": batch * (3 * h * w + 8 + WB_HIST_BYTES),
            "ops": 3 * batch * h * w + 5 * kept}


def wb_tables_work(batch: int, method: str, palettes=()) -> dict:
    """The work of kernel M in `method`'s mode on `batch` frames: "bytes",
    the record read and the [3, 256] tables written once a frame (learned:
    and the histogram read once); "ops", for learned the density of each
    frame's palette (`palettes`, its entries, at most 300): two
    differences, two products, a sum, a division, a difference and a max a
    pair (8), the walks and tables of the other methods being a few
    thousand operations a frame (counted as none)."""
    hist = WB_HIST_BYTES if method == "learned" else 0
    return {"bytes": batch * (WB_RECORD_BYTES[method] + 768 + hist),
            "ops": sum(8 * n * n for n in palettes)}


def flip_work(batch: int, rows: int, width: int, pixel_bytes: int = 1, planes: int = 1) -> dict:
    """The work of kernel N writing `rows` rows of `width` pixels of
    `pixel_bytes` bytes of a flipped frame, for `planes` planes of `batch`
    frames: "bytes", the input bytes that land in those rows read once and
    the output written once; no operations."""
    return {"bytes": 2 * planes * batch * rows * width * pixel_bytes, "ops": 0}


def lut_work(numel: int) -> dict:
    """The work of kernel O on `numel` u8 bytes: "bytes", each read once and
    written once, and the 256-byte table read once; no operations (a
    lookup is a gather)."""
    return {"bytes": 2 * numel + 256, "ops": 0}


def ccc_response_work(batch: int, n: int = 256) -> dict:
    """The work of kernel C's function, resp = Re(IDFT2(DFT2(X) * W)) / n^2
    + bias, on `batch` real [n, n] f32 histograms:

      "bytes": X read and resp written, W (two planes) and bias read once;
      "least_ops": the f32 operations of the fewest-operation method known,
          real-input FFTs: a forward and an inverse 2-D FFT of N = n^2 real
          values, 2.5 N log2 N each (the radix-2 count); on the n(n/2+1)
          values of the half spectrum, W's Hermitian part with the 1/n^2
          folded in (4) and the complex product (6); the bias (1 per value);
      "dft_products_ops": the twelve real n^3 products (2 operations per
          multiply-add) of the DFT-by-matrix form that kernel C and its
          plain version compute;
      "dft_bytes": "bytes" and the DFT matrix's two planes, which that form
          also reads.
    """
    nn = n * n
    half = n * (n // 2 + 1)
    return {
        "bytes": (2 * batch + 3) * nn * 4,
        "least_ops": batch * (5 * nn * math.log2(nn) + 10 * half + nn),
        "dft_products_ops": batch * 12 * 2 * n ** 3,
        "dft_bytes": (2 * batch + 5) * nn * 4,
    }


# integer operations an output value of kernel H's function: two
# horizontal taps of two rows (4 products, 2 sums), their descales (2), the
# vertical weights (2 products, 2 shifts, 2 sums), the rounding shift and
# the clamp (2)
CCC_RESIZE_OPS_PER_VALUE = 16


def ccc_resize_work(batch: int, planes: int, rows_read: int, cols_read: int, dst_h: int,
                    dst_w: int, src_w: int) -> dict:
    """The work of kernel H on `batch` frames of `planes` u8 planes of
    src_w columns resized to dst_h x dst_w: "bytes", the source pixels the
    function reads (the rows_read x cols_read taps of each plane: a
    1920x1080 -> 360x270 resize reads 720 of the columns and 540 of the
    rows, not the whole plane), the output written and the int32 table (4
    entries an output row and column) read once; "sector_bytes", the same
    with the tapped rows read whole (rows_read x src_w a plane), the floor
    of any kernel on a card that fetches 32-byte sectors when the taps are
    closer than 32 bytes (two every 5.33 bytes at 1920 -> 360); "ops",
    CCC_RESIZE_OPS_PER_VALUE an output value."""
    out = batch * planes * dst_h * dst_w
    rest = out + 16 * (dst_h + dst_w)
    return {"bytes": batch * planes * rows_read * cols_read + rest,
            "sector_bytes": batch * planes * rows_read * src_w + rest,
            "ops": out * CCC_RESIZE_OPS_PER_VALUE}


def ccc_argmax_work(batch: int, n: int = 256) -> dict:
    """The work of kernel I on `batch` [n, n] f32 responses: "bytes", the
    responses read and the [batch, 2] int32 peaks written once; "ops", one
    comparison a value."""
    return {"bytes": batch * (4 * n * n + 8), "ops": batch * n * n}


# f32 operations a frame of kernel J's function: the filter step (p + 1,
# p' + 10, the division, two differences, two products, two sums, 1 - k
# and its product: 11) and the gains (two minimums, three divisions: 5)
CCC_TRACK_OPS = {"kalman": 11, "gains": 5}


def ccc_track_work(rows: int, tracks: int, kalman: bool) -> dict:
    """The work of kernel J on `rows` peaks walked as `tracks` tracks:
    "bytes", the peaks [rows, 2] int32 read and the gains [rows, 3] f32
    written, the 1 KB exp table read once and, with the Kalman filter, each
    track's state (x, p, initialized: 13 bytes) read and written once;
    "ops", CCC_TRACK_OPS a frame."""
    per = CCC_TRACK_OPS["gains"] + (CCC_TRACK_OPS["kalman"] if kalman else 0)
    return {"bytes": rows * 20 + 1024 + (26 * tracks if kalman else 0), "ops": rows * per}


# Kernel J's floor. A track is a serial chain, so J's least time is not its
# bytes (nanoseconds) but a launch and the chain's dependent latencies: a
# step before p repeats (p + 1, p' + 10, the division, 1 - k, the product:
# the chain through p) and a step with the kept gain (z - x, the product,
# the sum: the chain through x). Each is the latency of one step of that
# chain on an NVIDIA H100 80GB HBM3 at 700 W, read by a one-thread probe
# built apart from the package: each chain written with the intrinsics
# csrc/ccc_track.cu uses, its z in registers, 65 536 steps between
# %globaltimer and %clock64 stamps, the median of 5 runs after a warm-up:
# 30.9 ns (61.2 SM cycles) a dividing step, 6.22 ns (12.3) a kept-gain
# step (PERF.md, kernel J).
CCC_TRACK_DIVIDE_NS = 30.9
CCC_TRACK_KEEP_NS = 6.22


def kalman_chain(p: float, initialized: bool, steps: int) -> tuple:
    """(dividing, keeping): of a track's `steps` steps from the state (p,
    initialized), how many divide (p' = p + 1, k = p' / (p' + 10), p = (1 -
    k) p', until a step gives p the bits it came in with) and how many
    keep the gain after that. A fresh track's first step (x = z) is
    neither."""
    import numpy as np

    f = np.float32
    first = 0 if initialized or steps == 0 else 1
    p, dividing = np.array([p], f), 0
    with np.errstate(invalid="ignore", over="ignore"):
        while dividing < steps - first:
            pp = (p + f(1)).astype(f)
            k = (pp / (pp + f(10)).astype(f)).astype(f)
            new = ((f(1) - k).astype(f) * pp).astype(f)
            dividing += 1
            if new.view(np.int32)[0] == p.view(np.int32)[0]:
                break
            p = new
    return dividing, steps - first - dividing


def ccc_track_floor(empty_ms: float, dividing: int, keeping: int) -> dict:
    """Kernel J's latency floor in ms: an empty launch's device ms
    (`empty_ms`: a block that only waits, launched as J is and timed as J
    is, in the same run), `dividing` steps of the chain through p and
    `keeping` steps of the chain through x (kalman_chain; the longest
    track's: tracks walk in parallel)."""
    chain_ms = (dividing * CCC_TRACK_DIVIDE_NS + keeping * CCC_TRACK_KEEP_NS) * 1e-6
    return {"floor_ms": empty_ms + chain_ms, "empty_ms": empty_ms, "chain_ms": chain_ms}


def device_ms(fn, n: int = 20) -> float:
    """Device time of one fn() in ms, by CUDA events around n back-to-back
    calls, the median of 5 such runs (after one warm-up call). Each run
    starts behind a spin of the device (torch.cuda._sleep) long enough for
    the host to enqueue all n calls, so the events see the device's work
    and not the host's launches; an fn that waits for the device itself
    (torch.bincount reads its input's maximum back) is timed with those
    waits."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0  # the host's time for one call
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(min(2 * n * host_s, 0.2) * 2e9))  # about 2e9 cycles a second
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def call_ms(fn, n: int = 20) -> float:
    """Time of one fn() in ms as a caller meets it: CUDA events around one
    call on an idle device, so the host's launches inside the call are
    included; the median of n (after one warm-up call)."""
    import torch

    times = []
    for _ in range(n + 1):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])
