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


# f32 operations an output value of kernel E's blend: four products and
# three sums (the rounding and the clamp are not counted)
REMAP_FLOAT_OPS_PER_VALUE = 7


def remap_float_work(batch: int, h: int, w: int, n: int, channels: int,
                     live: Optional[int] = None) -> dict:
    """The work of kernel E on `batch` frames of `channels` [h, w] u8 planes
    remapped to n output pixels: "bytes", the planes read and the [batch, n,
    channels] output written once, and the map (a 4-byte base and four
    4-byte weights a pixel) read once; "ops", REMAP_FLOAT_OPS_PER_VALUE for
    each output value of the `live` pixels (default n) that have a nonzero
    weight, the others being 0 without a blend."""
    live = n if live is None else live
    return {"bytes": batch * channels * (h * w + n) + 20 * n,
            "ops": batch * channels * live * REMAP_FLOAT_OPS_PER_VALUE}


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
