"""Statistical white-balance methods: simple, grey_world, pca and learned
(PyTorch port of raw_image_pipeline_tpu/ops/white_balance.py; learned's
statistics and model are in ops/learned_wb.py, "ccc" in ops/ccc.py).

Every method ends in a per-frame, per-channel map of a u8 value to a u8
value, so each runs as three steps over the three [B, H, W] u8 planes
(b, g, r) the pipeline carries:

  statistics  one pass over the planes makes a per-frame record (kernel K,
              csrc/wb_stats.cu; for learned, its 64^3 histogram after it,
              kernel L, csrc/wb_hist64.cu): wb_stats_plain;
  tables      the record becomes [B, 3, 256] u8 tables, with PCA's NaN
              flags (kernel M, csrc/wb_tables.cu): wb_tables_plain;
  apply       a gather a pixel (kernel G's table step, ops/pointwise.py):
              apply_tables_plain.

`wb_tables` runs the first two, `balance_white_*_planes` all three: on
CUDA planes the kernels, on CPU planes or with plain=True the plain
versions here, which are the kernels' arithmetic as eager ops.
`balance_white_simple`, `_grey_world`, `_pca` and `_learned` take
[..., H, W, 3] frames, as the reference package's, and flatten the leading
dims into the planes' batch. The statistics are per channel and the
positional rules index the flattened H*W frame, so the planar form
computes what the reference package's packed form does.

The rule that governs them is exactness, on every device:
  * counts and sums are integers (int64 where a frame's sum could pass
    2^31); a single cast to f32 rounds to nearest-even on the CPU and on
    CUDA, as the reference package's u32 -> f32 cast does;
  * f32 formulas are separate eager ops, each rounding once (no fused op);
  * a per-pixel map that depends only on the u8 value and per-frame
    scalars is evaluated over the 256 values, then gathered — the same
    numbers as evaluating it per pixel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from raw_image_pipeline_tpu_torch import kernels
from raw_image_pipeline_tpu_torch.ops import learned_wb
from raw_image_pipeline_tpu_torch.ops.common import (fma_f32, gains_tables_8p8, image_planes,
                                                     planes_image, round_u8)

Planes = tuple  # (b, g, r), each [B, H, W] uint8

# the methods, as kernels K's and M's mode codes
METHODS = ("simple", "grey_world", "pca", "learned")
# a frame's record: its shape after the batch, its dtype
RECORD = {"simple": ((3, 256), torch.int32), "grey_world": ((3,), torch.int64),
          "pca": ((3, 3), torch.int64), "learned": ((learned_wb.SLOTS,), torch.int64)}


class WbTables(NamedTuple):
    """A statistical white balance's per-frame result: tables [B, 3, 256]
    u8 (channel c's value v becomes tables[i, c, v]) and, for PCA, nan
    [B, 3] u8: 1 where a channel's coefficients are NaN (a constant
    channel), whose pixels become 255 before flat position nan_limit of the
    frame and 0 from it (None for the other methods)."""

    tables: torch.Tensor
    nan: Optional[torch.Tensor] = None


def _method(method: str) -> str:
    name = "grey_world" if method == "gray_world" else method
    if name not in METHODS:
        raise ValueError(f"White Balance method [{method}] not supported")
    return name


def _lut_apply(plane: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Per-frame 256-entry table: plane [B, H, W] u8, lut [B, 256] ->
    lut[i, plane[i]] as [B, H, W]."""
    b = plane.shape[0]
    idx = plane.reshape(b, -1).long()
    return torch.gather(lut, 1, idx).reshape(plane.shape)


def _flat_body_mask(h: int, w: int, width: int, device) -> torch.Tensor:
    """[H, W] bool: True for the pixels of the flattened frame that fall in
    full `width`-pixel blocks (a SIMD body), False for the scalar tail."""
    n = h * w
    return (torch.arange(n, device=device) < (n // width) * width).reshape(h, w)


def pca_nan_limit(h: int, w: int) -> int:
    """The flat position of an [h, w] frame from which a NaN channel of
    PCA reads 0 (before it 255): the start of the 4-wide minps's scalar
    tail."""
    return (h * w) // 4 * 4


def apply_tables_plain(planes: Planes, tables: torch.Tensor, nan=None,
                       nan_limit: Optional[int] = None) -> Planes:
    """Kernel G's table step, plain: planes[c] of frame i through
    tables[i, c] ([B, 3, 256] u8); where nan[i, c] ([B, 3], nonzero) the
    plane becomes 255 before flat position nan_limit of the frame and 0
    from it (default pca_nan_limit of the planes' own size; a slab of rows
    passes the whole frame's limit less its first row's flat position)."""
    out = [_lut_apply(pl, tables[:, c]) for c, pl in enumerate(planes)]
    if nan is not None:
        h, w = planes[0].shape[-2:]
        limit = pca_nan_limit(h, w) if nan_limit is None else nan_limit
        flat = torch.arange(h * w, device=planes[0].device).reshape(h, w)
        pattern = torch.where(flat < limit, 255, 0).to(torch.uint8)
        out = [torch.where(nan[:, c, None, None] != 0, pattern, o) for c, o in enumerate(out)]
    return tuple(out)


# ---------------------------------------------------------------------------
# simple (cv::xphoto::SimpleWB)
# ---------------------------------------------------------------------------

def channel_histograms(planes: Planes) -> torch.Tensor:
    """[B, 3, 256] int64 per-frame, per-channel histograms, as one bincount
    over (frame*3 + channel)*256 + value (exact integer counts)."""
    v = torch.stack(planes, dim=1).reshape(planes[0].shape[0], 3, -1).long()  # [B, 3, N]
    b = v.shape[0]
    offs = (torch.arange(b * 3, device=v.device) * 256).reshape(b, 3, 1)
    counts = torch.bincount((v + offs).reshape(-1), minlength=b * 3 * 256)
    return counts.reshape(b, 3, 256)


# SimpleWB stretch coefficients (a verbatim copy of the reference package's
# host tables): alpha = 255/span and beta = -p1*alpha computed in DOUBLE,
# cast to f32, as the library hands them to cv::Mat::convertTo.
_SIMPLE_SPAN = np.arange(257, dtype=np.float64)
_SIMPLE_SPAN[0] = 1.0
_SIMPLE_ALPHA64 = 255.0 / _SIMPLE_SPAN  # [257]
_SIMPLE_ALPHA32 = _SIMPLE_ALPHA64.astype(np.float32)
_SIMPLE_BETA32 = (
    -np.arange(256, dtype=np.float64)[:, None] * _SIMPLE_ALPHA64[None, :]
).astype(np.float32)  # [p1, span] -> f32(-p1 * alpha64)


@functools.lru_cache(maxsize=None)
def _simple_tables(device: torch.device):
    """(alpha [257], beta [256, 257]) f32 on `device`, copied there once."""
    return (torch.as_tensor(_SIMPLE_ALPHA32, device=device),
            torch.as_tensor(_SIMPLE_BETA32, device=device))


def simple_target(p: float, npix: int) -> float:
    """SimpleWB's f32 walk target (p * n) / 100 for frames of npix pixels."""
    return float(np.float32(np.float32(p) * np.float32(npix)) / np.float32(100.0))


def _simple_tables_plain(counts: torch.Tensor, p: float, npix: int) -> torch.Tensor:
    """cv::xphoto::SimpleWB's tables from the [B, 3, 256] counts: per
    channel, walk the histogram from each end while the cumulative count
    (as f32) is strictly below the f32 target (stop bins p1, p2), then
    v -> cvRound(fma(v, alpha32, beta32)) with a single rounding."""
    dev = counts.device
    hist = counts.long()
    target = simple_target(p, npix)
    cum = torch.cumsum(hist, dim=-1).to(torch.float32)
    p1 = (cum < target).sum(-1)
    cum_top = torch.cumsum(torch.flip(hist, dims=(-1,)), dim=-1).to(torch.float32)
    p2 = 255 - (cum_top < target).sum(-1)
    # degenerate p (>= ~50%): both walks run off the histogram; clamp to the
    # last bin, as the reference package does
    p1 = torch.clamp(p1, 0, 255)
    p2 = torch.clamp(p2, 0, 255)
    span = torch.clamp(p2 + 1 - p1, min=1)
    alpha32, beta32 = _simple_tables(dev)
    alpha = alpha32[span]  # [B, 3]
    beta = beta32[p1, span]
    x = torch.arange(256, dtype=torch.float32, device=dev)
    return round_u8(fma_f32(x[None, None, :], alpha[..., None], beta[..., None]))


# ---------------------------------------------------------------------------
# grey_world (cv::xphoto::GrayworldWB)
# ---------------------------------------------------------------------------

def grey_world_t255(thresh: float) -> int:
    """GrayworldWB's integer threshold, cvRound(f32(thresh) * 255) at init."""
    return int(np.rint(np.float32(thresh) * 255))


def _grey_world_stats(planes: Planes, t255: int) -> torch.Tensor:
    """[B, 3] int64: the channel sums over GrayworldWB's unsaturated
    pixels, (mx-mn)*255 <= t255*mx in integers."""
    b, g, r = (pl.to(torch.int32) for pl in planes)
    mx = torch.maximum(torch.maximum(b, g), r)
    mn = torch.minimum(torch.minimum(b, g), r)
    if t255 <= 257:
        # t255*mx < 2^16: the library's u16 SIMD lanes cannot wrap
        m = (mx - mn) * 255 <= t255 * mx
    else:
        # thresh > ~1.008: the library's 16-px SIMD body computes t255*mx in
        # u16 lanes, which wrap, while the scalar tail (the last H*W % 16
        # pixels of the flattened frame) compares in int
        h, w = mx.shape[-2:]
        body = _flat_body_mask(h, w, 16, mx.device)
        rhs = torch.where(body, (t255 * mx) & 0xFFFF, t255 * mx)
        m = (mx - mn) * 255 <= rhs
    return torch.stack(
        [torch.where(m, c, 0).to(torch.int64).sum(dim=(-2, -1)) for c in (b, g, r)], dim=-1)


def _grey_world_tables_plain(sums: torch.Tensor) -> torch.Tensor:
    """Gains toward the minimum positive sum, rint(f32(smin)/f32(s)*256)
    (0 for a zero sum), as (v*gain) >> 8 tables."""
    big = torch.iinfo(torch.int64).max
    smin = torch.where(sums > 0, sums, big).min(dim=-1, keepdim=True).values
    gi = torch.round(smin.to(torch.float32) / sums.to(torch.float32) * 256.0).to(torch.int32)
    return gains_tables_8p8(torch.where(sums > 0, gi, 0))


# ---------------------------------------------------------------------------
# pca (the reference's custom method, white_balance.cpp:73-136)
# ---------------------------------------------------------------------------

def pca_exact_lut(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """[..., 256] uint8 table c -> cvRound(min(rn_f32(x0*c^2 + x1*c), 255)),
    with rn_f32 the single correct rounding of the EXACT real value (the
    library's f64 fma, then narrowing). x0, x1: f32 [...].

    x0*c^2 and x1*c are each exact in f64 (24-bit mantissas times integers
    below 2^16). Their sum is not always: TwoSum gives s = fl64(a+b) and
    the exact error e; rounding s to odd (one ulp toward e when e != 0 and
    s's last bit is even) keeps the sticky information, and narrowing the
    round-to-odd f64 (53 >= 24 + 2 bits) to f32 is then the correct
    rounding of a+b."""
    c = torch.arange(256, dtype=torch.float64, device=x0.device)
    a = x0.to(torch.float64)[..., None] * (c * c)
    b = x1.to(torch.float64)[..., None] * c
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    bits = s.view(torch.int64)
    toward = torch.where((e > 0) == (s > 0), 1, -1)  # +1 grows |s| (sign-magnitude)
    odd = torch.where((e != 0) & ((bits & 1) == 0), bits + toward, bits)
    val = odd.view(torch.float64).to(torch.float32)
    return round_u8(torch.clamp(val, max=255.0))


def _pca_stats(planes: Planes) -> torch.Tensor:
    """[B, 3, 3] int64: per channel (b, g, r) its sum, its sum of squares
    and its maximum."""
    def stats(c):
        ci = c.to(torch.int64)
        return torch.stack([ci.sum(dim=(-2, -1)), (ci * ci).sum(dim=(-2, -1)),
                            ci.amax(dim=(-2, -1))], dim=-1)
    return torch.stack([stats(c) for c in planes], dim=1)


def _pca_solve(stats: torch.Tensor, sg: torch.Tensor, mg: torch.Tensor):
    """Eigen compute_inverse_size2 in f32 on a channel's exact (sum, sum of
    squares, max), op for op as the reference (every product and sum
    rounds on its own)."""
    s = stats[:, 0].to(torch.float32)
    s2 = stats[:, 1].to(torch.float32)  # rn_f32(sum c^2)
    m = stats[:, 2].to(torch.float32)
    m2 = m * m  # exact
    det = s2 * m - s * m2
    invdet = 1.0 / det
    i00 = m * invdet
    i01 = -(s * invdet)
    i10 = -(m2 * invdet)
    i11 = s2 * invdet
    x0 = i00 * sg + i01 * mg
    x1 = i10 * sg + i11 * mg
    return x0, x1


def _pca_tables_plain(stats: torch.Tensor):
    """The reference PCA method's tables: per channel c in (b, r), the 2x2
    solve against the green channel's sum and max, then the map
    cvRound(min(x0*c^2 + x1*c, 255)); g passes through.

    A constant channel (det == 0) gives NaN coefficients; the reference's
    THRESH_TRUNC then runs 4-wide minps (NaN -> the second operand, 255)
    with a scalar tail that keeps NaN, and convertTo saturates NaN to 0:
    255 everywhere but the last (H*W) % 4 pixels of the flattened frame,
    which are 0 — no table, so the channel's nan flag is set (and its table
    is zeros)."""
    sg = stats[:, 1, 0].to(torch.float32)
    mg = stats[:, 1, 2].to(torch.float32)
    ident = torch.arange(256, device=stats.device).to(torch.uint8).expand(stats.shape[0], 256)
    tables, nan = [], []
    for c in range(3):
        if c == 1:
            tables.append(ident)
            nan.append(torch.zeros(stats.shape[0], dtype=torch.bool, device=stats.device))
            continue
        x0, x1 = _pca_solve(stats[:, c], sg, mg)
        bad = torch.isnan(x0) | torch.isnan(x1)
        tables.append(torch.where(bad[:, None], 0, pca_exact_lut(x0, x1)).to(torch.uint8))
        nan.append(bad)
    return torch.stack(tables, dim=1), torch.stack(nan, dim=1).to(torch.uint8)


# ---------------------------------------------------------------------------
# the three steps
# ---------------------------------------------------------------------------

def wb_stats_plain(planes: Planes, method: str, param: Optional[float] = None) -> torch.Tensor:
    """Kernel K's plain version: the per-frame record (RECORD) of `method`
    over planes (b, g, r) [B, H, W] u8; param is the method's own (simple's
    p is not read here, grey-world's and learned's threshold is).
      simple      [B, 3, 256] int32 counts;
      grey_world  [B, 3] int64 masked sums;
      pca         [B, 3, 3] int64 (sum, sum of squares, max) a channel;
      learned     [B, learned_wb.SLOTS] int64 (learned_wb.learned_stats_plain)."""
    method = _method(method)
    if method == "simple":
        return channel_histograms(planes).to(torch.int32)
    if method == "grey_world":
        return _grey_world_stats(planes, grey_world_t255(param))
    if method == "pca":
        return _pca_stats(planes)
    return learned_wb.learned_stats_plain(planes, learned_wb.learned_t255(param))


def wb_tables_plain(record: torch.Tensor, method: str, param: Optional[float], npix: int,
                    hist: Optional[torch.Tensor] = None) -> WbTables:
    """Kernel M's plain version: the record of frames of npix pixels (and
    learned's 64^3 histogram, hist) -> WbTables."""
    method = _method(method)
    if method == "simple":
        return WbTables(_simple_tables_plain(record, param, npix))
    if method == "grey_world":
        return WbTables(_grey_world_tables_plain(record))
    if method == "pca":
        return WbTables(*_pca_tables_plain(record))
    if hist is None:
        raise ValueError("learned: the tables need the 64^3 histogram (hist)")
    return WbTables(learned_wb.learned_tables_plain(record, hist))


def _check_planes(planes, name: str):
    """Three [B, H, W] u8 CUDA planes of one shape and device, as three of
    equal strides (copies of unequal ones)."""
    if len(planes) != 3:
        raise ValueError(f"{name}: expected 3 planes, got {len(planes)}")
    shape = tuple(planes[0].shape)
    for i, p in enumerate(planes):
        if (p.device != planes[0].device or p.device.type != "cuda" or p.dtype != torch.uint8
                or p.dim() != 3 or tuple(p.shape) != shape):
            raise ValueError(f"{name}: planes[{i}] is {tuple(p.shape)} {p.dtype} on {p.device}; "
                             f"expected [B, H, W] uint8 CUDA planes of shape {shape}")
    if len({p.stride() for p in planes}) != 1:
        planes = tuple(p.contiguous() for p in planes)
    b, h, w = shape
    sb, sy, sx = planes[0].stride()
    if h * w >= 2**31 or (h - 1) * sy + (w - 1) * sx >= 2**31 or sx < 0 or sy < 0:
        raise ValueError(f"{name}: a frame of {h}x{w} pixels at strides {(sy, sx)} is out "
                         f"of the kernels' 32-bit range")
    return tuple(planes)


WB_STATS_THREADS = 512  # kernel K's threads a block (csrc/wb_stats.cu)
WB_CHUNK = 16  # pixels a thread of kernels K and L takes at once (csrc/wb_planes.cuh)
MAX_WB_CLUSTER = 16  # kernel K's largest cluster (above 8 a non-portable size)
# the values a cluster of kernel K leaves in its workspace for the last one
# to sum (with more than one cluster a frame): a count a bin (simple), the
# sums and maxima a thread carries (the others)
WB_PARTIAL = {"simple": (768, torch.int32), "grey_world": (3, torch.int64),
              "pca": (9, torch.int64), "learned": (6, torch.int64)}


def wb_stats_grid(batch: int, pixels: int, sms: int, resident: int,
                  largest: int = MAX_WB_CLUSTER):
    """Kernel K's blocks a frame as (cluster, groups): `groups` thread-block
    clusters of `cluster` blocks, for `batch` frames of `pixels` pixels on a
    card of `sms` SMs that holds `resident` of K's blocks each. About two
    waves of resident blocks cover the batch, 2 * sms * resident // batch
    blocks a frame, but none with fewer than 4 chunks a thread and at least
    one; the cluster is the largest power of two of at most `largest` (the
    largest size that can be resident) within that, the groups as many
    clusters as then fit. On an NVIDIA H100 80GB HBM3 (132 SMs, 2 blocks
    each) a 1920x1080 frame takes 16 x 4 blocks at B=1 and B=4, 16 x 2 at
    B=16, 8 x 1 at B=64 and 1 x 1 from B=265: the fastest of the grids
    timed at B = 1, 4 and 16; at B=64 eight blocks a frame ran faster than
    one wave of four (PERF.md)."""
    chunks = -(-pixels // WB_CHUNK)
    want = max(1, min(2 * sms * resident // max(batch, 1), -(-chunks // (4 * WB_STATS_THREADS))))
    cluster = 1
    while 2 * cluster <= min(want, largest):
        cluster *= 2
    return cluster, want // cluster


@functools.lru_cache(maxsize=64)
def _wb_card(index: int, mode: int):
    """The SM count of CUDA device `index`, and kernel K's resident blocks
    an SM and largest resident cluster there in `mode`."""
    resident, largest = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        err = kernels.LIBRARY.get().isp_wb_stats_limits(mode, ctypes.byref(resident),
                                                        ctypes.byref(largest))
    if err != 0:
        raise RuntimeError(f"{kernels.WB_STATS.name}: CUDA error {err} querying its limits")
    return (torch.cuda.get_device_properties(index).multi_processor_count, resident.value,
            largest.value)


_TICKETS = {}  # (device index, stream) -> kernel K's per-frame counters


def _tickets(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least n of kernel K's per-frame counters for `stream`: zeroed once
    when allocated, and left at 0 by every launch that uses them."""
    t = _TICKETS.get((dev.index, stream))
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 64), dtype=torch.int32, device=dev)
        _TICKETS[(dev.index, stream)] = t
    return t


def wb_stats_cuda(planes: Planes, method: str, param: Optional[float] = None, *,
                  batch_limit: int = kernels.MAX_BATCH):
    """Kernel K: wb_stats_plain's record for three [B, H, W] u8 CUDA planes,
    one launch per run of kernels.batch_runs(B, batch_limit), each on
    wb_stats_grid's blocks for the run on this card. For learned, (record,
    hist): hist is the [B, 262144] int32 workspace of kernel L, which K
    zeroes."""
    method = _method(method)
    planes = _check_planes(planes, "kernel K")
    bsz, h, w = planes[0].shape
    dev = planes[0].device
    shape, dtype = RECORD[method]
    record = torch.empty((bsz,) + shape, dtype=dtype, device=dev)
    hist = None
    if method == "learned":
        hist = torch.empty((bsz, learned_wb.N_BINS), dtype=torch.int32, device=dev)
        param = learned_wb.learned_t255(param)
    elif method == "grey_world":
        param = grey_world_t255(param)
    else:
        param = 0
    if not -2**31 <= param < 2**31:
        raise ValueError(f"kernel K: threshold {param} out of range")
    mode = METHODS.index(method)
    stream = kernels.stream_handle(record)
    sms, resident, largest = _wb_card(torch.device(dev).index, mode)
    with torch.cuda.device(dev):
        for f0, n in kernels.batch_runs(bsz, batch_limit):
            cluster, groups = wb_stats_grid(n, h * w, sms, resident, largest)
            ws = tickets = None  # held until the launch is queued
            if groups > 1:
                size, ws_dtype = WB_PARTIAL[method]
                ws = torch.empty((n, groups, size), dtype=ws_dtype, device=dev)
                tickets = _tickets(dev, stream, n)
            kernels.WB_STATS.launch(
                mode, *(p[f0].data_ptr() for p in planes), *planes[0].stride(), n, h, w, param,
                record[f0].data_ptr(), None if hist is None else hist[f0].data_ptr(), cluster,
                groups, None if ws is None else ws.data_ptr(),
                None if tickets is None else tickets.data_ptr(), stream)
    return record if hist is None else (record, hist)


def wb_tables_cluster(batch: int, sms: int, largest: int = MAX_WB_CLUSTER) -> int:
    """Kernel M's blocks a learned frame (one thread-block cluster): the
    largest power of two of at most `largest` (the largest size that can be
    resident) with batch x cluster within one block an SM of the card's
    `sms`, and at least 1. Each block of the cluster walks 1/cluster of the
    frame's 64^3 counts in every pass and takes 1/cluster of the palette's
    density rows. On an NVIDIA H100 80GB HBM3 (132 SMs): 16 up to B=8, 8 at
    B=16, 2 at B=64, 1 from B=67; the fastest of the sizes timed at B = 1,
    4, 16 and 64 (PERF.md)."""
    want = max(1, sms // max(batch, 1))
    cluster = 1
    while 2 * cluster <= min(want, largest):
        cluster *= 2
    return cluster


@functools.lru_cache(maxsize=64)
def _wb_tables_card(index: int):
    """The SM count of CUDA device `index`, and kernel M's largest resident
    learned cluster there."""
    largest = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = kernels.LIBRARY.get().isp_wb_tables_limits(ctypes.byref(largest))
    if err != 0:
        raise RuntimeError(f"{kernels.WB_TABLES.name}: CUDA error {err} querying its limits")
    return torch.cuda.get_device_properties(index).multi_processor_count, largest.value


def wb_tables_cuda(record: torch.Tensor, method: str, param: Optional[float], npix: int,
                   hist: Optional[torch.Tensor] = None, *,
                   features: Optional[torch.Tensor] = None,
                   cluster: Optional[int] = None) -> WbTables:
    """Kernel M: wb_tables_plain for a CUDA record (and learned's
    histogram), one launch, a block a frame; learned a thread-block cluster
    of wb_tables_cluster's blocks a frame (`cluster` forces a size: 1, 2,
    4, 8 or 16), one launch per run of kernels.batch_runs. For learned,
    `features`, a [B, 4, 2] f32 CUDA tensor, also receives the four
    features."""
    method = _method(method)
    dev = record.device
    shape, dtype = RECORD[method]
    bsz = record.shape[0]
    kernels.check_cuda(record, "record", dtype, (bsz,) + shape)
    tables = torch.empty((bsz, 3, 256), dtype=torch.uint8, device=dev)
    nan = torch.empty((bsz, 3), dtype=torch.uint8, device=dev) if method == "pca" else None
    ptr = {}
    if method == "learned":
        if hist is None:
            raise ValueError("kernel M: learned needs the 64^3 histogram (hist)")
        kernels.check_cuda(hist, "hist", torch.int32, (bsz, learned_wb.N_BINS))
        fi, tv, lv = learned_wb.model_tensors_card(dev)
        ptr.update(fi=fi.data_ptr(), tv=tv.data_ptr(), lv=lv.data_ptr())
        if features is not None:
            kernels.check_cuda(features, "features", torch.float32, (bsz, 4, 2))
        if cluster is not None and cluster not in (1, 2, 4, 8, 16):
            raise ValueError(f"kernel M: cluster {cluster} is not 1, 2, 4, 8 or 16")
    target = simple_target(param, npix) if method == "simple" else 0.0
    stream = kernels.stream_handle(record)
    with torch.cuda.device(dev):
        if method != "learned":
            kernels.WB_TABLES.launch(
                METHODS.index(method), record.data_ptr(), None, bsz, npix, target, None, None,
                None, tables.data_ptr(), None if nan is None else nan.data_ptr(), None, 1, stream)
            return WbTables(tables, nan)
        sms, largest = _wb_tables_card(torch.device(dev).index)
        for f0, n in kernels.batch_runs(bsz):
            c = cluster or wb_tables_cluster(n, sms, largest)
            kernels.WB_TABLES.launch(
                METHODS.index(method), record[f0].data_ptr(), hist[f0].data_ptr(), n, npix,
                target, ptr["fi"], ptr["tv"], ptr["lv"], tables[f0].data_ptr(), None,
                None if features is None else features[f0].data_ptr(), c, stream)
    return WbTables(tables, nan)


def wb_tables(planes: Planes, method: str, param: Optional[float] = None, *,
              plain: bool = False) -> WbTables:
    """The statistics and the tables of `method` for planes (b, g, r)
    [B, H, W] u8: on CUDA planes kernels K, L (learned) and M, on CPU
    planes or with plain=True their plain versions."""
    method = _method(method)
    h, w = planes[0].shape[-2:]
    if plain or planes[0].device.type == "cpu":
        record = wb_stats_plain(planes, method, param)
        hist = None
        if method == "learned":
            hist = learned_wb.hist64_plain(planes, record, learned_wb.learned_t255(param))
        return wb_tables_plain(record, method, param, h * w, hist)
    if method == "learned":
        record, hist = wb_stats_cuda(planes, method, param)
        learned_wb.hist64_cuda(planes, record, learned_wb.learned_t255(param), hist)
        return wb_tables_cuda(record, method, param, h * w, hist)
    return wb_tables_cuda(wb_stats_cuda(planes, method, param), method, param, h * w)


def balance_white_planes(planes: Planes, method: str, param: Optional[float] = None, *,
                         out=None, plain: bool = False) -> Planes:
    """`method` on planes (b, g, r) [B, H, W] u8: wb_tables, then the
    tables applied by kernel G's table step (pointwise_planes; into `out`,
    three planes, where given)."""
    from raw_image_pipeline_tpu_torch.ops.pointwise import pointwise_planes

    t = wb_tables(planes, method, param, plain=plain)
    return pointwise_planes(*planes, wb_tables=t.tables, wb_nan=t.nan, out=out, plain=plain)


def balance_white_simple_planes(planes: Planes, p: float, *, plain: bool = False) -> Planes:
    """cv::xphoto::SimpleWB (setP(p)), 8u, default ranges, on planes."""
    return balance_white_planes(planes, "simple", p, plain=plain)


def balance_white_grey_world_planes(planes: Planes, thresh: float, *,
                                    plain: bool = False) -> Planes:
    """cv::xphoto::GrayworldWB on planes: integer saturation mask
    (mx-mn)*255 <= cvRound(thr*255)*mx, integer channel sums, gains toward
    the minimum positive sum, rint(f32(smin)/f32(s)*256), applied as
    (v*gain) >> 8."""
    return balance_white_planes(planes, "grey_world", thresh, plain=plain)


def balance_white_pca_planes(planes: Planes, *, plain: bool = False) -> Planes:
    """The reference PCA method on planes: per channel c in (b, r), the 2x2
    solve against the green channel's sum and max, then the per-pixel map
    cvRound(min(x0*c^2 + x1*c, 255)); g passes through; a constant channel
    gives the NaN pattern (_pca_tables_plain)."""
    return balance_white_planes(planes, "pca", plain=plain)


# ---------------------------------------------------------------------------
# [..., H, W, 3] frames (the reference package's entry points)
# ---------------------------------------------------------------------------


def _balanced_image(image: torch.Tensor, method: str, param, plain: bool) -> torch.Tensor:
    lead, planes = image_planes(image)
    if plain or image.device.type == "cpu":
        return planes_image(balance_white_planes(planes, method, param, plain=True), lead)
    out = torch.empty(image.shape, dtype=torch.uint8, device=image.device)
    flat = out.reshape((-1,) + tuple(out.shape[-3:]))
    balance_white_planes(planes, method, param, out=flat.unbind(-1))
    return out


def balance_white_simple(image: torch.Tensor, p: float, *, plain: bool = False) -> torch.Tensor:
    """cv::xphoto::SimpleWB on [..., H, W, 3] u8 BGR frames."""
    return _balanced_image(image, "simple", p, plain)


def balance_white_grey_world(image: torch.Tensor, thresh: float, *,
                             plain: bool = False) -> torch.Tensor:
    """cv::xphoto::GrayworldWB on [..., H, W, 3] u8 BGR frames."""
    return _balanced_image(image, "grey_world", thresh, plain)


def balance_white_pca(image: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """The reference PCA method on [..., H, W, 3] u8 BGR frames."""
    return _balanced_image(image, "pca", None, plain)


def balance_white_learned(image: torch.Tensor, thresh: float, *,
                          plain: bool = False) -> torch.Tensor:
    """cv::xphoto::LearningBasedWB with the default model on [..., H, W, 3]
    u8 BGR frames (ops/learned_wb.balance_white_learned_model)."""
    return _balanced_image(image, "learned", thresh, plain)
