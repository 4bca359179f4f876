"""FFCC convolutional color constancy white balance (PyTorch port of
raw_image_pipeline_tpu/ops/ccc.py; reference: convolutional_color_constancy.cpp,
after Barron, "Fast Fourier Color Constancy", CVPR 2017).

Per frame (reference balanceWhite, ccc.cpp:91-113):
  1. resize to 360x270 (INTER_LINEAR) — ops/resize;
  2. log-chroma histogram (256x256) over non-saturated, finite pixels:
     u = round((log g - log r - uv0)/bin), v = round((log g - log b - uv0)/bin),
     clamped to [0,255], each contributing weight 1/(rows*cols) —
     normalized by *all* pixels (reference quirk, ccc.cpp:235-236);
  3. response = IDFT(DFT(hist) * DFT(filter)) + bias, row-major argmax;
  4. optional Kalman smoothing of the (x=col, y=row) peak (ccc.cpp:300-340);
  5. gains: gain_r = exp(x*bin + uv0), gain_g = 1, gain_b = exp(y*bin + uv0),
     normalized by the min gain;
  6. apply per-channel gains with saturating round-half-even multiply.

`log` and `exp` are served as exact host tables over their 256-value
domains (u8 pixel values; Lu/Lv are multiples of 1/64 offset by uv0), built
with libm — the reference's std::log/std::exp — so every device computes
the same numbers; each table is uploaded once per device. The histogram,
the response, the argmax and the track with the gains each have a plain
version here and a hand-written CUDA kernel (kernel B,
csrc/ccc_histogram.cu; C, csrc/ccc_response.cu; I, csrc/ccc_argmax.cu; J,
csrc/ccc_track.cu; the resize before them is kernel H, ops/resize.py);
`log_chroma_histogram_planes`, `ccc_response`, `response_argmax` and
`track_gains` launch the kernel for a CUDA tensor and run the plain version
for a CPU one (or with plain=True).

The chain works on planes; the image-level API of the reference package
(`log_chroma_histogram`, `log_chroma_histogram_rt`, `estimate_illuminant`,
`apply_gains`, `ccc_balance_white` on [..., H, W, 3] BGR frames) splits the
frames into planes and goes through the same functions.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from raw_image_pipeline_tpu_torch import kernels
from raw_image_pipeline_tpu_torch.ops.common import (
    as_tensor_on,
    image_planes,
    resolve_device,
    round_u8,
)
from raw_image_pipeline_tpu_torch.ops.resize import resize_linear_u8

# Reference constants (ccc.cpp:19-33)
SMALL_W, SMALL_H = 360, 270
BIN_SIZE = 1.0 / 64.0
UV0 = -1.421875
HIST_N = 256


def _build_log_table() -> np.ndarray:
    """f32 log(i) for the 256 u8 values; log(0) = -inf (an invalid pixel)."""
    return np.array(
        [math.log(i) if i else -math.inf for i in range(256)], np.float64
    ).astype(np.float32)


LOG_TAB = _build_log_table()

# cv::cvtColor(BGR2GRAY) weights as f32 values (exact in any f32 op)
_GRAY_R, _GRAY_G, _GRAY_B = (float(np.float32(c)) for c in (0.299, 0.587, 0.114))


def exp_table(uv0: float) -> np.ndarray:
    """f32 exp(Lu) for the 256 bin coordinates x: Lu = f32(x)*bin + uv0 in
    f32 (ccc.py:430-432), exp by libm (the reference's std::exp)."""
    f32 = np.float32
    lu = (np.arange(HIST_N, dtype=f32) * f32(BIN_SIZE) + f32(uv0)).astype(f32)
    return np.array([math.exp(float(v)) for v in lu], np.float64).astype(f32)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """C++ round(): half away from zero."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


# ---------------------------------------------------------------------------
# Histogram (kernel B)
# ---------------------------------------------------------------------------


# kernel B counts a block's pixels in 16 bits: at most 65520 for each of
# the 8 blocks of a frame (MAX_PIXELS in csrc/ccc_histogram.cu)
HIST_KERNEL_MAX_PIXELS = 8 * 65520


@functools.lru_cache(maxsize=8)
def _log_tab_on(device: str) -> torch.Tensor:
    """LOG_TAB on `device`, uploaded once per device."""
    return torch.as_tensor(LOG_TAB, device=device)


def log_chroma_bins(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor,
                    bright_cut: float, dark_cut: float, uv0: float) -> torch.Tensor:
    """The valid pixels of three [B, h, w] u8 planes as flat int64 bin
    indices frame*256^2 + u*256 + v. Cuts and uv0 are the f32 runtime
    values (pre-scaled 255*threshold cuts)."""
    fb, fg, fr = b.float(), g.float(), r.float()
    # the plain chain (r*.299 + g*.587) + b*.114, each op rounded in f32
    gray = (fr * _GRAY_R + fg * _GRAY_G) + fb * _GRAY_B
    include = (gray <= bright_cut) & (gray > dark_cut)
    tab = _log_tab_on(str(b.device))
    log_b = tab[b.long()]
    log_g = tab[g.long()]
    log_r = tab[r.long()]
    valid = include & (b > 0) & (g > 0) & (r > 0)  # log 0 = -inf is not finite
    # (x - uv0) / (1/64) is exactly (x - uv0) * 64
    u = _round_half_away((log_g - log_r - uv0) * 64.0)
    v = _round_half_away((log_g - log_b - uv0) * 64.0)
    u = torch.where(valid, u, 0.0).clamp(0, HIST_N - 1).long()
    v = torch.where(valid, v, 0.0).clamp(0, HIST_N - 1).long()
    frame = torch.arange(b.shape[0], device=b.device).view(-1, *([1] * (b.dim() - 1)))
    return (frame * (HIST_N * HIST_N) + u * HIST_N + v)[valid]


def frame_pixel_weight(h: int, w: int) -> float:
    return float(np.float32(1.0 / (h * w)))  # narrowed as ccc.py:206


def log_chroma_histogram_plain(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor,
                               bright_cut: float, dark_cut: float,
                               uv0: float, pixel_weight: Optional[float] = None) -> torch.Tensor:
    """Plain version of kernel B: three [B, h, w] u8 planes -> [B, 256, 256]
    f32 histogram, the integer counts of the valid pixels' (u, v) bins
    times pixel_weight once (default f32(1/(h*w)); 1.0 gives the counts,
    as the spatial split sums them over slabs)."""
    nb = b.shape[0]
    if pixel_weight is None:
        pixel_weight = frame_pixel_weight(*b.shape[-2:])
    counts = torch.bincount(log_chroma_bins(b, g, r, bright_cut, dark_cut, uv0),
                            minlength=nb * HIST_N * HIST_N)
    return counts.float().view(nb, HIST_N, HIST_N) * pixel_weight


def log_chroma_histogram_cuda(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor,
                              bright_cut: float, dark_cut: float,
                              uv0: float, pixel_weight: Optional[float] = None, *,
                              batch_limit: int = kernels.MAX_BATCH) -> torch.Tensor:
    """Kernel B: same contract as log_chroma_histogram_plain for frames of
    at most HIST_KERNEL_MAX_PIXELS pixels, CUDA tensors; one launch per
    batch_limit frames (kernels.batch_runs, the grid's limit) and no other
    stream operation."""
    for name, t in (("b", b), ("g", g), ("r", r)):
        kernels.check_cuda(t, name, torch.uint8, b.shape)
    if b.dim() != 3:
        raise ValueError(f"planes: expected [B, h, w], got {tuple(b.shape)}")
    nb, h, w = b.shape
    if h * w > HIST_KERNEL_MAX_PIXELS:
        raise ValueError(f"planes: kernel B takes frames of at most {HIST_KERNEL_MAX_PIXELS} "
                         f"pixels, got {h}x{w}")
    hist = torch.empty((nb, HIST_N, HIST_N), dtype=torch.float32, device=b.device)
    if nb and h * w == 0:
        hist.zero_()  # no pixels (an empty slab of the spatial split)
        return hist
    weight = frame_pixel_weight(h, w) if pixel_weight is None else pixel_weight
    tab = _log_tab_on(str(b.device))
    with torch.cuda.device(b.device):
        for s, n in kernels.batch_runs(nb, batch_limit):
            kernels.CCC_HISTOGRAM.launch(
                b[s].data_ptr(), g[s].data_ptr(), r[s].data_ptr(), tab.data_ptr(),
                hist[s].data_ptr(), n, h * w, bright_cut, dark_cut, uv0, weight,
                kernels.stream_handle(b),
            )
    return hist


def pixel_runs(n: int, limit: int) -> Tuple[int, int]:
    """How log_chroma_histogram_runs cuts a frame of n > limit pixels: runs
    of `run` pixels, `k` of them a frame. Where a divisor k of n with
    n/k <= limit lies within 4x the fewest runs, the runs tile the frame
    and its planes are viewed as k frames each, no copy; else runs of
    `limit` pixels, and the frame's last n % limit pixels are a tail run."""
    fewest = -(-n // limit)
    for k in range(fewest, 4 * fewest + 1):
        if n % k == 0:
            return n // k, k
    return limit, n // limit


def log_chroma_histogram_runs(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor,
                              bright_cut: float, dark_cut: float, uv0: float,
                              pixel_weight: Optional[float], hist_fn,
                              limit: int = HIST_KERNEL_MAX_PIXELS) -> torch.Tensor:
    """The histogram of three [B, h, w] u8 planes whose frames may exceed
    `limit` pixels, through hist_fn (log_chroma_histogram_plain's contract)
    on runs of at most `limit` pixels: each frame's pixels are cut into
    runs (pixel_runs), hist_fn counts every run as a frame of its own with
    pixel weight 1, each frame's run counts are summed in int32 and scaled
    once by f32(1/(h*w)) (or pixel_weight). The counts are integers, so
    this equals one histogram of the whole frame bit for bit; it is the rule
    the spatial split uses over row slabs. Frames within the limit go
    through hist_fn once, unchanged."""
    nb, h, w = b.shape
    n = h * w
    if n <= limit:
        return hist_fn(b, g, r, bright_cut, dark_cut, uv0, pixel_weight)
    if pixel_weight is None:
        pixel_weight = frame_pixel_weight(h, w)
    run, k = pixel_runs(n, limit)
    flat = [p.reshape(nb, n) for p in (b, g, r)]
    # a view where the runs tile the frame (run * k == n), else a copy
    body = [p[:, :run * k].reshape(nb * k, 1, run).contiguous() for p in flat]
    counts = hist_fn(*body, bright_cut, dark_cut, uv0, 1.0)
    counts = counts.to(torch.int32).view(nb, k, HIST_N, HIST_N).sum(1, dtype=torch.int32)
    if run * k < n:
        tail = [p[:, run * k:].reshape(nb, 1, n - run * k).contiguous() for p in flat]
        counts += hist_fn(*tail, bright_cut, dark_cut, uv0, 1.0).to(torch.int32)
    return counts.float() * pixel_weight


def log_chroma_histogram_planes(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor,
                                bright_cut: float, dark_cut: float, uv0: float,
                                plain: bool = False,
                                pixel_weight: Optional[float] = None) -> torch.Tensor:
    """[B, h, w] u8 B/G/R planes (the working resize) -> [B, 256, 256] f32
    histogram (pixel_weight: see log_chroma_histogram_plain). Kernel B on
    CUDA tensors, frames over HIST_KERNEL_MAX_PIXELS in runs
    (log_chroma_histogram_runs); the plain version on CPU tensors or with
    plain=True."""
    if plain or b.device.type == "cpu":
        return log_chroma_histogram_plain(b, g, r, bright_cut, dark_cut, uv0, pixel_weight)
    planes = (b.contiguous(), g.contiguous(), r.contiguous())
    return log_chroma_histogram_runs(*planes, bright_cut, dark_cut, uv0, pixel_weight,
                                     log_chroma_histogram_cuda)


# ---------------------------------------------------------------------------
# Response (kernel C)
# ---------------------------------------------------------------------------


def _dft_matrices():
    """Real/imag parts of the 256-point DFT matrix (float32 constants)."""
    k = np.arange(HIST_N)
    ang = -2.0 * np.pi * np.outer(k, k) / HIST_N
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


_DFT_RE, _DFT_IM = _dft_matrices()


@functools.lru_cache(maxsize=8)
def _dft_on(device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(_DFT_RE, device=device),
            torch.as_tensor(_DFT_IM, device=device))


def ccc_response_plain(hist: torch.Tensor, filt_dft_re: torch.Tensor,
                       filt_dft_im: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel C: resp = Re(IDFT2(DFT2(hist) * filt_dft))
    / 256^2 + bias, as the reference package's twelve real matmuls. On a
    CUDA tensor it needs full f32 products (PyTorch's default), since the
    argmax this feeds must match the f32 reference: it raises if the
    caller enabled TF32 and leaves that setting as it found it."""
    if hist.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("ccc_response_plain needs f32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is True")
    Fr, Fi = _dft_on(str(hist.device))
    mm = torch.matmul
    X = hist
    A = mm(X, Fr)  # X F^T == X Fr (F symmetric)
    B = mm(X, Fi)
    Yr = mm(Fr, A) - mm(Fi, B)
    Yi = mm(Fr, B) + mm(Fi, A)
    Zr = Yr * filt_dft_re - Yi * filt_dft_im
    Zi = Yr * filt_dft_im + Yi * filt_dft_re
    Ar = mm(Fr, Zr) + mm(Fi, Zi)
    Ai = mm(Fr, Zi) - mm(Fi, Zr)
    R = mm(Ar, Fr) + mm(Ai, Fi)
    return R * (1.0 / (HIST_N * HIST_N)) + bias


def ccc_response_cuda(hist: torch.Tensor, filt_dft_re: torch.Tensor,
                      filt_dft_im: torch.Tensor, bias: torch.Tensor, *,
                      batch_limit: int = kernels.MAX_BATCH) -> torch.Tensor:
    """Kernel C: same contract as ccc_response_plain, CUDA tensors; one call
    of its entry per batch_limit frames (kernels.batch_runs)."""
    kernels.check_cuda(hist, "hist", torch.float32)
    if hist.dim() != 3 or tuple(hist.shape[1:]) != (HIST_N, HIST_N):
        raise ValueError(f"hist: expected [B, 256, 256], got {tuple(hist.shape)}")
    for name, t in (("filt_dft_re", filt_dft_re), ("filt_dft_im", filt_dft_im),
                    ("bias", bias)):
        kernels.check_cuda(t, name, torch.float32, (HIST_N, HIST_N))
    Fr, Fi = _dft_on(str(hist.device))
    nb = hist.shape[0]
    out = torch.empty_like(hist)
    # the four stages' buffers for the largest run, reused in stream order
    scratch = torch.empty((4, min(nb, batch_limit), HIST_N, HIST_N), dtype=torch.float32,
                          device=hist.device)
    with torch.cuda.device(hist.device):
        for s, n in kernels.batch_runs(nb, batch_limit):
            kernels.CCC_RESPONSE.launch(
                hist[s].data_ptr(), Fr.data_ptr(), Fi.data_ptr(),
                filt_dft_re.data_ptr(), filt_dft_im.data_ptr(), bias.data_ptr(),
                out[s].data_ptr(), scratch.data_ptr(), n,
                kernels.stream_handle(hist),
            )
    return out


def ccc_response(hist: torch.Tensor, filt_dft_re, filt_dft_im, bias_spatial, *,
                 plain: bool = False) -> torch.Tensor:
    """[..., 256, 256] f32 histograms -> [..., 256, 256] f32 responses; the
    filter's DFT and the spatial bias are [256, 256] f32 (tensors or
    arrays). Kernel C on CUDA tensors; the plain version on CPU tensors or
    with plain=True."""
    lead = tuple(hist.shape[:-2])
    x = hist.to(torch.float32).reshape((-1, HIST_N, HIST_N))
    wr, wi, bias = (as_tensor_on(a, hist.device, torch.float32)
                    for a in (filt_dft_re, filt_dft_im, bias_spatial))
    if plain or hist.device.type == "cpu":
        resp = ccc_response_plain(x, wr, wi, bias)
    else:
        resp = ccc_response_cuda(x.contiguous(), wr.contiguous(), wi.contiguous(),
                                 bias.contiguous())
    return resp.reshape(lead + (HIST_N, HIST_N))


# ---------------------------------------------------------------------------
# Argmax (kernel I)
# ---------------------------------------------------------------------------


def response_argmax_plain(response: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel I: row-major first-occurrence argmax ->
    [..., 2] int32 (x=col, y=row), matching cv::minMaxLoc's maxLoc Point
    convention (ccc.cpp:295). torch.argmax returns the first maximal index
    (a NaN counting as the maximum, the first NaN winning)."""
    lead = response.shape[:-2]
    idx = torch.argmax(response.reshape(lead + (-1,)), dim=-1)
    return torch.stack([idx % HIST_N, idx // HIST_N], dim=-1).to(torch.int32)


# the dtypes kernel I reads, each with its code in the C entry
ARGMAX_DTYPES = {torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.bfloat16: 3,
                 torch.uint8: 4, torch.int8: 5, torch.int16: 6, torch.int32: 7, torch.int64: 8}


MAX_ARGMAX_CLUSTER = 16  # kernel I's largest cluster (above 8 a non-portable size)


def argmax_cluster(batch: int, sms: int, largest: int = MAX_ARGMAX_CLUSTER) -> int:
    """Kernel I's blocks a frame (a thread-block cluster): the largest power
    of two of at most `largest` (the largest size that can be resident) for
    which batch x cluster stays within half the card's `sms` SMs; 2 where
    that gives 1 and two blocks a frame still fit the SMs; at least 1. A
    power of two divides the frame's 65536 values. On an NVIDIA H100 80GB
    HBM3 (132 SMs) it is 16 at B <= 4, 8 at B=8, 4 at B=16, 2 from B=17 to
    66 and 1 past that: the fastest size of a sweep over B = 1, 4, 8, 16,
    32, 64 (chip_smoke.py's phase ccc_range, PERF.md), where more blocks
    than half the SMs ran slower at every batch but B=64."""
    cluster = 1
    while 2 * cluster <= largest and batch * 2 * cluster <= sms // 2:
        cluster *= 2
    if cluster == 1 and largest >= 2 and 2 * batch <= sms:
        cluster = 2
    return cluster


@functools.lru_cache(maxsize=64)
def _argmax_card(index: int, code: int, vec: bool) -> Tuple[int, int]:
    """The SM count of CUDA device `index` and the largest cluster of kernel
    I that can be resident there for the dtype code and load width."""
    size = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = kernels.LIBRARY.get().isp_ccc_argmax_cluster_limit(code, int(vec),
                                                                 ctypes.byref(size))
    if err != 0:
        raise RuntimeError(f"{kernels.CCC_ARGMAX.name}: CUDA error {err} querying the "
                           f"resident cluster size")
    return torch.cuda.get_device_properties(index).multi_processor_count, size.value


def response_argmax_cuda(response: torch.Tensor, *, cluster: int = 0) -> torch.Tensor:
    """Kernel I: response_argmax_plain of a contiguous CUDA [B, 256, 256]
    tensor of any dtype in ARGMAX_DTYPES, [B, 2] int32; one launch, a
    cluster of `cluster` blocks a frame (0: argmax_cluster's choice for the
    batch on this card; 1, 2, 4, 8 or 16 forces a size)."""
    if response.dtype not in ARGMAX_DTYPES:
        raise ValueError(f"response: expected one of {tuple(ARGMAX_DTYPES)}, got "
                         f"{response.dtype}")
    kernels.check_cuda(response, "response", response.dtype)
    if response.dim() != 3 or tuple(response.shape[1:]) != (HIST_N, HIST_N):
        raise ValueError(f"response: expected [B, 256, 256], got {tuple(response.shape)}")
    if cluster not in (0, 1, 2, 4, 8, MAX_ARGMAX_CLUSTER):
        raise ValueError(f"cluster: expected 0, 1, 2, 4, 8 or 16, got {cluster}")
    uv = torch.empty((response.shape[0], 2), dtype=torch.int32, device=response.device)
    code = ARGMAX_DTYPES[response.dtype]
    frame_bytes = HIST_N * HIST_N * response.element_size()
    for s, n in kernels.batch_runs(response.shape[0]):  # the grid's y is the frame
        ptr = response.data_ptr() + s * frame_bytes
        size = cluster
        if not size:
            sms, largest = _argmax_card(response.device.index, code, ptr % 16 == 0)
            size = argmax_cluster(n, sms, largest)
        with torch.cuda.device(response.device):
            kernels.CCC_ARGMAX.launch(ptr, uv.data_ptr() + 8 * s, n, code, size,
                                      kernels.stream_handle(response))
    return uv


def response_argmax(response: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """[..., 256, 256] responses -> the first-occurrence peak [..., 2]
    int32 (x=col, y=row): kernel I on a CUDA tensor, the plain version on a
    CPU tensor or with plain=True."""
    if plain or response.device.type == "cpu":
        return response_argmax_plain(response)
    lead = tuple(response.shape[:-2])
    flat = response.reshape((-1, HIST_N, HIST_N)).contiguous()
    return response_argmax_cuda(flat).reshape(lead + (2,))


@functools.lru_cache(maxsize=8)
def _exp_tab_on(uv0: float, device: str) -> torch.Tensor:
    """exp_table(uv0) on `device`, uploaded once per (uv0, device)."""
    return torch.as_tensor(exp_table(uv0), device=device)


def gains_from_uv(uv_pos: torch.Tensor, uv0: float = UV0) -> torch.Tensor:
    """uv_pos [..., 2] int (x, y) -> [..., 3] float32 BGR gains
    (ccc.cpp:342-381; z forced to 1, min-normalized), exp by libm (the
    reference's std::exp) as exp_table(uv0)."""
    return gains_from_uv_table(uv_pos, _exp_tab_on(float(uv0), str(uv_pos.device)))


def gains_from_uv_table(uv_pos: torch.Tensor, exp_tab: torch.Tensor) -> torch.Tensor:
    """gains_from_uv with the exp table given: exp_tab is exp_table(uv0)
    on uv_pos's device (the pipeline's params.ccc_exp_tab)."""
    gain_r = exp_tab[uv_pos[..., 0].long()]
    gain_b = exp_tab[uv_pos[..., 1].long()]
    gains = torch.stack([gain_b, torch.ones_like(gain_r), gain_r], dim=-1)
    return gains / gains.min(dim=-1, keepdim=True).values


def gains_from_offsets(lu: float, lv: float, uv0: float = UV0, *,
                       device="cuda") -> torch.Tensor:
    """Debug-UV-offset mode gains (setDebugUVOffset, ccc.cpp:349-357):
    Lu = lu - uv0, Lv = lv - uv0, exp by libm in f64 (the reference's
    std::exp), then [3] f32 BGR gains normalized by their min in f32."""
    gains = np.array([math.exp(lv - uv0), 1.0, math.exp(lu - uv0)], np.float32)
    return torch.as_tensor(gains / gains.min(), device=resolve_device(device))


def apply_gains(image: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """cv::multiply(image, Scalar(gain_b, gain_g, gain_r)) on [..., H, W, 3]
    u8 BGR images with gains [..., 3]: saturating round-half-even."""
    return round_u8(image.float() * gains[..., None, None, :])


def apply_gains_planes(planes, gains: torch.Tensor):
    """cv::multiply(image, Scalar(gain_b, gain_g, gain_r)) on a tuple of
    [B, H, W] u8 planes (BGR order) with gains [B, 3]: saturating
    round-half-even."""
    return tuple(
        round_u8(p.float() * gains[..., c, None, None])
        for c, p in enumerate(planes)
    )


# ---------------------------------------------------------------------------
# Kalman temporal consistency (ccc.cpp:180-206, 300-340)
# ---------------------------------------------------------------------------
#
# cv::KalmanFilter(2, 2, 0) with F = I, Q = I, H = I, R = 10*I and
# errorCovPost initialized to 0. The covariance stays p*I for a scalar p:
#     predict: p' = p + 1
#     gain:    k  = p' / (p' + 10)
#     update:  x  = x + k*(z - x);  p = (1 - k) * p'
# First measurement initializes x directly (statePost = z) and leaves p = 0.
# The estimate is truncated into the integer cv::Point before the gains.
# Eager torch rounds every op separately, so x + k*(z - x) keeps its two
# roundings.


@dataclass
class KalmanState:
    """Illuminant track; fields broadcast over leading axes."""

    x: torch.Tensor  # [..., 2] float32 state (col, row)
    p: torch.Tensor  # [...] float32 isotropic covariance
    initialized: torch.Tensor  # [...] bool


def kalman_init(batch_shape=(), uv_init=(HIST_N // 2, HIST_N // 2), *,
                device="cuda") -> KalmanState:
    """Fresh state (first_frame_=true). uv_init mirrors the reference's
    statePre/statePost prior of (height/2, width/2) (ccc.cpp:185-188)."""
    batch_shape = tuple(batch_shape)
    device = resolve_device(device)
    x = torch.tensor(tuple(uv_init), dtype=torch.float32, device=device)
    return KalmanState(
        x=x.expand(batch_shape + (2,)).clone(),
        p=torch.zeros(batch_shape, dtype=torch.float32, device=device),
        initialized=torch.zeros(batch_shape, dtype=torch.bool, device=device),
    )


def kalman_update(state: KalmanState, meas: torch.Tensor) -> Tuple[KalmanState, torch.Tensor]:
    """One filter step. meas: [..., 2] int32 measured peak (x, y).
    Returns (new_state, filtered uv [..., 2] int32)."""
    z = meas.float()
    p_pred = state.p + 1.0
    k = p_pred / (p_pred + 10.0)
    x_upd = state.x + k[..., None] * (z - state.x)
    p_upd = (1.0 - k) * p_pred
    init = state.initialized
    new_state = KalmanState(
        x=torch.where(init[..., None], x_upd, z),
        p=torch.where(init, p_upd, state.p),
        initialized=torch.ones_like(init),
    )
    return new_state, torch.trunc(new_state.x).to(torch.int32)


def kalman_scan(state: KalmanState, meas: torch.Tensor) -> Tuple[KalmanState, torch.Tensor]:
    """Advance one track through time-ordered measurements meas [T, ..., 2]
    (time along axis 0). Returns (state after frame T-1, uv [T, ..., 2])."""
    outs = []
    for t in range(meas.shape[0]):
        state, uv = kalman_update(state, meas[t])
        outs.append(uv)
    return state, torch.stack(outs)


# ---------------------------------------------------------------------------
# The track and the gains (kernel J)
# ---------------------------------------------------------------------------
#
# The chain's peaks uv [R, 2] are walked as tracks: the frame of track t at
# step s is row t * steps + s, tracks = prod(track_shape):
#   "cameras" mode     track_shape (B,), steps 1;
#   "sequence" mode    track_shape (),   steps B (also the mesh's gathered
#                      peaks of every frame);
#   camera-blocked     track_shape (n_cameras,), steps cam_b;
#   sequence
#   no Kalman          state None: the gains of the measured peaks.


def _check_layout(uv: torch.Tensor, track_shape, steps: int) -> int:
    """The number of tracks; raises unless uv [R, 2] holds one step of one
    track in each row."""
    tracks = math.prod(track_shape)
    if uv.dim() != 2 or uv.shape[-1] != 2 or tracks * steps != uv.shape[0]:
        raise ValueError(f"uv: {tracks} tracks of {steps} steps do not walk the rows of "
                         f"uv {tuple(uv.shape)}")
    return tracks


def track_plain(uv: torch.Tensor, exp_tab: torch.Tensor, state: Optional[KalmanState], *,
                track_shape=(), steps: int = 1) -> Tuple[Optional[KalmanState], torch.Tensor]:
    """Plain version of kernel J: the peaks uv [R, 2] int32 walked as
    tracks (see above), gathered as measurements [steps, *track_shape, 2]
    and filtered by kalman_scan (kalman_update for one step of a track a
    frame, "cameras" mode; no filter where state is None), then
    gains_from_uv_table. Returns (new state, the gains [R, 3] f32)."""
    tracks = _check_layout(uv, track_shape, steps)
    track_shape = tuple(track_shape)
    meas = uv.reshape(tracks, steps, 2).transpose(0, 1).reshape((steps,) + track_shape + (2,))
    if state is None:
        filtered = meas
    elif steps == 1 and track_shape:
        state, filtered = kalman_update(state, meas[0])
    else:
        state, filtered = kalman_scan(state, meas)
    filtered = filtered.reshape(steps, tracks, 2).transpose(0, 1).reshape(-1, 2)
    return state, gains_from_uv_table(filtered, exp_tab)


TRACK_CHUNK = 512  # kernel J's steps a stage of shared memory (csrc/ccc_track.cu)


def track_cuda(uv: torch.Tensor, exp_tab: torch.Tensor, state: Optional[KalmanState], *,
               track_shape=(), steps: int = 1) -> Tuple[Optional[KalmanState], torch.Tensor]:
    """Kernel J: track_plain's contract on CUDA tensors, one launch. Each
    field of the state has the shape () (one value for every track) or
    track_shape; the new state has the shapes track_plain gives it, in new
    tensors (the given one is left as it was)."""
    kernels.check_cuda(uv, "uv", torch.int32)
    kernels.check_cuda(exp_tab, "exp_tab", torch.float32, (HIST_N,))
    tracks = _check_layout(uv, track_shape, steps)
    track_shape = tuple(track_shape)
    dev = uv.device
    gains = torch.empty((uv.shape[0], 3), dtype=torch.float32, device=dev)
    x_in = p_in = init_in = x_out = p_out = init_out = None
    strides, new = [0] * 5, None
    if state is not None:
        # each field of shape () (one value for every track) or track_shape;
        # the new state's shapes are the plain form's: x a pair a track, p
        # broadcast against initialized, initialized as it was
        x, p, init = (t.contiguous() for t in (state.x, state.p, state.initialized))
        shapes = (tuple(x.shape[:-1]) if x.dim() else None, tuple(p.shape), tuple(init.shape))
        if any(s not in ((), track_shape) for s in shapes) or x.shape[-1:] != (2,):
            raise ValueError(f"state: expected fields of shape () or {track_shape} (x with a "
                             f"last axis of 2), got x {tuple(x.shape)}, p {shapes[1]}, "
                             f"initialized {shapes[2]}")
        for name, t, dtype in (("x", x, torch.float32), ("p", p, torch.float32),
                               ("initialized", init, torch.bool)):
            kernels.check_cuda(t, f"state.{name}", dtype)
        p_shape = track_shape if track_shape in shapes[1:] else ()
        new = KalmanState(x=torch.empty(track_shape + (2,), dtype=torch.float32, device=dev),
                          p=torch.empty(p_shape, dtype=torch.float32, device=dev),
                          initialized=torch.empty(shapes[2], dtype=torch.bool, device=dev))
        x_in, p_in, init_in = x.data_ptr(), p.data_ptr(), init.data_ptr()
        x_out, p_out, init_out = (t.data_ptr() for t in (new.x, new.p, new.initialized))
        strides = [int(s != ()) for s in shapes + (p_shape, shapes[2])]
    if tracks:
        with torch.cuda.device(dev):
            kernels.CCC_TRACK.launch(uv.data_ptr(), gains.data_ptr(), exp_tab.data_ptr(), x_in,
                                     p_in, init_in, *strides[:3], x_out, p_out, init_out,
                                     *strides[3:], tracks, steps, kernels.stream_handle(uv))
    return new, gains


def track_gains(uv: torch.Tensor, exp_tab: torch.Tensor, state: Optional[KalmanState] = None,
                *, track_shape=(), steps: int = 1,
                plain: bool = False) -> Tuple[Optional[KalmanState], torch.Tensor]:
    """The peaks uv [R, 2] int32 walked as tracks (the layouts above)
    through the Kalman filter (state None: none) to (new state, gains
    [R, 3]): kernel J on CUDA tensors, track_plain on CPU tensors or with
    plain=True."""
    kw = dict(track_shape=tuple(track_shape), steps=steps)
    if plain or uv.device.type == "cpu":
        return track_plain(uv, exp_tab, state, **kw)
    return track_cuda(uv.contiguous(), exp_tab.contiguous(), state, **kw)


# ---------------------------------------------------------------------------
# Image-level CCC ([..., H, W, 3] BGR frames, the reference package's API)
# ---------------------------------------------------------------------------


def log_chroma_histogram(image: torch.Tensor, bright_thr: float = 0.9,
                         dark_thr: float = 0.1, uv0: float = UV0, *,
                         plain: bool = False) -> torch.Tensor:
    """[..., H, W, 3] u8 BGR (the 360x270 working resize) -> [..., 256, 256]
    f32 histogram, each pixel weighing f32(1/(H*W)). The cuts are
    f32(255 * threshold) of the f64 products, as the reference package's
    static path; kernel B on a CUDA tensor (see
    log_chroma_histogram_planes)."""
    return log_chroma_histogram_rt(image, 255.0 * bright_thr, 255.0 * dark_thr, uv0,
                                   plain=plain)


def log_chroma_histogram_rt(image: torch.Tensor, bright_cut, dark_cut, uv0, *,
                            plain: bool = False) -> torch.Tensor:
    """log_chroma_histogram with the pre-scaled 255*threshold cuts and uv0
    given as f32 values (numbers or one-element tensors, narrowed to f32)."""
    lead, planes = image_planes(image)
    cuts = (float(np.float32(float(v))) for v in (bright_cut, dark_cut, uv0))
    hist = log_chroma_histogram_planes(*planes, *cuts, plain=plain)
    return hist.reshape(lead + (HIST_N, HIST_N))


def estimate_illuminant(image: torch.Tensor, model, bright_thr: float = 0.9,
                        dark_thr: float = 0.1, uv0: float = UV0, *,
                        plain: bool = False) -> torch.Tensor:
    """[..., H, W, 3] u8 BGR frames and a CCCModel (models/ccc_model.py) ->
    the response's first-occurrence peak [..., 2] int32 (x, y): on a CUDA
    tensor the 360x270 resize (kernel H), the histogram (B), the response
    (C) and the argmax (I); the plain versions on a CPU tensor or with
    plain=True."""
    hist = log_chroma_histogram(resize_linear_u8(image, SMALL_H, SMALL_W, plain=plain),
                                bright_thr, dark_thr, uv0, plain=plain)
    return response_argmax(ccc_response(hist, model.filt_dft_re, model.filt_dft_im,
                                        model.bias, plain=plain), plain=plain)


def ccc_balance_white(image: torch.Tensor, model, bright_thr: float = 0.9,
                      dark_thr: float = 0.1, state=None, uv0: float = UV0, *,
                      plain: bool = False):
    """Full CCC white balance on [..., H, W, 3] u8 BGR frames: the peak
    (estimate_illuminant), the Kalman step where `state` is given, and the
    gains (libm's exp, exp_table), the last two in kernel J on a CUDA
    tensor. Returns (balanced image, new state); with state=None the raw
    per-frame peak drives the gains and the new state is None."""
    uv = estimate_illuminant(image, model, bright_thr, dark_thr, uv0, plain=plain)
    lead = tuple(uv.shape[:-1])
    state, gains = track_gains(uv.reshape(-1, 2), _exp_tab_on(float(uv0), str(uv.device)),
                               state, track_shape=lead, plain=plain)
    return apply_gains(image, gains.reshape(lead + (3,))), state
