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
the same numbers; each table is uploaded once per device. The histogram and
the response each have a plain version here and a hand-written CUDA kernel
(kernel B, csrc/ccc_histogram.cu; kernel C, csrc/ccc_response.cu);
`log_chroma_histogram` and `ccc_response` launch the kernel for a CUDA
tensor and run the plain version for a CPU one.

The chain works on planes; the image-level API of the reference package
(`log_chroma_histogram_image`, `estimate_illuminant`, `gains_from_offsets`,
`apply_gains`, `ccc_balance_white` on [..., H, W, 3] BGR frames, which
tools/ccc_tune.py uses) splits the frames into planes and goes through the
same functions.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from raw_image_pipeline_tpu_torch import kernels
from raw_image_pipeline_tpu_torch.ops.common import resolve_device, round_u8
from raw_image_pipeline_tpu_torch.ops.resize import resize_linear_u8_plane

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


def _pixel_weight(h: int, w: int) -> float:
    return float(np.float32(1.0 / (h * w)))  # narrowed as ccc.py:206


def log_chroma_histogram_plain(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor,
                               bright_cut: float, dark_cut: float,
                               uv0: float) -> torch.Tensor:
    """Plain version of kernel B: three [B, h, w] u8 planes -> [B, 256, 256]
    f32 histogram, the integer counts of the valid pixels' (u, v) bins
    times f32(1/(h*w)) once."""
    nb = b.shape[0]
    counts = torch.bincount(log_chroma_bins(b, g, r, bright_cut, dark_cut, uv0),
                            minlength=nb * HIST_N * HIST_N)
    return counts.float().view(nb, HIST_N, HIST_N) * _pixel_weight(*b.shape[-2:])


def log_chroma_histogram_cuda(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor,
                              bright_cut: float, dark_cut: float,
                              uv0: float) -> torch.Tensor:
    """Kernel B: same contract as log_chroma_histogram_plain, CUDA tensors,
    one launch and no other stream operation."""
    for name, t in (("b", b), ("g", g), ("r", r)):
        kernels.check_cuda(t, name, torch.uint8, b.shape)
    if b.dim() != 3:
        raise ValueError(f"planes: expected [B, h, w], got {tuple(b.shape)}")
    nb, h, w = b.shape
    kernels.check_batch(nb, "planes")
    if h * w > HIST_KERNEL_MAX_PIXELS:
        raise ValueError(f"planes: kernel B takes frames of at most {HIST_KERNEL_MAX_PIXELS} "
                         f"pixels, got {h}x{w}")
    hist = torch.empty((nb, HIST_N, HIST_N), dtype=torch.float32, device=b.device)
    if nb:
        tab = _log_tab_on(str(b.device))
        with torch.cuda.device(b.device):
            kernels.CCC_HISTOGRAM.launch(
                b.data_ptr(), g.data_ptr(), r.data_ptr(), tab.data_ptr(), hist.data_ptr(),
                nb, h * w, bright_cut, dark_cut, uv0, _pixel_weight(h, w),
                kernels.stream_handle(b),
            )
    return hist


def log_chroma_histogram(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor,
                         bright_cut: float, dark_cut: float, uv0: float,
                         plain: bool = False) -> torch.Tensor:
    """[B, h, w] u8 B/G/R planes (the working resize) -> [B, 256, 256] f32
    histogram. Kernel B on CUDA tensors; the plain version on CPU tensors
    or with plain=True."""
    if plain or b.device.type == "cpu":
        return log_chroma_histogram_plain(b, g, r, bright_cut, dark_cut, uv0)
    return log_chroma_histogram_cuda(b.contiguous(), g.contiguous(), r.contiguous(),
                                     bright_cut, dark_cut, uv0)


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
                      filt_dft_im: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Kernel C: same contract as ccc_response_plain, CUDA tensors."""
    kernels.check_cuda(hist, "hist", torch.float32)
    if hist.dim() != 3 or tuple(hist.shape[1:]) != (HIST_N, HIST_N):
        raise ValueError(f"hist: expected [B, 256, 256], got {tuple(hist.shape)}")
    for name, t in (("filt_dft_re", filt_dft_re), ("filt_dft_im", filt_dft_im),
                    ("bias", bias)):
        kernels.check_cuda(t, name, torch.float32, (HIST_N, HIST_N))
    Fr, Fi = _dft_on(str(hist.device))
    nb = hist.shape[0]
    kernels.check_batch(nb, "hist")
    out = torch.empty_like(hist)
    scratch = torch.empty((4,) + tuple(hist.shape), dtype=torch.float32,
                          device=hist.device)
    if nb:
        with torch.cuda.device(hist.device):
            kernels.CCC_RESPONSE.launch(
                hist.data_ptr(), Fr.data_ptr(), Fi.data_ptr(),
                filt_dft_re.data_ptr(), filt_dft_im.data_ptr(), bias.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), nb,
                kernels.stream_handle(hist),
            )
    return out


def ccc_response(hist: torch.Tensor, filt_dft_re: torch.Tensor,
                 filt_dft_im: torch.Tensor, bias: torch.Tensor,
                 plain: bool = False) -> torch.Tensor:
    """[B, 256, 256] f32 -> [B, 256, 256] f32 response. Kernel C on CUDA
    tensors; the plain version on CPU tensors or with plain=True."""
    if plain or hist.device.type == "cpu":
        return ccc_response_plain(hist, filt_dft_re, filt_dft_im, bias)
    return ccc_response_cuda(hist.contiguous(), filt_dft_re, filt_dft_im, bias)


def response_argmax(response: torch.Tensor) -> torch.Tensor:
    """Row-major first-occurrence argmax -> [..., 2] int32 (x=col, y=row),
    matching cv::minMaxLoc's maxLoc Point convention (ccc.cpp:295).
    torch.argmax returns the first maximal index."""
    lead = response.shape[:-2]
    idx = torch.argmax(response.reshape(lead + (-1,)), dim=-1)
    return torch.stack([idx % HIST_N, idx // HIST_N], dim=-1).to(torch.int32)


def gains_from_uv(uv_pos: torch.Tensor, exp_tab: torch.Tensor) -> torch.Tensor:
    """uv_pos [..., 2] int (x, y) -> [..., 3] float32 BGR gains
    (ccc.cpp:342-381; z forced to 1, min-normalized). exp_tab is
    exp_table(uv0) on the device."""
    gain_r = exp_tab[uv_pos[..., 0].long()]
    gain_b = exp_tab[uv_pos[..., 1].long()]
    gains = torch.stack([gain_b, torch.ones_like(gain_r), gain_r], dim=-1)
    return gains / gains.min(dim=-1, keepdim=True).values


def gains_from_offsets(lu: float, lv: float, uv0: float = UV0, device="cuda") -> torch.Tensor:
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


def kalman_init(batch_shape=(), device="cuda") -> KalmanState:
    """Fresh state (first_frame_=true): the prior (height/2, width/2) of the
    reference's statePre/statePost (ccc.cpp:185-188)."""
    batch_shape = tuple(batch_shape)
    device = resolve_device(device)
    x = torch.tensor((HIST_N // 2, HIST_N // 2), dtype=torch.float32, device=device)
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
# Image-level CCC ([..., H, W, 3] BGR frames, as ccc_tune holds them)
# ---------------------------------------------------------------------------


def _image_planes(image: torch.Tensor):
    """[..., H, W, 3] u8 -> (the leading shape, three [N, H, W] planes)."""
    if image.dim() < 3 or image.shape[-1] != 3:
        raise ValueError(f"image: expected [..., H, W, 3], got {tuple(image.shape)}")
    lead = tuple(image.shape[:-3])
    flat = image.reshape((-1,) + tuple(image.shape[-3:]))
    return lead, tuple(flat[..., c].contiguous() for c in range(3))


def _histogram_cuts(bright_thr: float, dark_thr: float, uv0: float):
    """The histogram's runtime values: f32(255 * threshold) of the f64
    products, and uv0 narrowed to f32."""
    return (float(np.float32(255.0 * bright_thr)), float(np.float32(255.0 * dark_thr)),
            float(np.float32(uv0)))


def log_chroma_histogram_image(image: torch.Tensor, bright_thr: float = 0.9,
                               dark_thr: float = 0.1, uv0: float = UV0) -> torch.Tensor:
    """[..., H, W, 3] u8 BGR (the 360x270 working resize) -> [..., 256, 256]
    f32 histogram: the reference package's image-level log_chroma_histogram,
    through the planar one (kernel B on a CUDA tensor)."""
    lead, planes = _image_planes(image)
    hist = log_chroma_histogram(*planes, *_histogram_cuts(bright_thr, dark_thr, uv0))
    return hist.reshape(lead + (HIST_N, HIST_N))


def estimate_illuminant(image: torch.Tensor, model, bright_thr: float = 0.9,
                        dark_thr: float = 0.1, uv0: float = UV0) -> torch.Tensor:
    """[..., H, W, 3] u8 BGR frames and a CCCModel (models/ccc_model.py) ->
    the response's first-occurrence peak [..., 2] int32 (x, y): the
    360x270 resize of each plane, the histogram (kernel B) and the response
    (kernel C) on a CUDA tensor, the argmax."""
    lead, planes = _image_planes(image)
    small = [resize_linear_u8_plane(p, SMALL_H, SMALL_W) for p in planes]
    hist = log_chroma_histogram(*small, *_histogram_cuts(bright_thr, dark_thr, uv0))
    filt = (torch.as_tensor(np.asarray(a, np.float32), device=image.device)
            for a in (model.filt_dft_re, model.filt_dft_im, model.bias))
    return response_argmax(ccc_response(hist, *filt)).reshape(lead + (2,))


def ccc_balance_white(image: torch.Tensor, model, bright_thr: float = 0.9,
                      dark_thr: float = 0.1, state=None, uv0: float = UV0):
    """Full CCC white balance on [..., H, W, 3] u8 BGR frames: the peak
    (estimate_illuminant), the Kalman step where `state` is given, and the
    gains (libm's exp, exp_table). Returns (balanced image, new state);
    with state=None the raw per-frame peak drives the gains and the new
    state is None."""
    uv = estimate_illuminant(image, model, bright_thr, dark_thr, uv0)
    if state is not None:
        state, uv = kalman_update(state, uv)
    gains = gains_from_uv(uv, torch.as_tensor(exp_table(uv0), device=image.device))
    return apply_gains(image, gains), state
