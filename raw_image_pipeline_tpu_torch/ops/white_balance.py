"""Statistical white-balance methods: simple, grey_world, pca (PyTorch port
of raw_image_pipeline_tpu/ops/white_balance.py; "learned" is in
ops/learned_wb.py, "ccc" in ops/ccc.py).

Every method is a per-frame reduction followed by a per-pixel map, on the
three [B, H, W] u8 planes (b, g, r) the pipeline carries (the `*_planes`
cores); `balance_white_simple`, `_grey_world`, `_pca` and `_learned` take
[..., H, W, 3] frames, as the reference package's, and flatten the leading
dims into the planes' batch. The statistics
are per channel and the positional rules index the flattened H*W frame, so
the planar form computes what the reference package's packed form does.

The rule that governs them is exactness, on every device:
  * counts and sums are int64 (exact at every frame size); a single cast
    to f32 rounds to nearest-even on the CPU and on CUDA, as the reference
    package's u32 -> f32 cast does;
  * f32 formulas are separate eager ops, each rounding once (no fused op);
  * a per-pixel map that depends only on the u8 value and per-frame
    scalars is evaluated over the 256 values, then gathered — the same
    numbers as evaluating it per pixel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from raw_image_pipeline_tpu_torch.ops.common import fma_f32, image_planes, planes_image, round_u8

Planes = tuple  # (b, g, r), each [B, H, W] uint8


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


def balance_white_simple_planes(planes: Planes, p: float) -> Planes:
    """cv::xphoto::SimpleWB (setP(p)), 8u, default ranges. Per channel: walk
    the 256-bin histogram from each end while the cumulative count is
    strictly below the f32 target (p*n)/100 (stop bins p1, p2), then stretch
    out = cvRound(fma(v, alpha32, beta32)) with a single rounding."""
    h, w = planes[0].shape[-2:]
    dev = planes[0].device
    hist = channel_histograms(planes)  # [B, 3, 256]
    target = float(np.float32(np.float32(p) * np.float32(h * w)) / np.float32(100.0))
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
    lut = round_u8(fma_f32(x[None, None, :], alpha[..., None], beta[..., None]))  # [B, 3, 256]
    return tuple(_lut_apply(pl, lut[:, c]) for c, pl in enumerate(planes))


# ---------------------------------------------------------------------------
# grey_world (cv::xphoto::GrayworldWB)
# ---------------------------------------------------------------------------

def apply_gains_8p8(planes: Planes, gains: torch.Tensor) -> Planes:
    """(v * gain) >> 8, saturated, with int32 gains [B, 3] in 8.8 fixed
    point (the grey-world and learned methods' truncating descale)."""
    return tuple(
        torch.clamp((pl.to(torch.int32) * gains[:, c, None, None]) >> 8, 0, 255).to(torch.uint8)
        for c, pl in enumerate(planes)
    )


def balance_white_grey_world_planes(planes: Planes, thresh: float) -> Planes:
    """cv::xphoto::GrayworldWB: integer saturation mask
    (mx-mn)*255 <= cvRound(thr*255)*mx, integer channel sums, gains toward
    the minimum positive sum, rint(f32(smin)/f32(s)*256), applied as
    (v*gain) >> 8."""
    b, g, r = (pl.to(torch.int32) for pl in planes)
    mx = torch.maximum(torch.maximum(b, g), r)
    mn = torch.minimum(torch.minimum(b, g), r)
    t255 = int(np.rint(np.float32(thresh) * 255))  # cvRound at init
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
    sums = torch.stack(
        [torch.where(m, c, 0).to(torch.int64).sum(dim=(-2, -1)) for c in (b, g, r)], dim=-1
    )  # [B, 3] exact
    # smin over POSITIVE sums only; a zero-sum channel gets gain 0
    big = torch.iinfo(torch.int64).max
    smin = torch.where(sums > 0, sums, big).min(dim=-1, keepdim=True).values
    gi = torch.round(smin.to(torch.float32) / sums.to(torch.float32) * 256.0).to(torch.int32)
    gains = torch.where(sums > 0, gi, 0)
    return apply_gains_8p8(planes, gains)


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


def _pca_solve(c: torch.Tensor, sg: torch.Tensor, mg: torch.Tensor):
    """Eigen compute_inverse_size2 in f32 on the channel's exact sums, op
    for op as the reference (every product and sum rounds on its own)."""
    ci = c.to(torch.int64)
    s2 = (ci * ci).sum(dim=(-2, -1)).to(torch.float32)  # rn_f32(sum c^2)
    s = ci.sum(dim=(-2, -1)).to(torch.float32)
    m = c.amax(dim=(-2, -1)).to(torch.float32)
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


def balance_white_pca_planes(planes: Planes) -> Planes:
    """The reference PCA method: per channel c in (b, r), the 2x2 solve
    against the green channel's sum and max, then the per-pixel map
    cvRound(min(x0*c^2 + x1*c, 255)) as a 256-entry table; g passes through.

    A constant channel (det == 0) gives NaN coefficients; the reference's
    THRESH_TRUNC then runs 4-wide minps (NaN -> the second operand, 255)
    with a scalar tail that keeps NaN, and convertTo saturates NaN to 0:
    255 everywhere but the last (H*W) % 4 pixels of the flattened frame,
    which are 0."""
    b, g, r = planes
    h, w = g.shape[-2:]
    gi = g.to(torch.int64)
    sg = gi.sum(dim=(-2, -1)).to(torch.float32)
    mg = g.amax(dim=(-2, -1)).to(torch.float32)
    nan_pattern = torch.where(_flat_body_mask(h, w, 4, g.device), 255, 0).to(torch.uint8)

    def corrected(c: torch.Tensor) -> torch.Tensor:
        x0, x1 = _pca_solve(c, sg, mg)
        out = _lut_apply(c, pca_exact_lut(x0, x1))
        bad = torch.isnan(x0) | torch.isnan(x1)  # [B]
        return torch.where(bad[:, None, None], nan_pattern, out)

    return corrected(b), g, corrected(r)


# ---------------------------------------------------------------------------
# [..., H, W, 3] frames (the reference package's entry points)
# ---------------------------------------------------------------------------


def balance_white_simple(image: torch.Tensor, p: float) -> torch.Tensor:
    """cv::xphoto::SimpleWB on [..., H, W, 3] u8 BGR frames."""
    lead, planes = image_planes(image)
    return planes_image(balance_white_simple_planes(planes, p), lead)


def balance_white_grey_world(image: torch.Tensor, thresh: float) -> torch.Tensor:
    """cv::xphoto::GrayworldWB on [..., H, W, 3] u8 BGR frames."""
    lead, planes = image_planes(image)
    return planes_image(balance_white_grey_world_planes(planes, thresh), lead)


def balance_white_pca(image: torch.Tensor) -> torch.Tensor:
    """The reference PCA method on [..., H, W, 3] u8 BGR frames."""
    lead, planes = image_planes(image)
    return planes_image(balance_white_pca_planes(planes), lead)


def balance_white_learned(image: torch.Tensor, thresh: float) -> torch.Tensor:
    """cv::xphoto::LearningBasedWB with the default model on [..., H, W, 3]
    u8 BGR frames (ops/learned_wb.balance_white_learned_model)."""
    from raw_image_pipeline_tpu_torch.ops.learned_wb import balance_white_learned_model

    return balance_white_learned_model(image, thresh)
