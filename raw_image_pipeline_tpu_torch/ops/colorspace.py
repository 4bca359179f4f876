"""Color-space conversions replicating OpenCV's u8 fixed-point arithmetic
(PyTorch port of raw_image_pipeline_tpu/ops/colorspace.py).

Needed for exact parity of two reference stages:
  * color enhancer: BGR -> HSV -> gain multiply -> BGR
    (reference: modules/color_enhancer.cpp:38-47)
  * vignetting: BGR -> Lab, scale L, Lab -> BGR
    (reference: modules/vignetting_correction.cpp:68-93)

The host tables (HSV division tables, the softfloat cbrt and the Lab
linearize/cbrt tables, the Lab->BGR y/ify/inverse-gamma tables and the
coefficients) are copied verbatim from the reference package and held equal
to the originals by tests/test_torch_ops.py. On the device every table is
applied as a gather of its exact values; the integer arithmetic around them
is the reference package's, op for op. HSV->BGR keeps the f32 chain with
the Dekker-emulated single-rounding fma, in both of cv2's row kernels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from raw_image_pipeline_tpu_torch.ops.common import descale, fma_f32

# ---------------------------------------------------------------------------
# Host tables (verbatim copies)
# ---------------------------------------------------------------------------

_HSV_SHIFT = 12


def _build_hsv_tables():
    sdiv = np.zeros(256, np.int32)
    hdiv = np.zeros(256, np.int32)
    v = np.arange(1, 256)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / v).astype(np.int32)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * v)).astype(np.int32)
    return sdiv, hdiv


_SDIV_TAB, _HDIV_TAB = _build_hsv_tables()

_SECTOR_DATA = (
    (1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3), (2, 1, 0)
)


_LAB_SHIFT = 12
_GAMMA_SHIFT = 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_CBRT_TAB_SIZE = 3072
_WHITEPT = (0.950456, 1.0, 1.088754)
_XYZ_COEF = (
    0.412453, 0.357580, 0.180423,
    0.212671, 0.715160, 0.072169,
    0.019334, 0.119193, 0.950227,
)


def _softfloat_cbrt_f32(xbits: np.ndarray) -> np.ndarray:
    """Bit-exact replica of OpenCV's cv::cbrt(softfloat) (host, init time).

    Reverse-engineered from libopencv_core 4.6 (f32_cbrt): cv::cubeRoot's
    quartic rational polynomial evaluated in IEEE f64 on the fraction
    (f32 bits split so fr in [0.125, 1)), then the f64 quotient is
    converted to f32 by mantissa TRUNCATION (bits >> 29) with the result
    exponent rebuilt as (ex - shx)/3 — not a rounded conversion. Verified
    equal on 200k random f32 bit patterns plus the whole LabCbrtTab_b
    domain. In/out are f32 bit patterns (uint32)."""
    xbits = np.asarray(xbits, np.uint32)
    ix = (xbits & 0x7FFFFFFF).astype(np.int64)
    sign = xbits & 0x80000000
    ex = (ix >> 23) - 127
    shx = np.fmod(ex, 3)  # C trunc semantics
    shx = shx - np.where(shx >= 0, 3, 0)
    ex_out = (ex - shx) // 3  # exact: (ex - shx) divisible by 3
    frbits = ((ix & ((1 << 23) - 1)) | ((shx + 127) << 23)).astype(np.uint32)
    fr = frbits.view(np.float32).astype(np.float64)
    num = (((45.2548339756803022511987494 * fr + 192.2798368355061050458134625) * fr
            + 119.1654824285581628956914143) * fr + 13.43250139086239872172837314) * fr \
        + 0.1636161226585754240958355063
    den = (((14.80884093219134573786480845 * fr + 151.9714051044435648658557668) * fr
            + 168.5254414101568283957668343) * fr + 33.9905941350215598754191872) * fr + 1.0
    q = num / den  # in [0.5, 1): cbrt of fr
    man = (q.view(np.uint64) >> np.uint64(29)) & np.uint64(0x7FFFFF)
    out = (sign.astype(np.uint64)
           | ((126 + ex_out).astype(np.uint64) << np.uint64(23)) | man)
    return np.where(ix == 0, xbits, out.astype(np.uint32))


def _build_lab_tables():
    # rounded (not truncated) gamma-table construction matches cv2 5.0's
    # 8u path exactly (verified against the table dumped from a live
    # libopencv_imgproc 4.6, itself exhaustively equal to cv2 5.0)
    i = np.arange(256, dtype=np.float64) / 255.0
    lin = np.where(i <= 0.04045, i / 12.92, ((i + 0.055) / 1.055) ** 2.4)
    gamma_tab = np.rint(255.0 * (1 << _GAMMA_SHIFT) * lin).astype(np.int32)

    # cbrt table: OpenCV builds this with softfloat (f32) arithmetic —
    # x = i * (1/2040) in f32, cbrt via the truncating polynomial above,
    # scaled by 2^15 in f32, cvRound = half-to-even. Two entries (49, 628)
    # land exactly on .5 in f32 and differ from a float64 build; matching
    # the construction op-for-op makes the whole BGR->Lab conversion
    # bit-exact vs cv2 on all 2^24 inputs (tests/test_pointwise_ops.py).
    f32 = np.float32
    scale = f32(1.0) / (f32(255) * f32(1 << _GAMMA_SHIFT))
    x = (scale * np.arange(_CBRT_TAB_SIZE, dtype=f32)).astype(f32)
    lthresh = (f32(216) / f32(24389)).astype(f32)
    lscale = (f32(841) / f32(108)).astype(f32)
    lbias = (f32(16) / f32(116)).astype(f32)
    # mulAdd(x, lscale, lbias): fused (single-rounding) via exact f64
    lin_branch = (x.astype(np.float64) * np.float64(lscale)
                  + np.float64(lbias)).astype(f32)
    cbrt_branch = _softfloat_cbrt_f32(x.view(np.uint32)).view(f32)
    fx = np.where(x < lthresh, lin_branch, cbrt_branch)
    scaled = (f32(1 << _LAB_SHIFT2) * fx).astype(f32)
    cbrt_tab = np.rint(scaled.astype(np.float64)).astype(np.int32)  # half-even

    coef = np.array(
        [
            np.rint(_XYZ_COEF[j] * (1 << _LAB_SHIFT) / _WHITEPT[j // 3])
            for j in range(9)
        ],
        np.int32,
    )
    return gamma_tab, cbrt_tab, coef


_GAMMA_TAB, _CBRT_TAB, _LAB_COEF = _build_lab_tables()

_LAB2_BASE = 1 << 14
_LAB2_MIN_AB = -8145
_LAB2_AB_MAX = _LAB2_BASE * 9 // 4 + _LAB2_MIN_AB - 1


def _lab2_yf_tables():
    f = np.float32
    i = np.arange(256)
    li = (i * 100 / f(255)).astype(f)
    lthresh = f(0.008856) * f(903.3)
    ylo = np.rint((_LAB2_BASE * (li / f(903.3))).astype(f))
    ifylo = np.rint(
        (_LAB2_BASE * (f(7.787) * (li / f(903.3)) + f(16.0 / 116.0))).astype(f)
    )
    fy = ((li + 16) / f(116)).astype(f)
    ifyhi = np.rint((_LAB2_BASE * fy).astype(f))
    yhi = np.rint((_LAB2_BASE * fy * fy * fy).astype(f))
    lo = li <= lthresh
    y = np.where(lo, ylo, yhi).astype(np.int32)
    ify = np.where(lo, ifylo, ifyhi).astype(np.int32)
    return y, ify


_LAB2_Y_TAB, _LAB2_IFY_TAB = _lab2_yf_tables()


def _lab2_inv_gamma_table():
    f = np.float32
    i = np.arange(8192)
    x = (i / f(4096)).astype(f)
    g = np.where(
        x <= f(0.0031308),
        x * f(12.92),
        f(1.055) * np.power(x, f(1 / 2.4), dtype=f) - f(0.055),
    )
    return np.clip(np.rint((f(255) * g).astype(f)), 0, 255).astype(np.int32)


_LAB2_INV_GAMMA_TAB = _lab2_inv_gamma_table()


def _lab2_coeffs():
    M = (
        (3.240479, -1.53715, -0.498535),
        (-0.969256, 1.875991, 0.041556),
        (0.055648, -0.204043, 1.057311),
    )
    return [
        [int(np.rint(np.float64(4096 * M[r][c] * _WHITEPT[c]))) for c in range(3)]
        for r in range(3)
    ]


_LAB2_COEF = _lab2_coeffs()


# ---------------------------------------------------------------------------
# Device conversions
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _tables_on(device: str):
    """The exact host tables as int32 tensors on `device`."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    return {
        "sdiv": t(_SDIV_TAB), "hdiv": t(_HDIV_TAB),
        "lab_gamma": t(_GAMMA_TAB), "cbrt": t(_CBRT_TAB),
        "y": t(_LAB2_Y_TAB), "ify": t(_LAB2_IFY_TAB),
        "inv_gamma": t(_LAB2_INV_GAMMA_TAB),
    }


def _f32(x: float) -> float:
    """x narrowed to f32 (exact in any f32 op it then enters)."""
    return float(np.float32(x))


def bgr_to_hsv_planes(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor):
    """cv::cvtColor(COLOR_BGR2HSV) for u8 planes (hsv_shift = 12):
    three u8 planes (b, g, r) in, three u8 planes (h, s, v) out."""
    tabs = _tables_on(str(b.device))
    b, g, r = b.to(torch.int32), g.to(torch.int32), r.to(torch.int32)
    v = torch.maximum(torch.maximum(b, g), r)
    mn = torch.minimum(torch.minimum(b, g), r)
    diff = v - mn
    s = (diff * tabs["sdiv"][v.long()] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h_num = torch.where(
        v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff)
    )
    h = (h_num * tabs["hdiv"][diff.long()] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = h + torch.where(h < 0, 180, 0)
    return h.to(torch.uint8), s.to(torch.uint8), v.to(torch.uint8)


def _hsv_to_bgr_planes_core(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor,
                            scalar_kernel: bool):
    """Shared HSV->BGR float chain. cv2 5.0's two row kernels differ ONLY
    in the final *255 conversion: the SIMD kernel (32-px vector steps)
    TRUNCATES, the scalar kernel (the `width % 32` tail of every row, or
    whole rows below 32 px) rounds via saturate_cast/cvRound (half-even).
    The tab entries are identical single-rounding fmas (Dekker-emulated)."""
    h = h.float()
    s = s.float() * _f32(1.0 / 255.0)
    v = v.float() * _f32(1.0 / 255.0)

    hf = h * _f32(6.0 / 180.0)
    sector = torch.floor(hf).to(torch.int32)
    ff = hf - sector.float()
    sector = sector % 6

    tab = (
        v,
        v * (1.0 - s),
        v * fma_f32(-s, ff, 1.0),
        v * fma_f32(-s, 1.0 - ff, 1.0),  # (1-ff) exact by Sterbenz
    )

    def pick(channel: int) -> torch.Tensor:
        out = tab[_SECTOR_DATA[0][channel]]
        for sec in range(1, 6):
            out = torch.where(sector == sec, tab[_SECTOR_DATA[sec][channel]], out)
        prod = out * 255.0
        if scalar_kernel:
            return torch.clamp(torch.round(prod), 0, 255).to(torch.uint8)
        return torch.floor(prod).to(torch.uint8)

    return pick(0), pick(1), pick(2)


def hsv_to_bgr_planes(h, s, v):
    """cv2 5.0's SIMD row kernel (final *255 product truncated)."""
    return _hsv_to_bgr_planes_core(h, s, v, scalar_kernel=False)


def hsv_to_bgr_planes_scalar(h, s, v):
    """cv2 5.0's scalar row kernel (final *255 product rounded)."""
    return _hsv_to_bgr_planes_core(h, s, v, scalar_kernel=True)


def bgr_to_lab_planes(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor,
                      gamma_tab: torch.Tensor | None = None):
    """cv::cvtColor(COLOR_BGR2Lab) for u8 planes (integer-table path).

    gamma_tab: optional int32 [256] replacement for the sRGB-linearize
    table — the pipeline passes the gamma stage composed into it
    (ops/vignetting.composed_gamma_lab_table) when gamma feeds straight
    into vignetting."""
    tabs = _tables_on(str(b.device))
    C = [int(c) for c in _LAB_COEF]
    gt = tabs["lab_gamma"] if gamma_tab is None else gamma_tab
    b, g, r = gt[b.long()], gt[g.long()], gt[r.long()]

    def cbrt_tab(x):
        return tabs["cbrt"][torch.clamp(x, 0, _CBRT_TAB_SIZE - 1).long()]

    fX = cbrt_tab(descale(r * C[0] + g * C[1] + b * C[2], _LAB_SHIFT))
    fY = cbrt_tab(descale(r * C[3] + g * C[4] + b * C[5], _LAB_SHIFT))
    fZ = cbrt_tab(descale(r * C[6] + g * C[7] + b * C[8], _LAB_SHIFT))

    l_scale = (116 * 255 + 50) // 100
    l_shift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    L = descale(l_scale * fY + l_shift, _LAB_SHIFT2)
    a = descale(500 * (fX - fY) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    bb = descale(200 * (fY - fZ) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    clip = lambda x: torch.clamp(x, 0, 255).to(torch.uint8)
    return clip(L), clip(a), clip(bb)


def _lab2_ab_to_xz(i: torch.Tensor) -> torch.Tensor:
    """abToXZ_b table entries computed in closed form from the index: the
    linear branch with C-truncated division, the cubic branch (selected
    only for i > 3390, where the truncating /BASE divisions are exact
    shifts)."""
    i = torch.clamp(i, _LAB2_MIN_AB, _LAB2_AB_MAX)
    lin = torch.div(i * 108, 841, rounding_mode="trunc") - 290
    q = (i * i) >> 14
    cub = (q * i) >> 14
    return torch.where(i <= 3390, lin, cub)


def lab_to_bgr_planes(L: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """cv2 5.0's Lab2RGBinteger fixed-point path for u8 planes."""
    tabs = _tables_on(str(L.device))
    L, a, b = L.long(), a.to(torch.int32), b.to(torch.int32)
    y = tabs["y"][L]
    ify = tabs["ify"][L]
    adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * _LAB2_BASE // 500
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - 128 * _LAB2_BASE // 200 + 1
    x = _lab2_ab_to_xz(ify + adiv)
    z = _lab2_ab_to_xz(ify - bdiv)
    C = _LAB2_COEF

    def channel(row: int) -> torch.Tensor:
        s = C[row][0] * x + C[row][1] * y + C[row][2] * z
        idx = torch.clamp((s + 8192) >> 14, 0, 8191)
        return tabs["inv_gamma"][idx.long()].to(torch.uint8)

    return channel(2), channel(1), channel(0)


# ---------------------------------------------------------------------------
# [..., H, W, 3] frames (the reference package's image-level entry points)
# ---------------------------------------------------------------------------


def _channels(image: torch.Tensor):
    if image.dim() < 3 or image.shape[-1] != 3:
        raise ValueError(f"image: expected [..., H, W, 3], got {tuple(image.shape)}")
    return image[..., 0], image[..., 1], image[..., 2]


def bgr_to_hsv_u8(image: torch.Tensor) -> torch.Tensor:
    """cv::cvtColor(COLOR_BGR2HSV) on [..., H, W, 3] u8 frames."""
    return torch.stack(bgr_to_hsv_planes(*_channels(image)), dim=-1)


def hsv_to_bgr_u8(image: torch.Tensor) -> torch.Tensor:
    """cv::cvtColor(COLOR_HSV2BGR) on [..., H, W, 3] u8 frames (cv2 5.0's
    SIMD row kernel throughout, as the reference package's function)."""
    return torch.stack(hsv_to_bgr_planes(*_channels(image)), dim=-1)


def bgr_to_lab_u8(image: torch.Tensor) -> torch.Tensor:
    """cv::cvtColor(COLOR_BGR2Lab) on [..., H, W, 3] u8 frames."""
    return torch.stack(bgr_to_lab_planes(*_channels(image)), dim=-1)


def lab_to_bgr_u8(image: torch.Tensor) -> torch.Tensor:
    """cv::cvtColor(COLOR_Lab2BGR) on [..., H, W, 3] u8 frames."""
    return torch.stack(lab_to_bgr_planes(*_channels(image)), dim=-1)


def bgr_to_gray_f32(image: torch.Tensor) -> torch.Tensor:
    """cv::cvtColor(COLOR_BGR2GRAY) on CV_32F: [..., H, W, 3] -> [..., H, W]
    f32, the plain chain (r*.299 + g*.587) + b*.114 with every op rounded
    in f32 (XLA:CPU contracts the reference package's into two fmas)."""
    x = image.to(torch.float32)
    return (x[..., 2] * _f32(0.299) + x[..., 1] * _f32(0.587)) + x[..., 0] * _f32(0.114)
