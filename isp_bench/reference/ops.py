"""The plain reference's per-pixel stages in eager PyTorch, each op
rounding on its own: a frozen copy of the plain formulas that reproduce
OpenCV's u8 arithmetic bit for bit. Planes are [B, H, W] u8 in B, G, R
order.

`ft` is the dtype of every floating-point step: torch.float32 as the
chain states it; the control passes torch.bfloat16, the precision below.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from isp_bench.reference import tables as T

F32 = torch.float32


def round_u8(x: torch.Tensor) -> torch.Tensor:
    """saturate_cast<uchar>(float): round half to even, then clamp."""
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def fma(a, b, c):
    """rnd(a*b + c) with one rounding, by Dekker's product and TwoSum in
    plain ops."""
    C = 4097.0
    ca = a * C
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = b * C
    bhi = cb - (cb - b)
    blo = b - bhi
    p = a * b
    err = (((ahi * bhi - p) + ahi * blo) + alo * bhi) + alo * blo
    s = p + c
    bb = s - p
    e2 = (p - (s - bb)) + (c - bb)
    return s + (e2 + err)


def on(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(a, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# cv::demosaicing, bilinear; cv::flip
# ---------------------------------------------------------------------------

# parity cell (row&1, col&1) of (R site, G in an R row, G in a B row, B
# site) for OpenCV's Bayer phase
_CELLS = {"rggb": ((0, 0), (0, 1), (1, 0), (1, 1)), "grbg": ((0, 1), (0, 0), (1, 1), (1, 0)),
          "gbrg": ((1, 0), (1, 1), (0, 0), (0, 1)), "bggr": ((1, 1), (1, 0), (0, 1), (0, 0))}
# a ROS encoding's OpenCV code (COLOR_Bayer*2BGR) and the phase OpenCV reads
_PHASE = {"bayer_bggr8": "rggb", "bayer_gbrg8": "grbg", "bayer_grbg8": "gbrg",
          "bayer_rggb8": "bggr"}


def debayer(mosaic: torch.Tensor, encoding: str):
    """cv::demosaicing(COLOR_Bayer*2BGR) of [B, H, W] u8 with its 1-pixel
    border replication, then the reference CPU path's R<->B swap
    (debayer.cpp:49-52): three planes B, G, R."""
    p = F.pad(mosaic, (1, 1, 1, 1)).to(torch.int16)
    x = p[..., 1:-1, 1:-1]
    n, s = p[..., :-2, 1:-1], p[..., 2:, 1:-1]
    wv, e = p[..., 1:-1, :-2], p[..., 1:-1, 2:]
    v2 = (n + s + 1) >> 1
    h2 = (wv + e + 1) >> 1
    n4 = (n + s + wv + e + 2) >> 2
    d4 = (p[..., :-2, :-2] + p[..., :-2, 2:] + p[..., 2:, :-2] + p[..., 2:, 2:] + 2) >> 2
    h, w = mosaic.shape[-2:]
    row = (torch.arange(h, device=mosaic.device) & 1)[:, None]
    col = (torch.arange(w, device=mosaic.device) & 1)[None, :]
    r_site, g_r, g_b, b_site = ((row == a) & (col == b) for a, b in _CELLS[_PHASE[encoding]])
    g = torch.where(g_r | g_b, x, n4)
    r = torch.where(r_site, x, torch.where(g_r, h2, torch.where(g_b, v2, d4)))
    b = torch.where(b_site, x, torch.where(g_b, h2, torch.where(g_r, v2, d4)))

    def border(img):
        img = torch.cat([img[..., 1:2, :], img[..., 1:-1, :], img[..., -2:-1, :]], dim=-2)
        return torch.cat([img[..., :, 1:2], img[..., :, 1:-1], img[..., :, -2:-1]], dim=-1)

    bgr = tuple(border(torch.clamp(c, 0, 255)).to(torch.uint8) for c in (b, g, r))
    return bgr[::-1]


def flip(planes, angle: int):
    """cv::flip / cv::rotate of each [B, H, W] plane by 0, 90, 180 or 270."""
    if angle == 180:
        return tuple(torch.flip(p, dims=(-2, -1)) for p in planes)
    if angle == 90:
        return tuple(torch.flip(p.transpose(-2, -1), dims=(-1,)) for p in planes)
    if angle == 270:
        return tuple(torch.flip(p.transpose(-2, -1), dims=(-2,)) for p in planes)
    return tuple(planes)


# ---------------------------------------------------------------------------
# CCC (convolutional_color_constancy.cpp): resize, histogram, response,
# peak, gains
# ---------------------------------------------------------------------------


def resize(plane: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    """cv::resize(INTER_LINEAR) of [B, H, W] u8: horizontal taps in int32,
    OpenCV's truncating vertical pass."""
    (sx, sx2, a0, a1), (sy, sy2, b0, b1) = T.resize_tables(*plane.shape[-2:], dst_h, dst_w)
    dev = plane.device
    sx, sx2, sy, sy2 = (on(t, dev).long() for t in (sx, sx2, sy, sy2))
    a0, a1, b0, b1 = (on(t, dev, torch.int32) for t in (a0, a1, b0, b1))

    def horiz(rows):
        return (rows.index_select(-1, sx).to(torch.int32) * a0
                + rows.index_select(-1, sx2).to(torch.int32) * a1)

    s0 = horiz(plane.index_select(-2, sy)) >> 4
    s1 = horiz(plane.index_select(-2, sy2)) >> 4
    acc = (((b0[:, None] * s0) >> 16) + ((b1[:, None] * s1) >> 16) + 2) >> 2
    return torch.clamp(acc, 0, 255).to(torch.uint8)


def _round_half_away(x):
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def histogram(b, g, r, bright_cut: float, dark_cut: float, uv0: float, ft=F32):
    """The log-chroma histogram [B, 256, 256] of three small planes: the
    valid pixels' (u, v) bin counts, each pixel weighing f32(1/(h*w))."""
    nb, h, w = b.shape
    fb, fg, fr = b.to(ft), g.to(ft), r.to(ft)
    gray = (fr * T.GRAY_R + fg * T.GRAY_G) + fb * T.GRAY_B
    include = (gray <= bright_cut) & (gray > dark_cut)
    tab = on(T.LOG_TAB, b.device).to(ft)
    lb, lg, lr = tab[b.long()], tab[g.long()], tab[r.long()]
    valid = include & (b > 0) & (g > 0) & (r > 0)
    u = _round_half_away((lg - lr - uv0) * 64.0)
    v = _round_half_away((lg - lb - uv0) * 64.0)
    u = torch.where(valid, u, 0.0).clamp(0, T.HIST_N - 1).long()
    v = torch.where(valid, v, 0.0).clamp(0, T.HIST_N - 1).long()
    frame = torch.arange(nb, device=b.device).view(-1, 1, 1)
    bins = (frame * T.HIST_N * T.HIST_N + u * T.HIST_N + v)[valid]
    counts = torch.bincount(bins, minlength=nb * T.HIST_N * T.HIST_N)
    weight = float(T.f32(1.0 / (h * w)))
    return counts.to(ft).view(nb, T.HIST_N, T.HIST_N) * weight


def response(hist, filt_re, filt_im, bias, ft=F32):
    """Re(IDFT2(DFT2(hist) * DFT(filter))) / 256^2 + bias by twelve real
    matrix products (full f32 products: no TF32)."""
    fr, fi = (on(m, hist.device).to(ft) for m in T.dft_matrices())
    wr, wi, bias = (on(m, hist.device).to(ft) for m in (filt_re, filt_im, bias))
    mm = torch.matmul
    A, B = mm(hist, fr), mm(hist, fi)
    Yr = mm(fr, A) - mm(fi, B)
    Yi = mm(fr, B) + mm(fi, A)
    Zr = Yr * wr - Yi * wi
    Zi = Yr * wi + Yi * wr
    Ar = mm(fr, Zr) + mm(fi, Zi)
    Ai = mm(fr, Zi) - mm(fi, Zr)
    return (mm(Ar, fr) + mm(Ai, fi)) * (1.0 / (T.HIST_N * T.HIST_N)) + bias


def peak(resp: torch.Tensor) -> torch.Tensor:
    """Row-major first-occurrence argmax, cv::minMaxLoc's (x=col, y=row):
    [B, 2] int64."""
    idx = torch.argmax(resp.reshape(resp.shape[0], -1), dim=-1)
    return torch.stack([idx % T.HIST_N, idx // T.HIST_N], dim=-1)


def gains_from_uv(uv: torch.Tensor, exp_tab: torch.Tensor) -> torch.Tensor:
    """[B, 2] (x, y) -> [B, 3] BGR gains exp(Lv), 1, exp(Lu) over their
    minimum (ccc.cpp:342-381)."""
    gr, gb = exp_tab[uv[:, 0].long()], exp_tab[uv[:, 1].long()]
    gains = torch.stack([gb, torch.ones_like(gr), gr], dim=-1)
    return gains / gains.min(dim=-1, keepdim=True).values


# ---------------------------------------------------------------------------
# Gains, colour calibration, gamma, vignetting, enhancer
# ---------------------------------------------------------------------------


def apply_gains(planes, gains, ft=F32):
    """cv::multiply(image, Scalar(gain_b, gain_g, gain_r)), round half even."""
    gains = gains.to(ft)
    return tuple(round_u8(p.to(ft) * gains[:, c, None, None]) for c, p in enumerate(planes))


def color_correct(planes, matrix, bias, ft=F32):
    """cv::gemm's left-associated K=3 chain, + bias, convertTo's rounding."""
    bf, gf, rf = (p.to(ft) for p in planes)
    m = on(matrix, planes[0].device).to(ft)
    c = on(bias, planes[0].device).to(ft)
    return tuple(round_u8(((bf * m[o, 0] + gf * m[o, 1]) + rf * m[o, 2]) + c[o])
                 for o in range(3))


def lut(planes, table):
    t = on(table, planes[0].device)
    return tuple(t[p.long()] for p in planes)


def _tab(a, device):
    return on(a, device, torch.int32)


def bgr_to_lab(b, g, r):
    """cvtColor(COLOR_BGR2Lab), the 8u integer path."""
    dev = b.device
    C = [int(c) for c in T.LAB_COEF]
    gt, cbrt = _tab(T.LAB_GAMMA_TAB, dev), _tab(T.CBRT_TAB, dev)
    b, g, r = gt[b.long()], gt[g.long()], gt[r.long()]

    def ctab(x):
        return cbrt[torch.clamp(x, 0, T.CBRT_TAB_SIZE - 1).long()]

    fX = ctab(descale(r * C[0] + g * C[1] + b * C[2], T.LAB_SHIFT))
    fY = ctab(descale(r * C[3] + g * C[4] + b * C[5], T.LAB_SHIFT))
    fZ = ctab(descale(r * C[6] + g * C[7] + b * C[8], T.LAB_SHIFT))
    s2 = T.LAB_SHIFT2
    L = descale(((116 * 255 + 50) // 100) * fY - ((16 * 255 * (1 << s2) + 50) // 100), s2)
    a = descale(500 * (fX - fY) + 128 * (1 << s2), s2)
    bb = descale(200 * (fY - fZ) + 128 * (1 << s2), s2)
    return tuple(torch.clamp(x, 0, 255).to(torch.uint8) for x in (L, a, bb))


def _ab_to_xz(i):
    i = torch.clamp(i, T.LAB2_MIN_AB, T.LAB2_AB_MAX)
    lin = torch.div(i * 108, 841, rounding_mode="trunc") - 290
    cub = (((i * i) >> 14) * i) >> 14
    return torch.where(i <= 3390, lin, cub)


def lab_to_bgr(L, a, b):
    """cvtColor(COLOR_Lab2BGR), OpenCV 5's Lab2RGBinteger."""
    dev = L.device
    L, a, b = L.long(), a.to(torch.int32), b.to(torch.int32)
    y, ify = _tab(T.LAB2_Y_TAB, dev)[L], _tab(T.LAB2_IFY_TAB, dev)[L]
    adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * T.LAB2_BASE // 500
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - 128 * T.LAB2_BASE // 200 + 1
    x, z = _ab_to_xz(ify + adiv), _ab_to_xz(ify - bdiv)
    inv = _tab(T.LAB2_INV_GAMMA_TAB, dev)
    C = T.LAB2_COEF

    def channel(row):
        s = C[row][0] * x + C[row][1] * y + C[row][2] * z
        return inv[torch.clamp((s + 8192) >> 14, 0, 8191).long()].to(torch.uint8)

    return channel(2), channel(1), channel(0)


def vignetting(planes, mask, ft=F32):
    """BGR -> Lab, L(float) * mask rounded back to u8, Lab -> BGR."""
    L, a, b = bgr_to_lab(*planes)
    return lab_to_bgr(round_u8(L.to(ft) * on(mask, L.device).to(ft)), a, b)


def bgr_to_hsv(b, g, r):
    """cvtColor(COLOR_BGR2HSV), hsv_shift 12."""
    dev = b.device
    sdiv, hdiv = _tab(T.SDIV_TAB, dev), _tab(T.HDIV_TAB, dev)
    b, g, r = b.to(torch.int32), g.to(torch.int32), r.to(torch.int32)
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    half = 1 << (T.HSV_SHIFT - 1)
    s = (diff * sdiv[v.long()] + half) >> T.HSV_SHIFT
    h_num = torch.where(v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h_num * hdiv[diff.long()] + half) >> T.HSV_SHIFT
    h = h + torch.where(h < 0, 180, 0)
    return h.to(torch.uint8), s.to(torch.uint8), v.to(torch.uint8)


def hsv_to_bgr(h, s, v, ft=F32):
    """cvtColor(COLOR_HSV2BGR): the f32 chain with single-rounding fmas;
    OpenCV's 32-pixel vector kernel truncates the final *255, its scalar
    kernel (the width % 32 tail of each row) rounds it."""
    h = h.to(ft)
    s = s.to(ft) * float(T.f32(1.0 / 255.0))
    v = v.to(ft) * float(T.f32(1.0 / 255.0))
    hf = h * float(T.f32(6.0 / 180.0))
    sector = torch.floor(hf).to(torch.int32)
    ff = hf - sector.to(ft)
    sector = sector % 6
    one = torch.ones((), dtype=ft, device=h.device)
    tab = (v, v * (1.0 - s), v * fma(-s, ff, one), v * fma(-s, 1.0 - ff, one))
    w = h.shape[-1]
    scalar = torch.arange(w, device=h.device) >= w - w % 32

    def pick(channel):
        out = tab[T.SECTOR_DATA[0][channel]]
        for sec in range(1, 6):
            out = torch.where(sector == sec, tab[T.SECTOR_DATA[sec][channel]], out)
        prod = out * 255.0
        return torch.where(scalar, torch.clamp(torch.round(prod), 0, 255),
                           torch.floor(prod)).to(torch.uint8)

    return pick(0), pick(1), pick(2)


def enhance(planes, gain_tabs, ft=F32):
    """BGR -> HSV, each channel through its gain table, HSV -> BGR."""
    h, s, v = bgr_to_hsv(*planes)
    t = on(gain_tabs, h.device)
    return hsv_to_bgr(t[0][h.long()], t[1][s.long()], t[2][v.long()], ft)


# ---------------------------------------------------------------------------
# cv::remap INTER_LINEAR, BORDER_CONSTANT 0, the x86/IPP lerp
# ---------------------------------------------------------------------------


def remap_lerp(planes, flat: torch.Tensor, weights: torch.Tensor, out_hw, ft=F32):
    """Per pixel two x-lerps and a y-lerp, each one rounding, then rint:
    [B, Ho, Wo, C] u8. flat [N] int64 is the top-left tap (tables.lerp_taps),
    weights [6, N] = (fx, fy, four tap masks)."""
    h, w = planes[0].shape[-2:]
    src = torch.stack([p.reshape(p.shape[0], h * w) for p in planes], dim=-1)
    wt = weights.to(ft)
    fx, fy = wt[0][None, :, None], wt[1][None, :, None]

    def tap(off, k):
        idx = torch.clamp(flat + off, 0, h * w - 1)
        return src.index_select(1, idx).to(ft) * wt[2 + k][None, :, None]

    v00, v01, v10, v11 = tap(0, 0), tap(1, 1), tap(w, 2), tap(w + 1, 3)
    C = 4097.0
    ca = fx * C
    fxh = ca - (ca - fx)
    fxl = fx - fxh

    def lerp_x(v0, v1):
        d = v1 - v0
        pp = fx * d
        err = (fxh * d - pp) + fxl * d
        ss = pp + v0
        bb = ss - pp
        return ss + (((pp - (ss - bb)) + (v0 - bb)) + err)

    t, b = lerp_x(v00, v01), lerp_x(v10, v11)
    out = round_u8(fma(fy, b - t, t))
    return out.reshape(out.shape[0], out_hw[0], out_hw[1], out.shape[-1])
