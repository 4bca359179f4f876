"""Host-side tables and geometry of the plain reference: every number the
chain derives at set-up (log and exp tables, resize taps, the Lab and HSV
tables, the gamma table, the enhancer's gain tables, the vignetting mask,
the fisheye maps and the remap's lerp factors, the CCC model's DFT),
worked out again from the configuration and the model file.

A frozen copy of the plain formulas that reproduce OpenCV's arithmetic
bit for bit (cv::resize INTER_LINEAR, cvtColor's integer Lab and HSV
paths, cv::fisheye, cv::remap's x86/IPP lerp). Numpy, float64 where the
library computes in double; imports nothing but the standard library and
numpy.
"""

from __future__ import annotations

import math
import struct
from typing import Tuple

import numpy as np

f32 = np.float32

# ---------------------------------------------------------------------------
# CCC (convolutional_color_constancy.cpp)
# ---------------------------------------------------------------------------

SMALL_W, SMALL_H = 360, 270
BIN_SIZE = 1.0 / 64.0
HIST_N = 256

LOG_TAB = np.array([math.log(i) if i else -math.inf for i in range(256)],
                   np.float64).astype(f32)
# cv::cvtColor(BGR2GRAY) weights as f32 values
GRAY_R, GRAY_G, GRAY_B = (float(f32(c)) for c in (0.299, 0.587, 0.114))


def exp_table(uv0: float) -> np.ndarray:
    """f32 exp(Lu) for the 256 bin coordinates: Lu = f32(x)*bin + uv0 in
    f32, exp by libm."""
    lu = (np.arange(HIST_N, dtype=f32) * f32(BIN_SIZE) + f32(uv0)).astype(f32)
    return np.array([math.exp(float(v)) for v in lu], np.float64).astype(f32)


def dft_matrices() -> Tuple[np.ndarray, np.ndarray]:
    """Real and imaginary parts of the 256-point DFT matrix, f32."""
    k = np.arange(HIST_N)
    ang = -2.0 * np.pi * np.outer(k, k) / HIST_N
    return np.cos(ang).astype(f32), np.sin(ang).astype(f32)


def load_ccc_model(path: str):
    """The FFCC model file (int32 width, height; f32 filter; f32 bias, each
    transposed on load as the reference does) -> (filter DFT real, filter
    DFT imaginary, bias), [256, 256] f32 each."""
    with open(path, "rb") as f:
        width, height = struct.unpack("<ii", f.read(8))
        n = width * height
        filt = np.frombuffer(f.read(4 * n), dtype="<f4").reshape(height, width)
        bias = np.frombuffer(f.read(4 * n), dtype="<f4").reshape(height, width)
    filt_dft = np.fft.fft2(np.ascontiguousarray(filt.T).astype(np.float64))
    return (filt_dft.real.astype(f32), filt_dft.imag.astype(f32),
            np.ascontiguousarray(bias.T).astype(f32))


# ---------------------------------------------------------------------------
# cv::resize INTER_LINEAR, 8u fixed point
# ---------------------------------------------------------------------------


def _coords(src: int, dst: int):
    scale = 1.0 / (dst / src)
    x = np.arange(dst, dtype=np.float64)
    fxf = ((x + 0.5) * scale - 0.5).astype(f32)
    sx = np.floor(fxf).astype(np.int64)
    return sx, (fxf - sx.astype(f32)).astype(f32)


def _quant(f):
    a1 = np.rint(f * f32(2048.0)).astype(np.int32)
    a0 = np.rint((f32(1.0) - f) * f32(2048.0)).astype(np.int32)
    return a0, a1


def resize_tables(src_h: int, src_w: int, dst_h: int, dst_w: int):
    """((sx, sx2, a0, a1), (sy, sy2, b0, b1)): the horizontal taps with
    OpenCV's border override, the vertical taps with clamped rows and the
    raw weights."""
    sx, fx = _coords(src_w, dst_w)
    left = sx < 0
    fx, sx = np.where(left, f32(0.0), fx), np.where(left, 0, sx)
    right = sx >= src_w - 1
    fx, sx = np.where(right, f32(0.0), fx), np.where(right, src_w - 1, sx)
    a0, a1 = _quant(fx)
    sy, fy = _coords(src_h, dst_h)
    b0, b1 = _quant(fy)
    return ((sx, np.minimum(sx + 1, src_w - 1), a0, a1),
            (np.clip(sy, 0, src_h - 1), np.clip(sy + 1, 0, src_h - 1), b0, b1))


# ---------------------------------------------------------------------------
# cvtColor's integer HSV and Lab paths
# ---------------------------------------------------------------------------

HSV_SHIFT = 12
SDIV_TAB = np.zeros(256, np.int32)
HDIV_TAB = np.zeros(256, np.int32)
SDIV_TAB[1:] = np.rint((255 << HSV_SHIFT) / np.arange(1, 256)).astype(np.int32)
HDIV_TAB[1:] = np.rint((180 << HSV_SHIFT) / (6.0 * np.arange(1, 256))).astype(np.int32)
SECTOR_DATA = ((1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3), (2, 1, 0))

LAB_SHIFT = 12
GAMMA_SHIFT = 3
LAB_SHIFT2 = LAB_SHIFT + GAMMA_SHIFT
CBRT_TAB_SIZE = 3072
_WHITEPT = (0.950456, 1.0, 1.088754)
_XYZ_COEF = (0.412453, 0.357580, 0.180423, 0.212671, 0.715160, 0.072169,
             0.019334, 0.119193, 0.950227)


def _softfloat_cbrt_f32(xbits: np.ndarray) -> np.ndarray:
    """OpenCV's cv::cbrt(softfloat) on f32 bit patterns: the quartic
    rational polynomial in f64 on the fraction, truncated to f32."""
    xbits = np.asarray(xbits, np.uint32)
    ix = (xbits & 0x7FFFFFFF).astype(np.int64)
    sign = xbits & 0x80000000
    ex = (ix >> 23) - 127
    shx = np.fmod(ex, 3)
    shx = shx - np.where(shx >= 0, 3, 0)
    ex_out = (ex - shx) // 3
    frbits = ((ix & ((1 << 23) - 1)) | ((shx + 127) << 23)).astype(np.uint32)
    fr = frbits.view(f32).astype(np.float64)
    num = (((45.2548339756803022511987494 * fr + 192.2798368355061050458134625) * fr
            + 119.1654824285581628956914143) * fr + 13.43250139086239872172837314) * fr \
        + 0.1636161226585754240958355063
    den = (((14.80884093219134573786480845 * fr + 151.9714051044435648658557668) * fr
            + 168.5254414101568283957668343) * fr + 33.9905941350215598754191872) * fr + 1.0
    q = num / den
    man = (q.view(np.uint64) >> np.uint64(29)) & np.uint64(0x7FFFFF)
    out = (sign.astype(np.uint64)
           | ((126 + ex_out).astype(np.uint64) << np.uint64(23)) | man)
    return np.where(ix == 0, xbits, out.astype(np.uint32))


def _lab_tables():
    i = np.arange(256, dtype=np.float64) / 255.0
    lin = np.where(i <= 0.04045, i / 12.92, ((i + 0.055) / 1.055) ** 2.4)
    gamma_tab = np.rint(255.0 * (1 << GAMMA_SHIFT) * lin).astype(np.int32)
    scale = f32(1.0) / (f32(255) * f32(1 << GAMMA_SHIFT))
    x = (scale * np.arange(CBRT_TAB_SIZE, dtype=f32)).astype(f32)
    lthresh = (f32(216) / f32(24389)).astype(f32)
    lscale = (f32(841) / f32(108)).astype(f32)
    lbias = (f32(16) / f32(116)).astype(f32)
    lin_branch = (x.astype(np.float64) * np.float64(lscale) + np.float64(lbias)).astype(f32)
    cbrt_branch = _softfloat_cbrt_f32(x.view(np.uint32)).view(f32)
    fx = np.where(x < lthresh, lin_branch, cbrt_branch)
    cbrt_tab = np.rint((f32(1 << LAB_SHIFT2) * fx).astype(f32).astype(np.float64)).astype(np.int32)
    coef = np.array([np.rint(_XYZ_COEF[j] * (1 << LAB_SHIFT) / _WHITEPT[j // 3])
                     for j in range(9)], np.int32)
    return gamma_tab, cbrt_tab, coef


LAB_GAMMA_TAB, CBRT_TAB, LAB_COEF = _lab_tables()

LAB2_BASE = 1 << 14
LAB2_MIN_AB = -8145
LAB2_AB_MAX = LAB2_BASE * 9 // 4 + LAB2_MIN_AB - 1


def _lab2_yf_tables():
    i = np.arange(256)
    li = (i * 100 / f32(255)).astype(f32)
    lthresh = f32(0.008856) * f32(903.3)
    ylo = np.rint((LAB2_BASE * (li / f32(903.3))).astype(f32))
    ifylo = np.rint((LAB2_BASE * (f32(7.787) * (li / f32(903.3)) + f32(16.0 / 116.0))).astype(f32))
    fy = ((li + 16) / f32(116)).astype(f32)
    ifyhi = np.rint((LAB2_BASE * fy).astype(f32))
    yhi = np.rint((LAB2_BASE * fy * fy * fy).astype(f32))
    lo = li <= lthresh
    return np.where(lo, ylo, yhi).astype(np.int32), np.where(lo, ifylo, ifyhi).astype(np.int32)


LAB2_Y_TAB, LAB2_IFY_TAB = _lab2_yf_tables()


def _lab2_inv_gamma_table():
    x = (np.arange(8192) / f32(4096)).astype(f32)
    g = np.where(x <= f32(0.0031308), x * f32(12.92),
                 f32(1.055) * np.power(x, f32(1 / 2.4), dtype=f32) - f32(0.055))
    return np.clip(np.rint((f32(255) * g).astype(f32)), 0, 255).astype(np.int32)


LAB2_INV_GAMMA_TAB = _lab2_inv_gamma_table()
_M = ((3.240479, -1.53715, -0.498535), (-0.969256, 1.875991, 0.041556),
      (0.055648, -0.204043, 1.057311))
LAB2_COEF = [[int(np.rint(np.float64(4096 * _M[r][c] * _WHITEPT[c]))) for c in range(3)]
             for r in range(3)]


# ---------------------------------------------------------------------------
# Gamma, enhancer, vignetting
# ---------------------------------------------------------------------------


def gamma_lut(k: float) -> np.ndarray:
    """lut[i] = cvRound((float)pow(i/255, k) * 255), pow by libm."""
    i = np.arange(256, dtype=np.float64) / 255.0
    f = np.array([math.pow(v, k) for v in i], np.float64).astype(f32)
    return np.clip(np.rint(f.astype(np.float64) * 255.0), 0, 255).astype(np.uint8)


def gain_tables(gains) -> np.ndarray:
    """[3, 256] u8: cv::multiply's clip(rint(i * g)) in f64 for (H, S, V)."""
    i = np.arange(256, dtype=np.float64)
    return np.stack([np.clip(np.rint(i * g), 0, 255)
                     for g in np.asarray(gains, np.float64)]).astype(np.uint8)


def vignetting_mask(height: int, width: int, scale: float, a2: float, a4: float) -> np.ndarray:
    """[H, W] f32: a2*r^2 + a4*r^4 over its maximum, times scale, plus one."""
    cy, cx = height / 2.0, width / 2.0
    y = np.arange(height, dtype=np.float64)[:, None]
    x = np.arange(width, dtype=np.float64)[None, :]
    r2 = (y - cy) ** 2 + (x - cx) ** 2
    k = r2 * a2 + r2 * r2 * a4
    mx = k.max()
    if mx > 0:
        k = k / mx
    return (k * scale + 1.0).astype(f32)


# ---------------------------------------------------------------------------
# cv::fisheye, f64
# ---------------------------------------------------------------------------


def _undistort_points(pts: np.ndarray, K: np.ndarray, D: np.ndarray, R: np.ndarray) -> np.ndarray:
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    out = np.empty_like(pts, dtype=np.float64)
    for n, (u, v) in enumerate(np.asarray(pts, dtype=np.float64)):
        pwx, pwy = (u - cx) / fx, (v - cy) / fy
        theta_d = min(max(-np.pi / 2, np.sqrt(pwx * pwx + pwy * pwy)), np.pi / 2)
        converged, theta, scale = False, theta_d, 0.0
        if abs(theta_d) > 1e-8:
            for _ in range(10):
                t2 = theta * theta
                t4, t6, t8 = t2 * t2, t2 * t2 * t2, t2 * t2 * t2 * t2
                k0t2, k1t4, k2t6, k3t8 = D[0] * t2, D[1] * t4, D[2] * t6, D[3] * t8
                fix = (theta * (1 + k0t2 + k1t4 + k2t6 + k3t8) - theta_d) / (
                    1 + 3 * k0t2 + 5 * k1t4 + 7 * k2t6 + 9 * k3t8)
                theta -= fix
                if abs(fix) < 1e-8:
                    converged = True
                    break
            scale = math.tan(theta) / theta_d
        else:
            converged, scale = True, 1.0
        flipped = (theta_d < 0 < theta) or (theta_d > 0 > theta)
        if converged and not flipped:
            pux, puy = pwx * scale, pwy * scale
            pr = [R[i, 0] * pux + R[i, 1] * puy + R[i, 2] for i in range(3)]
            out[n] = (pr[0] / pr[2], pr[1] / pr[2])
        else:
            out[n] = (-1000000.0, -1000000.0)
    return out


def new_camera_matrix(K, D, image_size, R, balance, new_size, fov_scale) -> np.ndarray:
    """cv::fisheye::estimateNewCameraMatrixForUndistortRectify; sizes are
    (width, height)."""
    w, h = image_size
    balance = min(max(balance, 0.0), 1.0)
    pts = np.array([[w // 2, 0], [w, h // 2], [w // 2, h], [0, h // 2]], np.float64)
    up = _undistort_points(pts, K, D, R)
    cn = up.mean(axis=0)
    aspect = K[0, 0] / K[1, 1]
    cn[1] *= aspect
    up = up.copy()
    up[:, 1] *= aspect
    minx, miny = up.min(axis=0)
    maxx, maxy = up.max(axis=0)
    f1 = w * 0.5 / (cn[0] - minx)
    f2 = w * 0.5 / (maxx - cn[0])
    f3 = h * 0.5 * aspect / (cn[1] - miny)
    f4 = h * 0.5 * aspect / (maxy - cn[1])
    f = balance * min(f1, f2, f3, f4) + (1.0 - balance) * max(f1, f2, f3, f4)
    f *= (1.0 / fov_scale) if fov_scale > 0 else 1.0
    new_f = [f, f / aspect]
    new_c = [-cn[0] * f + w * 0.5, (-cn[1] * f + h * aspect * 0.5) / aspect]
    rx, ry = new_size[0] / w, new_size[1] / h
    return np.array([[new_f[0] * rx, 0, new_c[0] * rx], [0, new_f[1] * ry, new_c[1] * ry],
                     [0, 0, 1]], np.float64)


def _inv3(a: np.ndarray) -> np.ndarray:
    """cv::Matx_FastInvOp<double, 3>: cofactors times 1/det."""
    det = (a[0, 0] * (a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1])
           - a[0, 1] * (a[1, 0] * a[2, 2] - a[1, 2] * a[2, 0])
           + a[0, 2] * (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]))
    d = 1.0 / det
    b = np.empty((3, 3), np.float64)
    b[0, 0] = (a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1]) * d
    b[0, 1] = (a[0, 2] * a[2, 1] - a[0, 1] * a[2, 2]) * d
    b[0, 2] = (a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1]) * d
    b[1, 0] = (a[1, 2] * a[2, 0] - a[1, 0] * a[2, 2]) * d
    b[1, 1] = (a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0]) * d
    b[1, 2] = (a[0, 2] * a[1, 0] - a[0, 0] * a[1, 2]) * d
    b[2, 0] = (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]) * d
    b[2, 1] = (a[0, 1] * a[2, 0] - a[0, 0] * a[2, 1]) * d
    b[2, 2] = (a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]) * d
    return b


def undistort_maps(K, D, R, P, size) -> Tuple[np.ndarray, np.ndarray]:
    """cv::fisheye::initUndistortRectifyMap -> (map_x, map_y) f32 [H, W];
    size is (width, height). Each row is walked as the library does, a
    running sum per column."""
    w, h = size
    Pm, Rm = np.asarray(P, np.float64)[:3, :3], np.asarray(R, np.float64)
    PR = np.empty((3, 3), np.float64)
    for i in range(3):
        for j in range(3):
            PR[i, j] = Pm[i, 0] * Rm[0, j] + Pm[i, 1] * Rm[1, j] + Pm[i, 2] * Rm[2, j]
    iR = _inv3(PR)
    rows = np.arange(h, dtype=np.float64)[:, None]

    def scan_row(r0):
        steps = np.full((h, w), iR[r0, 0])
        steps[:, 0:1] = rows * iR[r0, 1] + iR[r0, 2]
        return np.add.accumulate(steps, axis=1)

    _w = scan_row(2)
    x, y = scan_row(0) / _w, scan_row(1) / _w
    r = np.sqrt(x * x + y * y)
    theta = np.frompyfunc(math.atan, 1, 1)(r).astype(np.float64)
    t2 = theta * theta
    t4 = t2 * t2
    t6 = t4 * t2
    t8 = t4 * t4
    theta_d = theta * (1 + D[0] * t2 + D[1] * t4 + D[2] * t6 + D[3] * t8)
    with np.errstate(invalid="ignore", divide="ignore"):
        scale = np.where(r == 0, 1.0, theta_d / np.where(r == 0, 1.0, r))
    u = K[0, 0] * x * scale + K[0, 2]
    v = K[1, 1] * y * scale + K[1, 2]
    return u.astype(f32), v.astype(f32)


def lerp_taps(map_x: np.ndarray, map_y: np.ndarray, src_hw) -> Tuple[np.ndarray, np.ndarray]:
    """cv::remap's lerp factors: (top-left tap [N] int64 flat index, or -1
    where no tap lies in the frame; [6, N] f32 fx, fy and the four tap
    masks, a tap outside the frame reading 0)."""
    h, w = src_hw
    X, Y = map_x.astype(f32), map_y.astype(f32)
    ix, iy = np.floor(X).astype(np.int64), np.floor(Y).astype(np.int64)
    fx = (X - ix.astype(f32)).astype(f32)
    fy = (Y - iy.astype(f32)).astype(f32)
    masks = [((iy + dy >= 0) & (iy + dy <= h - 1) & (ix + dx >= 0)
              & (ix + dx <= w - 1)).astype(f32) for dy in (0, 1) for dx in (0, 1)]
    weights = np.stack([fx, fy] + masks).reshape(6, -1).astype(f32)
    any_in = (np.stack(masks).sum(axis=0) > 0).reshape(-1)
    return np.where(any_in, (iy * w + ix).reshape(-1), -1), weights
