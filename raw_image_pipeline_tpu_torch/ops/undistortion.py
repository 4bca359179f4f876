"""Fisheye (equidistant) undistortion (PyTorch port of
raw_image_pipeline_tpu/ops/undistortion.py).

Init-time host math — verbatim copies of the reference package's numpy
ports (bit-exact vs cv2.fisheye) of cv::fisheye::undistortPoints,
estimateNewCameraMatrixForUndistortRectify and initUndistortRectifyMap, and
of `remap_precompute`, which factors the remap into one anchor index and the
per-pixel weights; tests/test_torch_ops.py holds them equal to the
originals.

Device remap — cv::remap(INTER_LINEAR, BORDER_CONSTANT=0) in the three
arithmetics `remap_precompute` factors, each reading the four taps straight
from the planes (`remap_planes` picks by mode):

- `remap_lerp_planes`, the x86/IPP "lerp": per pixel two x-lerps and one
  y-lerp, each a single-rounding fma (Dekker-emulated in plain f32 ops);
  on a CUDA tensor kernel F (csrc/remap_lerp.cu) computes it;
- `remap_float_planes`, "float": the plain two-rounding blend
  ((t0*w0 + t1*w1) + t2*w2) + t3*w3, then rint; on a CUDA tensor kernel E
  (csrc/remap_float.cu) computes it;
- `remap_fixed32_planes`, "fixed32": the 2^15-scaled integer blend, exact
  in f32; on a CUDA tensor kernel F computes it, from a compact map where
  the caller gives one (`remap_fixed32_code`: an int16 code a pixel beside
  the anchor, the chains' params carry it) and from the weights otherwise.

Per-camera maps (the camera-blocked multicamera chain): `remap_planes`
also takes base [C, N] and weights [C, k, N] stacked over C cameras, with
the planes' batch camera-major ([C*B'] frames); each camera's block of B'
frames goes through its own map. Kernels E and F do so in one launch, the
plain versions block by block.

The reference package's entry points take frames: `remap_bilinear_u8`
([..., H, W, C]), `remap_bilinear_u8_planes` (its batch-minor planes
[H, W, ...]) and `remap_bilinear_u8_from_maps` (cv2-style maps); each goes
through `remap_planes`, so every mode reaches kernel E or F on a CUDA
tensor.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from raw_image_pipeline_tpu_torch import kernels
from raw_image_pipeline_tpu_torch.ops.common import as_tensor_on, fma_f32, round_u8


# ---------------------------------------------------------------------------
# Host-side fisheye math (numpy, float64 — init time only; verbatim copies)
# ---------------------------------------------------------------------------


def fisheye_undistort_points(pts: np.ndarray, K: np.ndarray, D: np.ndarray, R: np.ndarray) -> np.ndarray:
    """cv::fisheye::undistortPoints: pts [N,2] pixel coords -> normalized,
    rectified image coords [N,2]."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    R = np.asarray(R, np.float64)
    out = np.empty_like(pts, dtype=np.float64)
    for n, (u, v) in enumerate(np.asarray(pts, dtype=np.float64)):
        pwx, pwy = (u - cx) / fx, (v - cy) / fy
        theta_d = np.sqrt(pwx * pwx + pwy * pwy)
        theta_d = min(max(-np.pi / 2, theta_d), np.pi / 2)
        converged = False
        theta = theta_d
        scale = 0.0
        if abs(theta_d) > 1e-8:
            # Newton solve, op-for-op the library's: the k_i*theta^2i
            # products are formed ONCE and the derivative uses 3*(k0*t2)
            # etc. — (3*k0)*t2 rounds differently at the last ulp
            # (random-intrinsics fuzz, round 5)
            for _ in range(10):
                t2 = theta * theta
                t4, t6, t8 = t2 * t2, t2 * t2 * t2, t2 * t2 * t2 * t2
                k0t2, k1t4, k2t6, k3t8 = D[0] * t2, D[1] * t4, D[2] * t6, D[3] * t8
                fix = (theta * (1 + k0t2 + k1t4 + k2t6 + k3t8) - theta_d) / (
                    1 + 3 * k0t2 + 5 * k1t4 + 7 * k2t6 + 9 * k3t8
                )
                theta -= fix
                if abs(fix) < 1e-8:
                    converged = True
                    break
            # math.tan == libm tan == the library's std::tan; numpy's own
            # SIMD f64 tan is 1 ulp off at some arguments (seed-95 fuzz)
            scale = math.tan(theta) / theta_d
        else:
            converged = True
            scale = 1.0
        # theta is monotonic in theta_d: a sign flip means divergence
        theta_flipped = (theta_d < 0 < theta) or (theta_d > 0 > theta)
        if converged and not theta_flipped:
            pux, puy = pwx * scale, pwy * scale
            # plain left-associated 3x3 matvec (Matx33d*Vec3d), not numpy
            # dot — BLAS fma/pairwise sums can differ in the last ulp
            pr = [R[i, 0] * pux + R[i, 1] * puy + R[i, 2] for i in range(3)]
            out[n] = (pr[0] / pr[2], pr[1] / pr[2])
        else:
            # the library marks non-converged points with this sentinel;
            # estimateNewCameraMatrix... then consumes it as-is, which is
            # why wildly-distorted calibrations yield degenerate newK
            out[n] = (-1000000.0, -1000000.0)
    return out


def estimate_new_camera_matrix(
    K: np.ndarray,
    D: np.ndarray,
    image_size: Tuple[int, int],
    R: np.ndarray,
    balance: float = 0.0,
    new_size: Tuple[int, int] | None = None,
    fov_scale: float = 1.0,
) -> np.ndarray:
    """cv::fisheye::estimateNewCameraMatrixForUndistortRectify.
    image_size/new_size are (width, height)."""
    w, h = image_size
    balance = min(max(balance, 0.0), 1.0)
    # the C++ boundary sample points use INTEGER division for the
    # midpoints (int width/height, fisheye.cpp) — visible at ODD sizes,
    # where float halves shift newK by ~0.3 px (round-5 finding, verified
    # equal to cv2 at odd sizes only with the integer halves)
    pts = np.array(
        [[w // 2, 0], [w, h // 2], [w // 2, h], [0, h // 2]], np.float64
    )
    up = fisheye_undistort_points(pts, K, D, R)
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
    fmin, fmax = min(f1, f2, f3, f4), max(f1, f2, f3, f4)
    f = balance * fmin + (1.0 - balance) * fmax
    f *= (1.0 / fov_scale) if fov_scale > 0 else 1.0
    new_f = [f, f]
    new_c = [-cn[0] * f + w * 0.5, -cn[1] * f + h * aspect * 0.5]
    new_f[1] /= aspect
    new_c[1] /= aspect
    if new_size is not None:
        rx, ry = new_size[0] / w, new_size[1] / h
        new_f[0] *= rx
        new_f[1] *= ry
        new_c[0] *= rx
        new_c[1] *= ry
    return np.array(
        [[new_f[0], 0, new_c[0]], [0, new_f[1], new_c[1]], [0, 0, 1]], np.float64
    )


def _inv3_cv(a: np.ndarray) -> np.ndarray:
    """3x3 inverse, op-for-op cv::Matx_FastInvOp<double,3> (DECOMP_LU):
    cofactor-expansion determinant, d = 1/det, each adjugate entry formed
    as (m1*m2 - m3*m4) * d. Verified bitwise == cv2.invert(DECOMP_LU) on
    2000 random matrices."""
    a = np.asarray(a, np.float64)
    det = (
        a[0, 0] * (a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1])
        - a[0, 1] * (a[1, 0] * a[2, 2] - a[1, 2] * a[2, 0])
        + a[0, 2] * (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0])
    )
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


def init_undistort_rectify_map(
    K: np.ndarray,
    D: np.ndarray,
    R: np.ndarray,
    P: np.ndarray,
    size: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """cv::fisheye::initUndistortRectifyMap -> (map_x, map_y) float32 [H, W].
    size is (width, height); P may be 3x3 or 3x4 (only P[:3,:3] is used)."""
    w, h = size
    # plain left-associated 3x3 matmul + the library's closed-form
    # adjugate inverse (cv::Matx_FastInvOp<double,3>, DECOMP_LU) — BLAS
    # matmul order and LAPACK LU both differ from it in the last f64
    # ulp, which flips f32 map values at catastrophic-cancellation
    # pixels (~1 px per 400 random-intrinsics frames; round-5 fuzz,
    # discriminated LU-vs-SVD empirically over 400 seeds: LU matches)
    Pm, Rm = np.asarray(P, np.float64)[:3, :3], np.asarray(R, np.float64)
    PR = np.empty((3, 3), np.float64)
    for i in range(3):
        for j in range(3):
            PR[i, j] = Pm[i, 0] * Rm[0, j] + Pm[i, 1] * Rm[1, j] + Pm[i, 2] * Rm[2, j]
    iR = _inv3_cv(PR)

    # cv2 walks each row INCREMENTALLY (_x starts at i*iR01 + iR02 and
    # accumulates += iR00 per column, fisheye.cpp) — the running-sum
    # rounding differs from the closed form j*iR00 + i*iR01 + iR02 at
    # ~.5-ulp boundaries (one f32 map ulp flipped on a real-D 720x540
    # sweep; round-5 finding). np.add.accumulate is the same ordered scan.
    rows = np.arange(h, dtype=np.float64)[:, None]

    def scan_row(r0):
        steps = np.full((h, w), iR[r0, 0])
        steps[:, 0:1] = rows * iR[r0, 1] + iR[r0, 2]
        return np.add.accumulate(steps, axis=1)

    _x = scan_row(0)
    _y = scan_row(1)
    _w = scan_row(2)
    x = _x / _w
    y = _y / _w
    r = np.sqrt(x * x + y * y)
    # elementwise libm atan (= the library's std::atan): numpy's SIMD f64
    # arctan is 1 ulp off at ~0.15% of arguments (round-5 probe), a latent
    # f32 flip at cancellation pixels; ~0.23 s/Mpx, init-time only
    theta = np.frompyfunc(math.atan, 1, 1)(r).astype(np.float64)
    # the power chain must match cv2's double arithmetic op-for-op
    # (theta6 = theta4*theta2 etc. — np.power(t2, 3) rounds differently
    # at ~1-ulp boundaries; round-5 finding on synthetic intrinsics)
    t2 = theta * theta
    t4 = t2 * t2
    t6 = t4 * t2
    t8 = t4 * t4
    theta_d = theta * (1 + D[0] * t2 + D[1] * t4 + D[2] * t6 + D[3] * t8)
    with np.errstate(invalid="ignore", divide="ignore"):
        scale = np.where(r == 0, 1.0, theta_d / np.where(r == 0, 1.0, r))
    u = K[0, 0] * x * scale + K[0, 2]
    v = K[1, 1] * y * scale + K[1, 2]
    return u.astype(np.float32), v.astype(np.float32)


# ---------------------------------------------------------------------------
# Device remap
# ---------------------------------------------------------------------------


_INTER_BITS = 5
_INTER_TAB_SIZE = 1 << _INTER_BITS  # 32
_REMAP_COEF_BITS = 15
_REMAP_COEF_SCALE = 1 << _REMAP_COEF_BITS  # 32768


def _bilinear_fixed_wtab() -> np.ndarray:
    """cv::remap's 32x32 fixed-point bilinear weight table (initInterTab2D
    semantics, reverse-engineered and verified entry-for-entry against a
    live cv2 5.0 via u16 probe remaps): per fractional cell (ay, ax) the
    four f32 tap products are rounded to 2^15 scale and the rounding
    residual is subtracted from the LARGEST entry so every row sums to
    exactly 2^15. Returns [32, 32, 4] int32 (tap order 00,01,10,11)."""
    f32 = np.float32
    t = np.zeros((_INTER_TAB_SIZE, _INTER_TAB_SIZE, 4), np.int32)
    for ay in range(_INTER_TAB_SIZE):
        for ax in range(_INTER_TAB_SIZE):
            fy = f32(ay) / f32(_INTER_TAB_SIZE)
            fx = f32(ax) / f32(_INTER_TAB_SIZE)
            vals = np.array(
                [(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx],
                f32,
            )
            it = np.rint(vals.astype(np.float64) * _REMAP_COEF_SCALE).astype(np.int64)
            diff = it.sum() - _REMAP_COEF_SCALE
            if diff:
                it[np.argmax(it)] -= diff
            t[ay, ax] = it
    return t


def remap_precompute(
    map_x: np.ndarray, map_y: np.ndarray, src_hw: Tuple[int, int],
    mode: str = "lerp",
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side (init-time) factorization of the remap into one gather
    index plus four masked bilinear weights per output pixel.

    OpenCV's remap has two build-dependent u8 arithmetics, and BOTH are
    replicated bit-for-bit (the reference's output depends on which
    OpenCV it links):

    mode="lerp" (default — matches THIS repo's cv2 5.0 x86/IPP oracle,
    verified 0 mismatches over millions of fisheye-map pixels): per pixel
    two x-lerps and one y-lerp, each a SINGLE-ROUNDING fused multiply-add
    in f32 — t = fma(fx, v01-v00, v00), b = fma(fx, v11-v10, v10),
    out = rint(fma(fy, b-t, t)) — with out-of-image taps reading 0
    (BORDER_CONSTANT). Device fmas are Dekker-emulated (ops/common.fma_f32).
    Returns weights [6, N] = (fx, fy, mask00, mask01, mask10, mask11) and
    base rows with the pack's zero margin already applied (taps sit at
    their NATURAL slots; masks kill row-wraparound garbage at borders).

    mode="fixed32" (OpenCV's non-IPP path — ARM/Jetson builds, and any
    build fed pre-converted CV_16SC2 maps; verified 0 mismatches against
    cv2.convertMaps + remap): coordinates snapped to 1/32 px
    (sx = rint(f32(map)*32), anchor sx>>5, frac sx&31), weights from the
    2^15-scaled integer table (_bilinear_fixed_wtab), blended as exact
    integers with the final (sum + 2^14) >> 15. Every intermediate is an
    exact integer in f32 (products <= 255*2^15, 4-sums + 2^14 < 2^25), so
    this blend is immune to fma contraction by construction.

    mode="float" is the rounds-1-4 formulation: true f32 fractional
    per-slot weights, sealed two-rounding product blend, round-half-even —
    a quantization-free variant kept selectable for comparison (differs
    from the IPP lerp at ~4 per million pixels).

    fixed32/float fetch window: the 2x2 block anchored at
    base = (clip(iy,0,H-2), clip(ix,0,W-2)); the weights are assigned to
    the four *fetched* positions, with any tap falling outside the image
    contributing exactly 0 (= cv::remap BORDER_CONSTANT 0). Clipping only
    ever moves the anchor when the true tap is out of range, and the
    weight bookkeeping keeps the in-range taps on their fetched slots, so
    the result is identical to the padded-image formulation (bit-exact vs
    cv2, see tests/test_undistortion.py) without materializing a padded
    copy per call.

    Returns (base [N] int32 flat row-major gather indices,
             weights [4, N] f32 per-slot weights for offsets
             {0, +1, +W, +W+1} - integer-valued 2^15-scale in fixed32
             mode; [6, N] (fx, fy, 4 tap masks) in lerp mode).
    """
    h, w = src_hw
    f32 = np.float32
    mx = np.asarray(map_x)
    my = np.asarray(map_y)
    if not (np.isfinite(mx).all() and np.isfinite(my).all()):
        # fail loudly at init: a NaN here would otherwise flow into the
        # blend weights and flip seal_f32's runtime zero at run time,
        # silently perturbing every sealed product in the frame
        raise ValueError("undistortion maps contain non-finite values")
    if mode == "lerp":
        m = w + 1  # pack margin (see _remap_rows lerp pack)
        X = mx.astype(f32)
        Y = my.astype(f32)
        ix = np.floor(X).astype(np.int64)
        iy = np.floor(Y).astype(np.int64)
        fx = (X - ix.astype(f32)).astype(f32)
        fy = (Y - iy.astype(f32)).astype(f32)
        masks = [
            (((iy + dy >= 0) & (iy + dy <= h - 1)
              & (ix + dx >= 0) & (ix + dx <= w - 1)).astype(f32))
            for dy in (0, 1) for dx in (0, 1)
        ]
        weights = np.stack(
            [fx, fy] + masks
        ).reshape(6, -1).astype(f32)
        flat = iy * w + ix
        # any-tap-in-range pixels satisfy flat in [-m, h*w - 1] by
        # construction; fully-out pixels all point at the pack's zero
        # margin row 0 (one cached row — same trick as the other modes)
        any_in = (np.stack(masks).sum(axis=0) > 0).reshape(-1)
        flat = np.clip(flat.reshape(-1), -m, h * w - 1)
        base = np.where(any_in, flat + m, 0).astype(np.int32)
        return base, weights
    if mode == "fixed32":
        # clip in float before the int cast: a pathological map value
        # near f32 max would otherwise overflow the int64 conversion
        # (cv2 saturates its XY shorts similarly; such pixels are fully
        # out-of-image either way)
        sx = np.rint(np.clip(
            (mx.astype(f32) * f32(_INTER_TAB_SIZE)).astype(f32),
            -2.0**40, 2.0**40)).astype(np.int64)
        sy = np.rint(np.clip(
            (my.astype(f32) * f32(_INTER_TAB_SIZE)).astype(f32),
            -2.0**40, 2.0**40)).astype(np.int64)
        ix = sx >> _INTER_BITS
        iy = sy >> _INTER_BITS
        w4 = _bilinear_fixed_wtab()[
            sy & (_INTER_TAB_SIZE - 1), sx & (_INTER_TAB_SIZE - 1)
        ]  # [..., 4] int32 tap weights (00,01,10,11)

        bx = np.clip(ix, 0, w - 2)
        by = np.clip(iy, 0, h - 2)
        # assign each IN-RANGE true tap's integer weight to its fetched
        # slot (clipping only moves the anchor when a tap is out of range,
        # so in-range taps always land on slot 0/1 per axis)
        slots = np.zeros((4,) + ix.shape, np.int64)
        for ty in (0, 1):
            for tx in (0, 1):
                wt = w4[..., ty * 2 + tx]
                inb = ((iy + ty >= 0) & (iy + ty <= h - 1)
                       & (ix + tx >= 0) & (ix + tx <= w - 1))
                dy = iy + ty - by
                dx = ix + tx - bx
                for sdy in (0, 1):
                    for sdx in (0, 1):
                        hit = inb & (dy == sdy) & (dx == sdx)
                        slots[sdy * 2 + sdx] += np.where(hit, wt, 0)
        weights = slots.reshape(4, -1).astype(f32)
    elif mode == "float":
        ix = np.floor(mx).astype(np.int64)
        iy = np.floor(my).astype(np.int64)
        fx = mx.astype(f32) - ix.astype(f32)
        fy = my.astype(f32) - iy.astype(f32)

        bx = np.clip(ix, 0, w - 2)
        by = np.clip(iy, 0, h - 2)

        def axis_weights(i, f, b, n):
            # weight carried by fetched positions b and b+1 along one axis
            in0 = (i >= 0) & (i <= n - 1)
            in1 = (i + 1 >= 0) & (i + 1 <= n - 1)
            w_lo = (1 - f) * in0  # tap at i
            w_hi = f * in1  # tap at i+1
            pos0 = w_lo * (i == b) + w_hi * (i + 1 == b)
            pos1 = w_lo * (i == b + 1) + w_hi * (i + 1 == b + 1)
            return pos0.astype(f32), pos1.astype(f32)

        wx0, wx1 = axis_weights(ix, fx, bx, w)
        wy0, wy1 = axis_weights(iy, fy, by, h)
        weights = np.stack(
            [wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1]
        ).reshape(4, -1).astype(f32)
    else:
        raise ValueError(f"unknown remap mode [{mode}]")
    base = (by * w + bx).reshape(-1).astype(np.int32)
    # fully out-of-image output pixels (all four weights zero — ~10% of a
    # fisheye undistortion's corners) all point at row 0 instead of their
    # scattered clamped positions, so a gather hits one cached row
    # (bit-identical output)
    base[(weights == 0).all(axis=0)] = 0
    return base, weights


# ---------------------------------------------------------------------------
# Device remap (lerp mode)
# ---------------------------------------------------------------------------


def lerp_split(fx: torch.Tensor):
    """Dekker's split of fx into a high half of 12 bits and the rest, (fxh,
    fxl), shared by a pixel's two x-lerps."""
    C = 4097.0  # Dekker split constant (2^12 + 1)
    ca = fx * C
    fxh = ca - (ca - fx)
    return fxh, fx - fxh


def lerp_x(fx, fxh, fxl, v0, v1) -> torch.Tensor:
    """v0 + fx*(v1 - v0) with one rounding, emulated in plain f32 ops (the
    reference package's x-lerp): v0, v1 exact small integers, so Dekker's
    2Product needs no split of v1 - v0, and fx comes split (lerp_split)."""
    d = v1 - v0  # exact integer, |d| <= 255
    pp = fx * d
    err = (fxh * d - pp) + fxl * d
    ss = pp + v0
    bb = ss - pp
    e2 = (pp - (ss - bb)) + (v0 - bb)
    return ss + (e2 + err)


def remap_lerp_planes(planes, base: torch.Tensor, weights: torch.Tensor,
                      out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv::remap in lerp mode over a tuple of [B, H, W] u8 planes with
    remap_precompute(..., mode="lerp")'s base [N] int32 and weights [6, N]
    f32 = (fx, fy, mask00, mask01, mask10, mask11). Returns
    [B, Ho, Wo, C] u8.

    Tap origin: flat = base - (w+1) (the reference package's pack margin;
    fully out-of-image pixels carry base 0). The four taps sit at flat +
    {0, 1, w, w+1}; a tap whose mask is 0 contributes 0, and a tap with mask
    1 is always inside the frame, so reads are clamped into the frame and
    multiplied by their mask."""
    h, w = planes[0].shape[-2], planes[0].shape[-1]
    ho, wo = out_hw
    src = torch.stack([p.reshape(p.shape[0], h * w) for p in planes], dim=-1)  # [B, HW, C]
    flat = base.long() - (w + 1)
    fx = weights[0][None, :, None]
    fy = weights[1][None, :, None]

    def tap(off: int, k: int) -> torch.Tensor:
        idx = torch.clamp(flat + off, 0, h * w - 1)
        return src.index_select(1, idx).float() * weights[2 + k][None, :, None]

    v00, v01, v10, v11 = tap(0, 0), tap(1, 1), tap(w, 2), tap(w + 1, 3)
    fxh, fxl = lerp_split(fx)
    t = lerp_x(fx, fxh, fxl, v00, v01)
    b = lerp_x(fx, fxh, fxl, v10, v11)
    out = round_u8(fma_f32(fy, b - t, t))  # [B, N, C]
    return out.reshape(out.shape[0], ho, wo, out.shape[-1])


# ---------------------------------------------------------------------------
# Device remap (float and fixed32 modes)
# ---------------------------------------------------------------------------


def _anchor_taps(planes, base: torch.Tensor):
    """The four [B, N, C] f32 taps of remap_precompute(..., mode="float" or
    "fixed32"): flat positions base + {0, 1, w, w+1} (no pack margin; fully
    out-of-image pixels carry base 0 and four zero weights). A position
    outside [0, h*w) reads 0, as the reference package's zero-padded pack
    does for degenerate maps."""
    h, w = planes[0].shape[-2], planes[0].shape[-1]
    src = torch.stack([p.reshape(p.shape[0], h * w) for p in planes], dim=-1)  # [B, HW, C]
    base = base.long()
    taps = []
    for off in (0, 1, w, w + 1):
        idx = base + off
        inside = ((idx >= 0) & (idx < h * w))[None, :, None]
        t = src.index_select(1, torch.clamp(idx, 0, h * w - 1)).float()
        taps.append(torch.where(inside, t, 0.0))
    return taps


def remap_float_planes(planes, base: torch.Tensor, weights: torch.Tensor,
                       out_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain cv::remap in float mode over a tuple of [B, H, W] u8 planes
    with remap_precompute(..., mode="float")'s base [N] int32 and weights
    [4, N] f32. Returns [B, Ho, Wo, C] u8.

    The reference package's sealed blend: every product and sum is its own
    eager f32 op, so each rounds once ((t0*w0 + t1*w1) + t2*w2) + t3*w3 —
    no addcmul, no f64, no compiler that could contract them into fmas —
    then rint half-to-even and saturate."""
    t = _anchor_taps(planes, base)
    p = [t[k] * weights[k][None, :, None] for k in range(4)]
    acc = ((p[0] + p[1]) + p[2]) + p[3]
    out = round_u8(acc)
    return out.reshape(out.shape[0], *out_hw, out.shape[-1])


def remap_fixed32_planes(planes, base: torch.Tensor, weights: torch.Tensor,
                         out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv::remap in fixed32 mode (OpenCV's non-IPP integer blend) with
    remap_precompute(..., mode="fixed32")'s base [N] int32 and 2^15-scaled
    integer weights [4, N] f32. Every intermediate is an exact integer in
    f32, then floor((acc + 2^14) * 2^-15), saturated. Returns
    [B, Ho, Wo, C] u8."""
    t = _anchor_taps(planes, base)
    acc = sum(t[k] * weights[k][None, :, None] for k in range(4))
    v = torch.floor((acc + float(1 << (_REMAP_COEF_BITS - 1))) * (1.0 / _REMAP_COEF_SCALE))
    out = torch.clamp(v, 0, 255).to(torch.uint8)
    return out.reshape(out.shape[0], *out_hw, out.shape[-1])


FIXED32_ROWS = _INTER_TAB_SIZE * _INTER_TAB_SIZE  # codes [0, 1024): the weight table's rows
FIXED32_DEAD = FIXED32_ROWS  # code of a pixel whose four weights are 0
FIXED32_EXPLICIT = FIXED32_ROWS + 1  # code of a pixel whose weights are read from `weights`


def fixed32_table_rows() -> np.ndarray:
    """The rows of _bilinear_fixed_wtab as kernel F computes them from a
    code r = 32 * ay + ax: w00 = (32 - ay) * (32 - ax) * 32, w01 =
    (32 - ay) * ax * 32, w10 = ay * (32 - ax) * 32, w11 = ay * ax * 32
    (every entry of the table is that exact product: at 5 interpolation bits
    its rounding residual is 0). [1024, 4] int32."""
    ay, ax = np.divmod(np.arange(FIXED32_ROWS, dtype=np.int64), _INTER_TAB_SIZE)
    top, bottom = (_INTER_TAB_SIZE - ay) * 32, ay * 32
    return np.stack([top * (_INTER_TAB_SIZE - ax), top * ax, bottom * (_INTER_TAB_SIZE - ax),
                     bottom * ax], axis=1).astype(np.int32)


def remap_fixed32_code(weights: np.ndarray) -> np.ndarray:
    """Kernel F's compact fixed32 map: remap_precompute(..., mode="fixed32")'s
    weights [..., 4, N] (flat or stacked per camera) -> an int16 code [..., N]
    a pixel, the anchor staying in `base`. The code is the row r = 32 * ay +
    ax of cv::remap's weight table where the pixel's four weights are that
    row exactly (fixed32_table_rows), FIXED32_DEAD where they are all 0, and
    FIXED32_EXPLICIT for any other pixel (its anchor clipped at the border,
    or weights of no map of remap_precompute's): the kernel reads those
    pixels' weights from `weights`. remap_fixed32_decode inverts it."""
    wt = np.asarray(weights)
    if wt.ndim < 2 or wt.shape[-2] != 4:
        raise ValueError(f"weights: expected [..., 4, N], got {wt.shape}")
    w = np.moveaxis(wt, -2, -1).astype(np.float64)  # [..., N, 4]

    def index(s):  # ay from w10 + w11 = ay * 1024, ax from w01 + w11
        return np.clip(np.rint(np.nan_to_num(s / 1024, nan=0.0, posinf=0.0, neginf=0.0)), 0,
                       _INTER_TAB_SIZE - 1)

    ay, ax = index(w[..., 2] + w[..., 3]), index(w[..., 1] + w[..., 3])
    row = (ay * _INTER_TAB_SIZE + ax).astype(np.int64)
    exact = (fixed32_table_rows()[row] == w).all(axis=-1)
    dead = (w == 0).all(axis=-1)
    return np.where(exact, row, np.where(dead, FIXED32_DEAD, FIXED32_EXPLICIT)).astype(np.int16)


def remap_fixed32_decode(code: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """The weights [..., 4, N] f32 kernel F reads from a compact fixed32 map:
    a table row's computed entries, 0 for FIXED32_DEAD, the pixel's own
    column of `weights` for FIXED32_EXPLICIT. Equal to the weights that
    remap_fixed32_code coded."""
    code = np.asarray(code).astype(np.int64)
    rows = fixed32_table_rows()[np.minimum(code, FIXED32_ROWS - 1)]  # [..., N, 4]
    rows = np.moveaxis(rows, -1, -2).astype(np.float32)
    out = np.where((code < FIXED32_ROWS)[..., None, :], rows, np.asarray(weights, np.float32))
    return np.where((code == FIXED32_DEAD)[..., None, :], np.float32(0), out)


REMAP_TILE = (8, 64)  # E's and F's output tile (rows, columns): a block of REMAP_BLOCK threads
REMAP_BLOCK = 128  # kBlock in csrc/remap_tile.cuh
REMAP_MIN_BLOCKS = 7  # kMinBlocks of csrc/remap_tile.cuh (E; F's lerp 9, fixed32 8): blocks an SM
REMAP_WEIGHT_ROWS = {"float": 4, "lerp": 6, "fixed32": 4}  # weight rows a pixel, by mode


def remap_run_width(wo: int, out_ptr: int, base_ptr: int, weights_ptr: int,
                    code_ptr: int = 0) -> int:
    """Kernels E's and F's store width V for an output Wo pixels wide: 4
    where Wo and the output's address are multiples of 4 and the map (base
    and weights 16-byte aligned, a fixed32 code 8-byte aligned) allows it,
    so that each thread loads the map of its run of 4 pixels as vector words
    and stores the run's 4C bytes as C aligned 4-byte words in every frame;
    else 1 (byte stores)."""
    if (wo % 4 == 0 and out_ptr % 4 == 0 and base_ptr % 16 == 0 and weights_ptr % 16 == 0
            and code_ptr % 8 == 0):
        return 4
    return 1


def remap_frame_chunk(batch: int, threads: int, sms: int) -> int:
    """Frames per grid row of kernel E or F, whose threads each loop over a
    range of frames against one load of their map: all of them in one range
    where the `threads` of a frame's tiles fill a card of `sms` SMs
    (REMAP_MIN_BLOCKS resident blocks of REMAP_BLOCK threads each), else as
    many ranges as it takes, up to one frame each. The chains' frames
    (1080x1920, 1080x1440) fill an H100 alone, so they always run as one
    range; only small frames are split."""
    fill = sms * REMAP_MIN_BLOCKS * REMAP_BLOCK
    ranges = min(batch, max(1, -(-fill // max(threads, 1))))
    return -(-batch // ranges)


def remap_blocks(batch: int, cameras: int, chunk: int, n: int, rows: int = 4):
    """Kernel E's or F's grid rows as csrc/remap_tile.cuh reads them from
    blockIdx: for each camera z (grid z) and frame range y (grid y) of that
    camera's block of batch // cameras frames, (z, y, f0, f1, base offset,
    weights offset): the frames [f0, f1) of the camera-major batch that its
    blocks remap, through the map at base + z*n and weights + z*rows*n (n
    output pixels a map, `rows` weight rows a pixel: REMAP_WEIGHT_ROWS)."""
    per = batch // cameras
    return [(z, y, z * per + y * chunk, min(z * per + per, z * per + (y + 1) * chunk),
             z * n, z * rows * n)
            for z in range(cameras) for y in range(-(-per // chunk))]


def _remap_cuda(kernel, mode: str, planes, base, weights, out_hw, batch_limit: int,
                mode_args=(), code=None) -> torch.Tensor:
    """Check the arguments of kernel E or F and launch it (remap_launches):
    one or three contiguous [B, H, W] u8 CUDA planes, base [Ho*Wo] int32 and
    weights [k, Ho*Wo] f32 (k = REMAP_WEIGHT_ROWS[mode]) on the same card,
    or per-camera maps [C, Ho*Wo] and [C, k, Ho*Wo], and in fixed32 mode
    the compact code [(C,) Ho*Wo] int16 or None; mode_args (and the code's
    address, where the mode takes one) end the C entry's arguments before
    the stream."""
    if len(planes) not in (1, 3):
        raise ValueError(f"planes: expected 1 or 3, got {len(planes)}")
    shape = tuple(planes[0].shape)
    if len(shape) != 3:
        raise ValueError(f"planes: expected [B, H, W], got {shape}")
    for i, p in enumerate(planes):
        kernels.check_cuda(p, f"planes[{i}]", torch.uint8, shape)
    b, h, w = shape
    ho, wo = out_hw
    n = ho * wo
    c = len(planes)
    cameras = base.shape[0] if base.dim() == 2 else 1
    lead = (cameras,) if base.dim() == 2 else ()
    kernels.check_cuda(base, "base", torch.int32, lead + (n,))
    kernels.check_cuda(weights, "weights", torch.float32, lead + (REMAP_WEIGHT_ROWS[mode], n))
    if code is not None:
        kernels.check_cuda(code, "code", torch.int16, lead + (n,))
    if b % cameras:
        raise ValueError(f"planes: batch {b} is not a multiple of the {cameras} cameras' maps")
    out = torch.empty((b, ho, wo, c), dtype=torch.uint8, device=planes[0].device)
    if not n:
        return out
    tiles = -(-ho // REMAP_TILE[0]) * -(-wo // REMAP_TILE[1])
    sms = torch.cuda.get_device_properties(out.device).multi_processor_count
    with torch.cuda.device(out.device):
        for f0, nf, cams, z in remap_launches(b, cameras, batch_limit):
            zb, zw = (base, weights) if z is None else (base[z], weights[z])
            zc = code if code is None or z is None else code[z]
            code_ptr = () if mode == "float" else (None if zc is None else zc.data_ptr(),)
            ptrs = [p[f0].data_ptr() for p in planes]
            dst = out[f0]
            planes16 = w % 16 == 0 and all(p % 16 == 0 for p in ptrs)
            kernel.launch(
                *ptrs * (3 // c), zb.data_ptr(), zw.data_ptr(), dst.data_ptr(), cams,
                nf // cams, h, w, ho, wo, c,
                remap_run_width(wo, dst.data_ptr(), zb.data_ptr(), zw.data_ptr(),
                                zc.data_ptr() if zc is not None else 0),
                remap_frame_chunk(nf // cams, REMAP_BLOCK * tiles * cams, sms),
                int(planes16), *mode_args, *code_ptr, kernels.stream_handle(out),
            )
    return out


def remap_float_cuda(planes, base: torch.Tensor, weights: torch.Tensor,
                     out_hw: Tuple[int, int], *,
                     batch_limit: int = kernels.MAX_BATCH) -> torch.Tensor:
    """Kernel E: remap_float_planes for one or three contiguous [B, H, W] u8
    CUDA planes, base [Ho*Wo] int32 and weights [4, Ho*Wo] f32 on the same
    card, or per-camera maps base [C, Ho*Wo] and weights [C, 4, Ho*Wo] for
    a camera-major batch of C blocks of B/C frames (remap_blocks). Returns
    [B, Ho, Wo, C] u8, C = len(planes), in one launch where each camera's
    block and the cameras fit the grid (batch_limit frames, the grid's
    limit), else in the launches remap_launches lists."""
    return _remap_cuda(kernels.REMAP_FLOAT, "float", planes, base, weights, out_hw, batch_limit)


def remap_lerp_cuda(planes, base: torch.Tensor, weights: torch.Tensor,
                    out_hw: Tuple[int, int], *, mode: str,
                    batch_limit: int = kernels.MAX_BATCH,
                    code: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel F: remap_lerp_planes (mode="lerp", weights [6, Ho*Wo]) or
    remap_fixed32_planes (mode="fixed32", weights [4, Ho*Wo]) for one or
    three contiguous [B, H, W] u8 CUDA planes, with the map flat or stacked
    per camera and the launches as remap_float_cuda's (kernel E's). In
    fixed32 mode `code` ([Ho*Wo] or [C, Ho*Wo] int16 on the card,
    remap_fixed32_code of these weights) gives the compact map the kernel
    reads in place of the weights; without it the kernel reads every
    pixel's weights. Raises on CPU tensors: there the plain versions are
    the port's path."""
    if mode not in ("lerp", "fixed32"):
        raise ValueError(f"kernel F remaps in lerp or fixed32 mode, not [{mode}]")
    if code is not None and mode != "fixed32":
        raise ValueError("kernel F takes a compact code in fixed32 mode only")
    return _remap_cuda(kernels.REMAP_LERP, mode, planes, base, weights, out_hw, batch_limit,
                       (0 if mode == "lerp" else 1,), code)


def remap_launches(batch: int, cameras: int, limit: int = kernels.MAX_BATCH):
    """Kernel E's or F's launches for a camera-major batch of `cameras` blocks:
    (first frame, frames, cameras in the launch, camera index) each. One
    launch of every camera (grid z, camera index None: the stacked maps)
    where a block of batch // cameras frames and the cameras fit the grid's
    `limit`; else a launch for each camera and run of at most `limit` of
    its frames (kernels.batch_runs), through that camera's map, so that no
    launch straddles two cameras."""
    if not batch:
        return []
    per = batch // cameras
    if per <= limit and cameras <= limit:
        return [(0, batch, cameras, None)]
    return [(z * per + s, n, 1, z if cameras > 1 else None)
            for z in range(cameras) for s, n in kernels.batch_runs(per, limit)]


def remap_channel_groups(planes, remap_fn) -> torch.Tensor:
    """Remap any number of [B, H, W] planes through remap_fn, which takes
    one or three planes (kernels E's and F's contract) and returns [B, Ho, Wo, c]:
    groups of three planes, then single planes, stacked along the last axis
    in the planes' order. The channels are independent, so this equals one
    remap of all of them; one or three planes make one call."""
    if len(planes) in (1, 3):
        return remap_fn(tuple(planes))
    three = len(planes) // 3 * 3
    groups = [tuple(planes[i:i + 3]) for i in range(0, three, 3)]
    groups += [(p,) for p in planes[three:]]
    return torch.cat([remap_fn(g) for g in groups], dim=-1)


def remap_planes(planes, base: torch.Tensor, weights: torch.Tensor,
                 out_hw: Tuple[int, int], mode: str, plain: bool = False, *,
                 code: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The remap stage in `mode` ("lerp" | "float" | "fixed32"; base and
    weights from remap_precompute in the same mode, flat or stacked per
    camera, see the module's docstring; in fixed32 mode `code`, the compact
    map remap_fixed32_code makes of these weights, or None). On CUDA planes
    float mode goes through kernel E, lerp and fixed32 through kernel F
    (any number of planes, remap_channel_groups); on CPU planes, or with
    plain=True, each mode through its plain version (which reads the
    weights: the code is their shorthand)."""
    fns = {"lerp": remap_lerp_planes, "float": remap_float_planes,
           "fixed32": remap_fixed32_planes}
    if mode not in fns:
        raise ValueError(f"unknown remap mode [{mode}]")
    if not plain and planes[0].device.type != "cpu":
        if mode == "float":
            def kernel(group):
                return remap_float_cuda(group, base, weights, out_hw)
        else:
            def kernel(group):
                return remap_lerp_cuda(group, base, weights, out_hw, mode=mode, code=code)
        return remap_channel_groups(tuple(p.contiguous() for p in planes), kernel)
    if base.dim() == 1:
        return fns[mode](planes, base, weights, out_hw)
    # per-camera maps: camera c's block of frames through map c
    cams, b = base.shape[0], planes[0].shape[0]
    if b % cams:
        raise ValueError(f"planes: batch {b} is not a multiple of the {cams} cameras' maps")
    per = b // cams
    return torch.cat([fns[mode](tuple(p[c * per:(c + 1) * per] for p in planes), base[c],
                                weights[c], out_hw) for c in range(cams)])


# ---------------------------------------------------------------------------
# The reference package's entry points
# ---------------------------------------------------------------------------


def _check_src(h: int, w: int, src_hw) -> None:
    """base and weights index a source of src_hw: a frame of another size
    would be read with the wrong row stride."""
    if src_hw is not None and (h, w) != tuple(src_hw):
        raise ValueError(f"remap precomputed for source {tuple(src_hw)} but got frame "
                         f"({h}, {w}); rebuild the pipeline for this frame size")


def _remap_batch(planes, base, weights, out_hw, n_cameras: int, mode: str,
                 plain: bool) -> torch.Tensor:
    """[N, H, W] planes (camera-major over n_cameras blocks) -> [N, Ho, Wo, C]
    through remap_planes."""
    dev = planes[0].device
    base = as_tensor_on(base, dev, torch.int32)
    weights = as_tensor_on(weights, dev, torch.float32)
    if (base.dim() == 2) != (n_cameras > 1) or (n_cameras > 1 and base.shape[0] != n_cameras):
        raise ValueError(f"base {tuple(base.shape)}: expected [N] for one camera, "
                         f"[n_cameras, N] for {n_cameras}")
    return remap_planes(planes, base, weights, tuple(int(v) for v in out_hw), mode, plain)


# tuning and blend_impl pick the reference package's TPU gather pack and
# blend backend; every choice gives the same bytes and the port has one
# implementation, so both are accepted and ignored (the reference package
# too takes an unknown blend_impl without complaint: it blends by default)


def remap_bilinear_u8(image: torch.Tensor, base, weights, out_hw: Tuple[int, int],
                      src_hw: Tuple[int, int] | None = None, batch_minor: bool = False,
                      tuning: Tuple[int, int] | None = None, n_cameras: int = 1,
                      blend_impl: str | None = None, mode: str = "lerp", *,
                      plain: bool = False) -> torch.Tensor:
    """cv::remap(INTER_LINEAR, BORDER_CONSTANT, 0) with remap_precompute's
    (base, weights) in `mode`: [..., H, W, C] u8 -> [..., Ho, Wo, C] u8 for
    any C, or with batch_minor=True [H, W, ..., C] -> [Ho, Wo, ..., C].
    n_cameras > 1: image [n_cameras * B', H, W, C] camera-major (batch-minor:
    [H, W, n_cameras * B', C] -> [n_cameras, Ho, Wo, B', C], as the
    reference package returns it), base [n_cameras, N] and weights
    [n_cameras, k, N] stacked per camera. Float mode runs kernel E, lerp
    and fixed32 kernel F on a CUDA tensor (groups of three channels and
    single ones), the plain versions on a CPU tensor or with plain=True.
    tuning and blend_impl are accepted and ignored: they choose
    among the reference package's TPU implementations, which give the same
    bytes."""
    if image.dim() < 3:
        raise ValueError(f"image: expected [..., H, W, C], got {tuple(image.shape)}")
    if batch_minor:
        # [H, W, ..., C] -> [..., H, W, C] and back: the batch-major path
        if n_cameras > 1 and image.dim() != 4:
            raise ValueError(f"image: expected [H, W, n_cameras * B, C] for {n_cameras} "
                             f"cameras, got {tuple(image.shape)}")
        out = remap_bilinear_u8(image.movedim((0, 1), (-3, -2)), base, weights, out_hw,
                                src_hw, False, tuning, n_cameras, blend_impl, mode,
                                plain=plain)
        if n_cameras > 1:  # [n_cameras * B', Ho, Wo, C] -> [n_cameras, Ho, Wo, B', C]
            out = out.reshape((n_cameras, -1) + tuple(out.shape[1:])).permute(0, 2, 3, 1, 4)
            return out.contiguous()
        return out.movedim((-3, -2), (0, 1)).contiguous()
    h, w, c = image.shape[-3:]
    _check_src(h, w, src_hw)
    if n_cameras > 1 and image.dim() != 4:
        raise ValueError(f"image: expected [n_cameras * B, H, W, C] for {n_cameras} cameras, "
                         f"got {tuple(image.shape)}")
    lead = tuple(image.shape[:-3])
    flat = image.reshape((-1, h, w, c))
    out = _remap_batch(tuple(flat[..., k] for k in range(c)), base, weights, out_hw,
                       n_cameras, mode, plain)
    return out.reshape(lead + tuple(out.shape[1:]))


def remap_bilinear_u8_planes(planes, base, weights, out_hw: Tuple[int, int],
                             src_hw: Tuple[int, int] | None = None,
                             tuning: Tuple[int, int] | None = None, n_cameras: int = 1,
                             blend_impl: str | None = None, mode: str = "lerp", *,
                             plain: bool = False) -> torch.Tensor:
    """The reference package's planar remap, in its batch-minor layout: a
    tuple of C [H, W, ...] u8 planes -> [Ho, Wo, C, ...] u8; with
    n_cameras > 1 (planes [H, W, n_cameras * B'], camera-major) ->
    [n_cameras, Ho, Wo, C, B']. Same dispatch as remap_bilinear_u8, and
    tuning and blend_impl are ignored as there."""
    h, w = planes[0].shape[0], planes[0].shape[1]
    _check_src(h, w, src_hw)
    lead = tuple(planes[0].shape[2:])
    if n_cameras > 1 and len(lead) != 1:
        raise ValueError(f"planes: expected [H, W, n_cameras * B] for {n_cameras} cameras, "
                         f"got {tuple(planes[0].shape)}")
    batch = tuple(p.reshape(h, w, -1).permute(2, 0, 1) for p in planes)  # [N, H, W]
    out = _remap_batch(batch, base, weights, out_hw, n_cameras, mode, plain)  # [N, Ho, Wo, C]
    if n_cameras > 1:
        n = out.shape[0]
        return out.reshape((n_cameras, n // n_cameras) + tuple(out.shape[1:])) \
            .permute(0, 2, 3, 4, 1).contiguous()
    return out.permute(1, 2, 3, 0).reshape(tuple(out.shape[1:]) + lead).contiguous()


def remap_bilinear_u8_from_maps(image: torch.Tensor, map_x, map_y, mode: str = "lerp", *,
                                plain: bool = False) -> torch.Tensor:
    """remap_bilinear_u8 from cv2-style float32 maps (host arrays): the
    factors are precomputed on the host at every call (remap_precompute)."""
    h, w = image.shape[-3], image.shape[-2]
    mx, my = np.asarray(map_x), np.asarray(map_y)
    base, weights = remap_precompute(mx, my, (h, w), mode=mode)
    return remap_bilinear_u8(image, base, weights, mx.shape, mode=mode, plain=plain)
