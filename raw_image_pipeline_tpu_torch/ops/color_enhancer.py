"""HSV color enhancement (reference: modules/color_enhancer.cpp:38-47;
PyTorch port of raw_image_pipeline_tpu/ops/color_enhancer.py).

BGR -> HSV (u8), per-channel gain multiply with cv::multiply rounding,
HSV -> BGR. cv::multiply(u8, Scalar) forms each product in DOUBLE and
cvRounds it, so each channel's gain is served as its exact f64 table
clip(rint(i*g)) for the 256 u8 values (the values the reference package's
f32 multiply plus `gain_corrections` restores).

cv2's HSV->BGR runs TWO row kernels: the 32-px SIMD vector kernel (final
*255 truncated) and the scalar tail kernel for the last `width % 32`
pixels of every row (final *255 rounded); whole rows below 32 px are all
scalar. Both are replicated (ops/colorspace) and mixed here by column.
"""

from __future__ import annotations

import numpy as np
import torch

from raw_image_pipeline_tpu_torch.ops.colorspace import (
    bgr_to_hsv_planes,
    hsv_to_bgr_planes,
    hsv_to_bgr_planes_scalar,
)

# cv2's row-vector width in PIXELS for the u8 HSV->BGR kernel (x86 AVX2
# build of the cv2 5.0 oracle)
CV_SIMD_PX = 32


def gain_tables(gains) -> np.ndarray:
    """[3, 256] uint8: cv::multiply's clip(rint(i * g)) in f64 for the
    (H, S, V) gains."""
    i = np.arange(256, dtype=np.float64)
    return np.stack([
        np.clip(np.rint(i * g), 0, 255) for g in np.asarray(gains, np.float64)
    ]).astype(np.uint8)


def _hsv_to_bgr_mixed(h, s, v):
    """cv2's per-row kernel mix over the last (W) axis: SIMD columns then
    the scalar tail."""
    w = h.shape[-1]
    t = w % CV_SIMD_PX
    if t == 0:
        return hsv_to_bgr_planes(h, s, v)
    if t == w:  # width < 32: all scalar
        return hsv_to_bgr_planes_scalar(h, s, v)
    hd = hsv_to_bgr_planes(h[..., :w - t], s[..., :w - t], v[..., :w - t])
    tl = hsv_to_bgr_planes_scalar(h[..., w - t:], s[..., w - t:], v[..., w - t:])
    return tuple(torch.cat([a, b], dim=-1) for a, b in zip(hd, tl))


def enhance_planes(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor,
                   tables: torch.Tensor):
    """Three [..., H, W] u8 planes -> three u8 planes. tables: [3, 256]
    uint8 gain tables (gain_tables) on the planes' device."""
    h, s, v = bgr_to_hsv_planes(b, g, r)
    hs = tables[0][h.long()]
    ss = tables[1][s.long()]
    vs = tables[2][v.long()]
    return _hsv_to_bgr_mixed(hs, ss, vs)


def enhance(image: torch.Tensor, gains, *, plain: bool = False) -> torch.Tensor:
    """[..., H, W, 3] u8 BGR frames -> the same, with three host float gains
    (hue, saturation, value) served as their exact tables (gain_tables).
    On a CUDA tensor kernel G's enhancer step (ops/pointwise); on a CPU
    tensor, or with plain=True, enhance_planes."""
    if image.dim() < 3 or image.shape[-1] != 3:
        raise ValueError(f"image: expected [..., H, W, 3], got {tuple(image.shape)}")
    tables = torch.as_tensor(gain_tables(gains), device=image.device)
    if not plain and image.device.type != "cpu":
        from raw_image_pipeline_tpu_torch.ops.pointwise import pointwise_image

        return pointwise_image(image, enhancer_tables=tables)
    return torch.stack(enhance_planes(image[..., 0], image[..., 1], image[..., 2], tables),
                       dim=-1)
