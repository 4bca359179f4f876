"""Polynomial vignetting correction (reference: modules/vignetting_correction.cpp;
PyTorch port of raw_image_pipeline_tpu/ops/vignetting.py).

Mask: k(r) = a2*r^2 + a4*r^4 with r the distance from the image center,
normalized by its max, scaled, plus one (vignetting_correction.cpp:32-63).
Apply: BGR -> Lab, L(float32) * mask, saturate back to u8, Lab -> BGR
(vignetting_correction.cpp:68-93). The mask is built once on the host
(float64, like the reference's double loop; a verbatim copy).

When the gamma stage feeds straight into vignetting, the two 256-entry maps
compose into one exact table, ctab[i] = LAB_GAMMA_TAB[gamma_lut_k[i]]
(`composed_gamma_lab_table`), used as the Lab forward's linearize table.
"""

from __future__ import annotations

import numpy as np
import torch

from raw_image_pipeline_tpu_torch.ops.colorspace import (
    _GAMMA_TAB,
    bgr_to_lab_planes,
    lab_to_bgr_planes,
)
from raw_image_pipeline_tpu_torch.ops.common import as_tensor_on, round_u8
from raw_image_pipeline_tpu_torch.ops.gamma import build_gamma_lut


def build_vignetting_mask(height: int, width: int, scale: float, a2: float, a4: float) -> np.ndarray:
    """[H, W] float32 multiplier mask (host-side, init time)."""
    cy = height / 2.0
    cx = width / 2.0
    y = np.arange(height, dtype=np.float64)[:, None]
    x = np.arange(width, dtype=np.float64)[None, :]
    r2 = (y - cy) ** 2 + (x - cx) ** 2
    k = r2 * a2 + r2 * r2 * a4
    mx = k.max()
    if mx > 0:
        k = k / mx
    k = k * scale + 1.0
    return k.astype(np.float32)


def composed_gamma_lab_table(k: float) -> np.ndarray:
    """Exact int32 [256] table: the reference gamma LUT, then OpenCV's Lab
    sRGB-linearize table."""
    return _GAMMA_TAB[build_gamma_lut(k).astype(np.int64)].astype(np.int32)


def correct_planes(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor,
                   mask: torch.Tensor, gamma_tab: torch.Tensor | None = None):
    """Three u8 planes + broadcast-compatible f32 mask -> three u8 planes.
    gamma_tab: the composed gamma∘linearize table (int32 [256]) when the
    gamma stage is folded in, else None (the plain sRGB linearize)."""
    L, a, bb = bgr_to_lab_planes(b, g, r, gamma_tab=gamma_tab)
    L = round_u8(L.float() * mask)
    return lab_to_bgr_planes(L, a, bb)


def correct(image: torch.Tensor, mask, *, plain: bool = False) -> torch.Tensor:
    """[..., H, W, 3] u8 BGR frames and an [H, W] f32 mask (tensor or
    array) -> the same: the exact Lab roundtrip with L scaled by the mask.
    On a CUDA tensor kernel G's vignetting step (ops/pointwise); on a CPU
    tensor, or with plain=True, correct_planes."""
    if image.dim() < 3 or image.shape[-1] != 3:
        raise ValueError(f"image: expected [..., H, W, 3], got {tuple(image.shape)}")
    m = as_tensor_on(mask, image.device, torch.float32)
    if not plain and image.device.type != "cpu":
        from raw_image_pipeline_tpu_torch.ops.pointwise import pointwise_image

        return pointwise_image(image, mask=m)
    return torch.stack(correct_planes(image[..., 0], image[..., 1], image[..., 2], m), dim=-1)
