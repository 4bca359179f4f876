"""Shared fixed-point helpers matching OpenCV integer conventions (PyTorch
port of raw_image_pipeline_tpu/ops/common.py).

Every helper is plain eager torch: each op rounds on its own, so the
two-rounding chains and the Dekker emulation below keep their semantics on
any device (no fused op such as addcmul or lerp may be used inside them).
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """torch.device(device); raises RuntimeError for a CUDA device where
    none is available (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device [{dev}] requested but no CUDA device is available")
    return dev


def descale(x: torch.Tensor, n: int) -> torch.Tensor:
    """OpenCV CV_DESCALE: (x + (1 << (n-1))) >> n (round half up for x>=0)."""
    return (x + (1 << (n - 1))) >> n


def avg2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b + 1) >> 1 in integer dtype (OpenCV bilinear demosaic rounding)."""
    return (a + b + 1) >> 1


def avg4(a, b, c, d) -> torch.Tensor:
    """(a + b + c + d + 2) >> 2 (OpenCV bilinear demosaic rounding)."""
    return (a + b + c + d + 2) >> 2


def saturate_u8(x: torch.Tensor) -> torch.Tensor:
    """Clamp an integer or float tensor to [0, 255] and cast to uint8."""
    return torch.clamp(x, 0, 255).to(torch.uint8)


def round_u8(x: torch.Tensor) -> torch.Tensor:
    """OpenCV saturate_cast<uchar>(float): rint (half-to-even) then clamp.
    torch.round rounds half to even, like cvRound on x86."""
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """rnd32(a*b + c) with a SINGLE rounding, emulated from plain f32
    mul/add/sub (Dekker 2Product + TwoSum), op for op the reference
    package's common.fma_f32. All three operands are f32 tensors of
    broadcast-compatible shapes."""
    C = 4097.0  # 2^12 + 1 Dekker split constant
    ca = a * C
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = b * C
    bhi = cb - (cb - b)
    blo = b - bhi
    p = a * b
    err = (((ahi * bhi - p) + ahi * blo) + alo * bhi) + alo * blo
    # TwoSum(p, c) — branch-free exact error of the rounded sum
    s = p + c
    bb = s - p
    e2 = (p - (s - bb)) + (c - bb)
    return s + (e2 + err)


def gains_tables_8p8(gains: torch.Tensor) -> torch.Tensor:
    """[B, 3] int32 gains in 8.8 fixed point -> [B, 3, 256] u8 tables
    v -> clamp((v * gain) >> 8, 0, 255) (the grey-world and learned
    methods' truncating descale, as a per-frame table)."""
    v = torch.arange(256, dtype=torch.int32, device=gains.device)
    return torch.clamp((v * gains[..., None].to(torch.int32)) >> 8, 0, 255).to(torch.uint8)


def image_planes(image: torch.Tensor):
    """[..., H, W, 3] frames -> (the leading shape, three planes [N, H, W]),
    N the product of the leading dims: how the NHWC entry points hand
    frames to the planar cores."""
    if image.dim() < 3 or image.shape[-1] != 3:
        raise ValueError(f"image: expected [..., H, W, 3], got {tuple(image.shape)}")
    lead = tuple(image.shape[:-3])
    flat = image.reshape((-1,) + tuple(image.shape[-3:]))
    return lead, (flat[..., 0], flat[..., 1], flat[..., 2])


def planes_image(planes, lead) -> torch.Tensor:
    """Planes [N, H, W] -> [*lead, H, W, C]."""
    out = torch.stack(tuple(planes), dim=-1)
    return out.reshape(tuple(lead) + tuple(out.shape[1:]))


def as_tensor_on(x, device, dtype=None) -> torch.Tensor:
    """x (a tensor, numpy array, sequence or number) as a tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)
