"""Gamma correction via 256-entry LUT (reference: modules/gamma_correction.cpp:35-60;
PyTorch port of raw_image_pipeline_tpu/ops/gamma.py).

The reference builds lut[i] = saturate_cast<uchar>(pow(i/255, k) * 255) and
applies it with cv::LUT. Its GPU backend's "default" method is NPP's fixed
ITU-R BT.709 curve instead (`build_bt709_lut`). The port applies either
exact host table (`apply_lut`; `gamma_correct` and `gamma_apply_bt709` on
frames): a u8 table on a u8 CUDA tensor by kernel G's table step on one
plane (ops/pointwise.lut_cuda), otherwise (a CPU tensor, plain=True, other
dtypes) as a gather.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from raw_image_pipeline_tpu_torch.ops.common import as_tensor_on


def build_gamma_lut(k: float) -> np.ndarray:
    """256-entry uint8 LUT, replicating the reference's float arithmetic:
    f = (float)(i/255.0); f = pow(f, k); lut[i] = cvRound(f * 255.0)."""
    i = np.arange(256, dtype=np.float64) / 255.0
    # libm pow (= the reference's std::pow), not np.power: numpy's SIMD
    # f64 pow can differ in the last ulp (no u8-visible case found over a
    # 441-value k sweep, but 256 scalar calls make the class impossible)
    f = np.array([math.pow(v, k) for v in i], np.float64).astype(np.float32)
    vals = np.rint(f.astype(np.float64) * 255.0)
    return np.clip(vals, 0, 255).astype(np.uint8)


def build_bt709_lut(forward: bool) -> np.ndarray:
    """The GPU backend's "default" gamma: cv::cuda::gammaCorrection is NPP's
    nppiGammaFwd/Inv_8u_C3IR, a FIXED ITU-R BT.709 transfer curve that
    ignores k; only the direction comes from k, forward = (k <= 1.0)
    (gamma_correction.cpp:29-33, 66-74). A verbatim copy of the reference
    package's table:
    forward  X < 0.018 ? 4.5*X : 1.099*X^0.45 - 0.099,
    inverse  Y < 0.081 ? Y/4.5 : ((Y+0.099)/1.099)^(1/0.45),
    rounded to nearest u8."""
    x = np.arange(256, dtype=np.float64) / 255.0
    if forward:
        y = np.where(x < 0.018, 4.5 * x, np.array([1.099 * math.pow(v, 0.45) for v in x]) - 0.099)
    else:
        y = np.where(x < 0.081, x / 4.5, np.array([math.pow((v + 0.099) / 1.099, 1.0 / 0.45) for v in x]))
    return np.clip(np.rint(y * 255.0), 0, 255).astype(np.uint8)


def apply_lut(image: torch.Tensor, lut, *, plain: bool = False) -> torch.Tensor:
    """lut[image] for u8 frames or planes of any shape and a 256-entry table
    (a tensor, moved to the image's device if elsewhere, or an array), in
    the table's dtype: kernel G for a u8 table on a u8 CUDA image, else
    (a CPU image, plain=True) the gather."""
    table = as_tensor_on(lut, image.device)
    if (not plain and image.device.type == "cuda" and image.dtype == torch.uint8
            and table.dtype == torch.uint8):
        from raw_image_pipeline_tpu_torch.ops.pointwise import lut_cuda

        return lut_cuda(image, table)
    return table[image.long()]


def gamma_correct(image: torch.Tensor, k: float, *, plain: bool = False) -> torch.Tensor:
    """The reference's gamma LUT for exponent k on u8 frames of any shape."""
    return apply_lut(image, build_gamma_lut(k), plain=plain)


def gamma_apply_bt709(image: torch.Tensor, forward: bool, *, plain: bool = False) -> torch.Tensor:
    """The GPU backend's "default" gamma (the fixed BT.709 curve, k ignored)
    on u8 frames of any shape, as its exact host table."""
    return apply_lut(image, build_bt709_lut(forward), plain=plain)
