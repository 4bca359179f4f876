"""Gamma correction via 256-entry LUT (reference: modules/gamma_correction.cpp:35-60;
PyTorch port of raw_image_pipeline_tpu/ops/gamma.py).

The reference builds lut[i] = saturate_cast<uchar>(pow(i/255, k) * 255) and
applies it with cv::LUT. Its GPU backend's "default" method is NPP's fixed
ITU-R BT.709 curve instead (`build_bt709_lut`). The port applies either
exact host table as a gather.
"""

from __future__ import annotations

import math

import numpy as np
import torch


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


def apply_lut(plane: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table[plane] for a u8 plane and a 256-entry table on its device."""
    return table[plane.long()]
