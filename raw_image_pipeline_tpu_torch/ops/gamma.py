"""Gamma correction via 256-entry LUT (reference: modules/gamma_correction.cpp:35-60;
PyTorch port of raw_image_pipeline_tpu/ops/gamma.py).

The reference builds lut[i] = saturate_cast<uchar>(pow(i/255, k) * 255) and
applies it with cv::LUT. Its GPU backend's "default" method is NPP's fixed
ITU-R BT.709 curve instead (`build_bt709_lut`). The port applies either
exact host table (`apply_lut`; `gamma_correct` and `gamma_apply_bt709` on
frames): a u8 table on a u8 CUDA tensor by kernel O (csrc/lut.cu,
`lut_cuda`), otherwise (a CPU tensor, plain=True, other dtypes) as a
gather, O's plain version.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from raw_image_pipeline_tpu_torch import kernels
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


LUT_CHUNK = 16  # csrc/lut.cu: the bytes of a body chunk, one load and one store


def lut_split(addr: int, n: int) -> Tuple[int, int, int]:
    """(head, body, tail) of a row of n bytes at address addr as kernel O
    splits it: head bytes up to the first 16-byte boundary (at most n),
    body whole LUT_CHUNK-byte chunks, tail the bytes after them (< 16)."""
    head = min(n, -addr % LUT_CHUNK)
    body = (n - head) // LUT_CHUNK
    return head, body, n - head - LUT_CHUNK * body


def lut_layout(shape, strides) -> Optional[Tuple[int, int, int, int, int]]:
    """(rows, width, h, sb, sy): the rows of contiguous bytes over which
    kernel O reads a u8 tensor of `shape` and `strides` (elements = bytes),
    row r at (r // h) * sb + (r % h) * sy; its output is the rows one after
    the other, the tensor's shape contiguous. A contiguous tensor is one
    row (the flat path). Otherwise the last axis must have stride 1, the
    axes before it whose strides continue it join the row, and the axes
    left, merged where one continues the next, must be at most two: a frame
    axis (sb) and a row axis (h rows, sy). The mesh's row slabs of [N, H, W]
    frames are a row a frame; a crop of columns is a row a frame's row.
    None where the strides do not allow that (the caller copies first)."""
    dims = [(n, s) for n, s in zip(shape, strides) if n != 1]
    expect, contiguous = 1, True
    for n, s in reversed(dims):
        contiguous &= s == expect
        expect *= n
    if contiguous:
        return 1, math.prod(shape), 1, 0, 0
    if dims[-1][1] != 1:
        return None
    width = dims[-1][0]
    rest = dims[:-1]
    while rest and rest[-1][1] == width:  # whole rows continue the row
        width *= rest.pop()[0]
    axes = []
    for n, s in rest:  # outer to inner
        if axes and axes[-1][1] == s * n:  # the outer axis steps over the inner one
            axes[-1] = (axes[-1][0] * n, s)
        else:
            axes.append((n, s))
    if len(axes) == 1:
        return axes[0][0], width, 1, axes[0][1], 0
    if len(axes) == 2:
        (frames, sb), (h, sy) = axes
        return frames * h, width, h, sb, sy
    return None


def lut_cuda(x: torch.Tensor, lut) -> torch.Tensor:
    """Kernel O: lut[x] for a u8 CUDA tensor of any shape and a [256] u8
    table (ops/gamma.apply_lut's path on the card), into a new contiguous
    tensor of x's shape; one launch. x is read where it lies through
    lut_layout's rows (a tensor whose strides it does not take is copied
    first)."""
    if x.device.type != "cuda" or x.dtype != torch.uint8:
        raise ValueError(f"kernel O: expected a uint8 CUDA tensor, got {x.dtype} on "
                         f"{x.device}")
    table = as_tensor_on(lut, x.device).contiguous()
    kernels.check_cuda(table, "lut", torch.uint8, (256,))
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.numel() == 0:
        return out
    layout = lut_layout(x.shape, x.stride())
    if layout is None:
        x = x.contiguous()
        layout = lut_layout(x.shape, x.stride())
    with torch.cuda.device(x.device):
        kernels.LUT.launch(x.data_ptr(), out.data_ptr(), table.data_ptr(), *layout,
                           kernels.stream_handle(out))
    return out


def apply_lut(image: torch.Tensor, lut, *, plain: bool = False) -> torch.Tensor:
    """lut[image] for u8 frames or planes of any shape and a 256-entry table
    (a tensor, moved to the image's device if elsewhere, or an array), in
    the table's dtype: kernel O (lut_cuda) for a u8 table on a u8 CUDA
    image, else (a CPU image, plain=True, other dtypes) the gather, O's
    plain version."""
    table = as_tensor_on(lut, image.device)
    if (not plain and image.device.type == "cuda" and image.dtype == torch.uint8
            and table.dtype == torch.uint8):
        return lut_cuda(image, table)
    return table[image.long()]


def gamma_correct(image: torch.Tensor, k: float, *, plain: bool = False) -> torch.Tensor:
    """The reference's gamma LUT for exponent k on u8 frames of any shape."""
    return apply_lut(image, build_gamma_lut(k), plain=plain)


def gamma_apply_bt709(image: torch.Tensor, forward: bool, *, plain: bool = False) -> torch.Tensor:
    """The GPU backend's "default" gamma (the fixed BT.709 curve, k ignored)
    on u8 frames of any shape, as its exact host table."""
    return apply_lut(image, build_bt709_lut(forward), plain=plain)
