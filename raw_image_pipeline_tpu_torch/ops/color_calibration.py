"""3x3 affine color calibration (reference: modules/color_calibration.cpp:91-104;
PyTorch port of raw_image_pipeline_tpu/ops/color_calibration.py).

cv::gemm's K=3 kernel is the PLAIN left-associative chain
rn(rn(rn(b*m0) + rn(g*m1)) + rn(r*m2)), then + bias and cv::Mat::convertTo's
cvRound (half-to-even) + saturate. Eager torch rounds every op on its own,
so the chain keeps its roundings on any device without the reference
package's sealing trick.
"""

from __future__ import annotations

import torch

from raw_image_pipeline_tpu_torch.ops.common import as_tensor_on, round_u8


def color_correct_planes(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor,
                         matrix: torch.Tensor, bias: torch.Tensor):
    """Three u8 planes -> three u8 planes. matrix [3, 3] f32 (rows produce
    output B, G, R from input B, G, R), bias [3] f32."""
    bf, gf, rf = b.float(), g.float(), r.float()
    return tuple(
        round_u8(((bf * matrix[o, 0] + gf * matrix[o, 1]) + rf * matrix[o, 2])
                 + bias[o])
        for o in range(3)
    )


def color_correct(image: torch.Tensor, matrix, bias, *, plain: bool = False) -> torch.Tensor:
    """[..., H, W, 3] u8 BGR frames -> the same, through
    color_correct_planes. matrix [3, 3] and bias [3] f32 (tensors or
    arrays). On a CUDA tensor kernel G's colour-calibration step
    (ops/pointwise); on a CPU tensor, or with plain=True, the plain chain."""
    if image.dim() < 3 or image.shape[-1] != 3:
        raise ValueError(f"image: expected [..., H, W, 3], got {tuple(image.shape)}")
    m = as_tensor_on(matrix, image.device, torch.float32).reshape(3, 3)
    b = as_tensor_on(bias, image.device, torch.float32).reshape(3)
    if not plain and image.device.type != "cpu":
        from raw_image_pipeline_tpu_torch.ops.pointwise import pointwise_image

        return pointwise_image(image, matrix=m, bias=b)
    return torch.stack(color_correct_planes(image[..., 0], image[..., 1], image[..., 2], m, b),
                       dim=-1)
