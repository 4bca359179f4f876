"""cv2-compatible INTER_LINEAR resize for uint8 planes — bit-exact at ANY
scale ratio (PyTorch port of raw_image_pipeline_tpu/ops/resize.py).

Replicates OpenCV's 8u fixed-point bilinear resize (imgproc resize.cpp):

  * source coordinate ``fx = (float)((dx+0.5)*scale_x - 0.5)`` — the
    product/subtract run in double and are then narrowed to FLOAT;
    ``sx = cvFloor(fx); fx -= sx`` in float;
  * border overrides: ``sx < 0 -> sx=0, fx=0``;
    ``sx >= src-1 -> sx=src-1, fx=0`` (second tap weight 0);
  * the two 11-bit coefficients are quantized INDEPENDENTLY —
    ``a0 = cvRound((1.f-fx)*2048.f)``, ``a1 = cvRound(fx*2048.f)``;
  * horizontal pass accumulates ``S[sx]*a0 + S[sx+1]*a1`` in int32 with NO
    descale; the 8u vertical pass is OpenCV's truncating form
    ``uchar((((b0*(S0>>4)) >> 16) + ((b1*(S1>>4)) >> 16) + 2) >> 2)``.

The host tables (`_coords`, `_quant`, `_tables_x`, `_tables_y`) are copied
verbatim and held equal to the originals by tests/test_torch_ops.py. The
device form is the plain one: two row selects, two column selects and the
integer multiply-adds, horizontal pass first (the truncating vertical
shifts do not commute).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _coords(src: int, dst: int):
    """fx/sx per OpenCV resize.cpp: scale = 1/(dst/src) in double,
    fx = (float)((dx+0.5)*scale - 0.5), sx = cvFloor(fx), fx -= sx."""
    scale = 1.0 / (dst / src)                          # 1./inv_scale, double
    x = np.arange(dst, dtype=np.float64)
    fxf = ((x + 0.5) * scale - 0.5).astype(np.float32)  # (float) cast
    sx = np.floor(fxf).astype(np.int64)                # cvFloor of the float
    f = (fxf - sx.astype(np.float32)).astype(np.float32)  # fx -= sx (float)
    return sx, f


def _quant(f):
    """saturate_cast<short>((1.f-fx)*2048.f), saturate_cast<short>(fx*2048.f):
    both products in f32, cvRound = half-even; quantized INDEPENDENTLY (the
    pair sums to 2047/2048/2049, not always 2048)."""
    a1 = np.rint(f * np.float32(2048.0)).astype(np.int32)
    a0 = np.rint((np.float32(1.0) - f) * np.float32(2048.0)).astype(np.int32)
    return a0, a1


def _tables_x(src: int, dst: int):
    """Horizontal tables: OpenCV overrides the border coefficients
    (sx < 0 -> sx=0, fx=0; sx >= src-1 -> sx=src-1, fx=0)."""
    sx, f = _coords(src, dst)
    left = sx < 0
    f = np.where(left, np.float32(0.0), f)
    sx = np.where(left, 0, sx)
    right = sx >= src - 1
    f = np.where(right, np.float32(0.0), f)
    sx = np.where(right, src - 1, sx)
    a0, a1 = _quant(f)
    sx2 = np.minimum(sx + 1, src - 1)  # weight-0 tap at the right border
    return sx.astype(np.int32), sx2.astype(np.int32), a0, a1


def _tables_y(src: int, dst: int):
    """Vertical tables: NO coefficient override — resizeGeneric_ clamps the
    row POINTERS (srows[k] = ptr(clip(sy+k))) but keeps the raw quantized
    (1-fy, fy) weights, so an upsample's first/last rows blend the edge row
    with itself using fy's unclamped fractional part (fy can come from a
    negative coordinate). Reproducing that asymmetry is what makes upsample
    border rows bit-exact."""
    sy, f = _coords(src, dst)
    b0, b1 = _quant(f)
    sy0 = np.clip(sy, 0, src - 1)
    sy1 = np.clip(sy + 1, 0, src - 1)
    return sy0.astype(np.int32), sy1.astype(np.int32), b0, b1


@functools.lru_cache(maxsize=16)
def _tables_on(src_h: int, src_w: int, dst_h: int, dst_w: int, device: str):
    """The x and y tables on `device`: index tables int64, weights int32."""
    sx, sx2, a0, a1 = _tables_x(src_w, dst_w)
    sy, sy2, b0, b1 = _tables_y(src_h, dst_h)
    idx = lambda a: torch.as_tensor(a, device=device).long()  # noqa: E731
    wt = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (idx(sx), idx(sx2), wt(a0), wt(a1)), (idx(sy), idx(sy2), wt(b0), wt(b1))


@functools.lru_cache(maxsize=64)
def _rows_on(src_h: int, src_w: int, dst_h: int, dst_w: int, device: str,
             y0: int, y1: int, row0: int):
    """_tables_on's tables for the output rows [y0, y1), their source rows
    counted from the frame's row row0 (the whole tables for the whole
    frame)."""
    x, (sy, sy2, b0, b1) = _tables_on(src_h, src_w, dst_h, dst_w, device)
    if (y0, y1, row0) == (0, dst_h, 0):
        return x, (sy, sy2, b0, b1)
    return x, (sy[y0:y1] - row0, sy2[y0:y1] - row0, b0[y0:y1], b1[y0:y1])


def resize_linear_u8_plane(img: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    """[..., H, W] uint8 -> [..., dst_h, dst_w] uint8, bit-exact vs
    cv::resize(INTER_LINEAR). Only the rows the vertical pass reads go
    through the horizontal pass (identical values, fewer operations)."""
    return resize_linear_u8_rows(img, img.shape[-2], dst_h, dst_w, 0, dst_h, 0)


def resize_linear_u8(image: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    """[..., H, W, C] uint8 -> [..., dst_h, dst_w, C] uint8, each channel
    through resize_linear_u8_plane."""
    if image.dim() < 3:
        raise ValueError(f"image: expected [..., H, W, C], got {tuple(image.shape)}")
    out = resize_linear_u8_plane(image.movedim(-1, 0), dst_h, dst_w)
    return out.movedim(0, -1).contiguous()


def resize_linear_u8_rows(img: torch.Tensor, src_h: int, dst_h: int, dst_w: int,
                          y0: int, y1: int, row0: int) -> torch.Tensor:
    """Rows [y0, y1) of the resize of an src_h-row frame to dst_h x dst_w,
    from `img` [..., h, W], the frame's rows [row0, row0 + h) (which must
    hold every source row those output rows read): [..., y1 - y0, dst_w]
    uint8, equal to those rows of resize_linear_u8_plane of the frame."""
    (sx, sx2, a0, a1), (sy, sy2, b0, b1) = _rows_on(
        src_h, img.shape[-1], dst_h, dst_w, str(img.device), y0, y1, row0
    )

    def horiz(rows: torch.Tensor) -> torch.Tensor:  # int32 [..., rows, dst_w]
        return (rows.index_select(-1, sx).to(torch.int32) * a0
                + rows.index_select(-1, sx2).to(torch.int32) * a1)

    s0 = horiz(img.index_select(-2, sy)) >> 4
    s1 = horiz(img.index_select(-2, sy2)) >> 4
    acc = (((b0[:, None] * s0) >> 16) + ((b1[:, None] * s1) >> 16) + 2) >> 2
    # the arithmetic cannot exceed 255; clamp is a guard
    return torch.clamp(acc, 0, 255).to(torch.uint8)
