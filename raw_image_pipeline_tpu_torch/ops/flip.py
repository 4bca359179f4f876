"""Flip / rotation (reference: modules/flip.cpp:37-58; PyTorch port of
raw_image_pipeline_tpu/ops/flip.py).

angle 90  -> clockwise rotation        (cv::transpose + flip(1))
angle 180 -> both-axis flip            (cv::flip(-1))
angle 270 -> counter-clockwise         (cv::transpose + flip(0))
any other angle is a no-op.

On a CUDA tensor the flip is kernel N (csrc/flip.cu, flip_cuda), which
writes only the flipped frame's rows it is asked for and takes up to three
planes in one launch; on a CPU tensor, or with plain=True, its plain
version flip_rows_plain (torch.flip of torch.transpose).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from raw_image_pipeline_tpu_torch import kernels

# How each Bayer mosaic pattern transforms under the three rotations, i.e.
# debayer_P(x) then rotate == rotate(x) then debayer_PERM[angle][P] — an
# exact identity for spatially symmetric demosaic stencils on even-sized
# frames. The pipeline uses it to flip the 1-channel raw mosaic instead of
# the three colour planes.
_BAYER_FLIP_PERM = {
    90: {"bggr": "gbrg", "gbrg": "rggb", "grbg": "bggr", "rggb": "grbg"},
    180: {"bggr": "rggb", "gbrg": "grbg", "grbg": "gbrg", "rggb": "bggr"},
    270: {"bggr": "grbg", "gbrg": "bggr", "grbg": "rggb", "rggb": "gbrg"},
}


def flipped_bayer_encoding(encoding: str, angle: int) -> Optional[str]:
    """The Bayer encoding that demosaics a rotated mosaic to the rotation of
    the original demosaic (None when no exact equivalent applies)."""
    if angle not in _BAYER_FLIP_PERM:
        return None
    if not (encoding.startswith("bayer_") and encoding.endswith("8")):
        return None  # 8-bit patterns only (the verified set)
    pat = encoding[len("bayer_"):-1]
    if pat not in _BAYER_FLIP_PERM[angle]:
        return None
    return f"bayer_{_BAYER_FLIP_PERM[angle][pat]}8"


def flipped_shape(h: int, w: int, angle: int) -> Tuple[int, int]:
    """(rows, columns) of an h x w frame flipped by `angle`."""
    return (w, h) if angle in (90, 270) else (h, w)


def _axes(t: torch.Tensor, spatial_axes) -> Tuple[int, int]:
    nd = t.dim()
    h_ax, w_ax = spatial_axes
    if not (-nd <= h_ax < nd and -nd <= w_ax < nd):
        raise ValueError(f"spatial_axes {tuple(spatial_axes)} out of range for a "
                         f"{nd}-dimensional tensor")
    return h_ax % nd, w_ax % nd


def _row_range(rows, n: int) -> Tuple[int, int]:
    r0, r1 = (0, n) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= r0 <= r1 <= n:
        raise ValueError(f"rows {(r0, r1)} out of the flipped frame's {n} rows")
    return r0, r1


_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def flip_rows_plain(image: torch.Tensor, angle: int, rows=None,
                    spatial_axes=(-3, -2)) -> torch.Tensor:
    """Rows [r0, r1) (`rows`; all where None) of flip(image, angle): kernel
    N's plain version. Only the input rows or columns that land in those rows
    are flipped, torch.flip of torch.transpose as the JAX package writes it."""
    if image.dtype in _SIGNED:  # torch.flip has no unsigned 16-64-bit kernels: the same bytes
        return flip_rows_plain(image.view(_SIGNED[image.dtype]), angle, rows,
                               spatial_axes).view(image.dtype)
    h_ax, w_ax = _axes(image, spatial_axes)
    h, w = image.shape[h_ax], image.shape[w_ax]
    r0, r1 = _row_range(rows, flipped_shape(h, w, angle)[0])
    if angle == 90:  # flipped row i is column i, read upwards
        src = image.narrow(w_ax, r0, r1 - r0)
        return torch.flip(torch.transpose(src, h_ax, w_ax), dims=(w_ax,))
    if angle == 180:  # flipped row i is row h - 1 - i, reversed
        src = image.narrow(h_ax, h - r1, r1 - r0)
        return torch.flip(src, dims=(h_ax, w_ax))
    if angle == 270:  # flipped row i is column w - 1 - i
        src = image.narrow(w_ax, w - r1, r1 - r0)
        return torch.flip(torch.transpose(src, h_ax, w_ax), dims=(h_ax,))
    return image if rows is None else image.narrow(h_ax, r0, r1 - r0)


MAX_PIXEL_BYTES = 16  # kernel N's largest pixel (a group of bytes it moves as one)


def _alignment(*values: int) -> int:
    """The largest power of two of at most 16 that divides every value."""
    a = 16
    for v in values:
        while v % a:
            a //= 2
    return a


def flip_route(elem: int, w: int, angle: int, in_align: int, out_align: int) -> Tuple[int, int]:
    """Kernel N's (route, word) for pixels of `elem` bytes, w wide, whose
    input bases and strides (and, at 90 / 270, first column: r0 at 90, w -
    r0 at 270) are multiples of in_align bytes and output ones of out_align
    (powers of two, at most 16): route 1 (180 over 16-byte chunks) for
    1-byte pixels in rows of whole chunks, all 16-byte aligned; route 2 (90
    / 270 over tiles placed on the output's 32-byte sectors, whatever its
    alignment) for 1-byte pixels whose input is 4-byte aligned, loading 16
    bytes at once where the input is 16-byte aligned (word 16), else 4
    (word 4); else route 0 over words of the largest power of two dividing
    the pixel and both alignments."""
    if elem == 1 and angle == 180 and w % 16 == 0 and min(in_align, out_align) == 16:
        return 1, 1
    if elem == 1 and angle in (90, 270) and in_align >= 4:
        return 2, 16 if in_align >= 16 else 4
    return 0, _alignment(elem, in_align, out_align)


def _pixel_layout(t: torch.Tensor, h_ax: int, w_ax: int):
    """(b, h, w, k, sb, sy): t's leading axes as b frames sb elements
    apart, h rows sy elements apart, w pixels of k contiguous elements (its
    trailing axes); None where t's strides do not allow that."""
    shape, stride = t.shape, t.stride()
    k = 1
    for d in range(t.dim() - 1, w_ax, -1):  # the trailing axes, contiguous
        if shape[d] != 1 and stride[d] != k:
            return None
        k *= shape[d]
    if shape[w_ax] != 1 and stride[w_ax] != k:
        return None
    b, sb = 1, 0
    for d in range(h_ax - 1, -1, -1):  # the leading axes, one stride
        if shape[d] == 1:
            continue
        if b > 1 and stride[d] != sb * b:
            return None
        if b == 1:
            sb = stride[d]
        b *= shape[d]
    return b, shape[h_ax], shape[w_ax], k, sb, stride[h_ax]


def _pixel_views(tensors: Sequence[torch.Tensor], spatial_axes):
    """The tensors (copies where their strides do not allow a view) and
    their common layout: _pixel_layout's (b, h, w, k, sb, sy), the leading
    and trailing shapes and the bytes a pixel; raises ValueError on what
    kernel N does not take."""
    if not 1 <= len(tensors) <= 3:
        raise ValueError(f"kernel N: 1 to 3 tensors a launch, got {len(tensors)}")
    t0 = tensors[0]
    for i, t in enumerate(tensors):
        if t.layout != torch.strided:
            raise ValueError(f"kernel N: tensors[{i}] has layout {t.layout}; it moves strided "
                             f"tensors only")
        if t.shape != t0.shape or t.dtype != t0.dtype or t.device != t0.device:
            raise ValueError(f"kernel N: tensors[{i}] is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, tensors[0] {tuple(t0.shape)} {t0.dtype} on "
                             f"{t0.device}: one launch takes tensors of one shape, dtype and "
                             f"device")
    h_ax, w_ax = _axes(t0, spatial_axes)
    if w_ax != h_ax + 1:
        raise ValueError(f"kernel N: spatial_axes {tuple(spatial_axes)} are not adjacent rows "
                         f"then columns; it flips [..., H, W, ...] layouts only")
    lead, trail = t0.shape[:h_ax], t0.shape[w_ax + 1:]
    elem = math.prod(trail) * t0.element_size()
    if elem > MAX_PIXEL_BYTES:
        raise ValueError(f"kernel N: a pixel of {tuple(trail)} {t0.dtype} is {elem} bytes; it "
                         f"moves pixels of at most {MAX_PIXEL_BYTES} bytes")
    layouts = [_pixel_layout(t, h_ax, w_ax) for t in tensors]
    if None in layouts or len(set(layouts)) != 1:  # one set of strides a launch
        tensors = [t.contiguous() for t in tensors]
        layouts = [_pixel_layout(tensors[0], h_ax, w_ax)]
    return tuple(tensors), layouts[0], lead, trail, elem


def flip_cuda(tensors: Sequence[torch.Tensor], angle: int, rows=None, *,
              spatial_axes=(1, 2), batch_limit: int = kernels.MAX_BATCH):
    """Kernel N: rows [r0, r1) (`rows`; all where None) of each tensor
    flipped by `angle` over `spatial_axes` (adjacent, rows then columns), as
    a tuple; one launch for all the tensors (up to three, of one shape and
    dtype, pixels of at most 16 bytes) per run of kernels.batch_runs. A
    tensor whose pixels are not contiguous, or whose leading axes do not
    fold into one, is copied first. Any angle but 90, 180 and 270 is a
    no-op: the rows, no launch."""
    tensors, (b, h, w, k, sb, sy), lead, trail, elem = _pixel_views(tensors, spatial_axes)
    t0 = tensors[0]
    oh, ow = flipped_shape(h, w, angle)
    r0, r1 = _row_range(rows, oh)
    if t0.device.type != "cuda":
        raise ValueError(f"kernel N: expected CUDA tensors, got {t0.device}")
    if angle not in (90, 180, 270):
        h_ax = _axes(t0, spatial_axes)[0]
        return tuple(t if rows is None else t.narrow(h_ax, r0, r1 - r0) for t in tensors)
    shape = tuple(lead) + (r1 - r0, ow) + tuple(trail)
    n = len(tensors)
    out = torch.empty(((n,) if n > 1 else ()) + shape, dtype=t0.dtype, device=t0.device)
    if out.numel():
        size = t0.element_size()
        sb, sy = sb * size, sy * size
        ob = (r1 - r0) * ow * elem  # the output's frame and plane strides in bytes
        ins = [t.data_ptr() for t in tensors]
        base = out.data_ptr()
        outs = [base + i * b * ob for i in range(n)]
        col0 = (r0 if angle == 90 else w - r0) * elem  # the first input column's bytes
        route, word = flip_route(elem, w, angle,
                                 _alignment(sb, sy, *ins, *((col0,) if angle != 180 else ())),
                                 _alignment(ob, *outs))
        pad = (None,) * (3 - n)
        dev = t0.device
        with torch.cuda.device(dev):
            stream = kernels.stream_handle(out)
            for f0, m in kernels.batch_runs(b, batch_limit):
                kernels.FLIP.launch(*(p + f0 * sb for p in ins), *pad,
                                    *(p + f0 * ob for p in outs), *pad, n, m, h, w, elem, sb,
                                    sy, ob, angle, r0, r1, route, word, stream)
    return out.unbind(0) if n > 1 else (out,)


def flip_rows(tensors: Sequence[torch.Tensor], angle: int, rows=None, *, spatial_axes=(1, 2),
              plain: bool = False):
    """Rows [r0, r1) (`rows`; all where None) of each tensor flipped by
    `angle`, as a tuple: kernel N on CUDA tensors (one launch for all of
    them), flip_rows_plain on CPU tensors or with plain=True. The chain's
    call, on [B, H, W] planes or mosaics."""
    if plain or tensors[0].device.type == "cpu":
        return tuple(flip_rows_plain(t, angle, rows, spatial_axes) for t in tensors)
    return flip_cuda(tensors, angle, rows, spatial_axes=spatial_axes)


def flip(image: torch.Tensor, angle: int, spatial_axes=(-3, -2), *,
         plain: bool = False) -> torch.Tensor:
    """Rotate by `angle` degrees clockwise in image coordinates.

    `spatial_axes` are the (row, col) axes; defaults fit [..., H, W, C].
    For single-channel [..., H, W] pass spatial_axes=(-2, -1). A CUDA
    tensor goes through kernel N (adjacent spatial axes, pixels of at most
    16 bytes), a CPU tensor or plain=True through flip_rows_plain."""
    return flip_rows((image,), angle, spatial_axes=spatial_axes, plain=plain)[0]
