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
plain form (`resize_linear_u8_rows`): two row selects, two column selects
and the integer multiply-adds, horizontal pass first (the truncating
vertical shifts do not commute). On a CUDA tensor the entry points launch
kernel H (csrc/ccc_resize.cu) instead, which reads the same tables narrowed
to int32 (`resize_table`), up to three planes a launch: on its rows path
(planes and output of column stride 1, a batch of at least ROWS_MIN_BATCH
frames, `resize_path`) with the bands of
staged source rows `resize_bands` makes from those tables, else on its
gather path.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from raw_image_pipeline_tpu_torch import kernels


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


def resize_linear_u8_plane(img: torch.Tensor, dst_h: int, dst_w: int, *,
                           plain: bool = False) -> torch.Tensor:
    """[..., H, W] uint8 -> [..., dst_h, dst_w] uint8, bit-exact vs
    cv::resize(INTER_LINEAR): kernel H on a CUDA tensor, the plain version
    on a CPU tensor or with plain=True."""
    return resize_planes((img,), img.shape[-2], dst_h, dst_w, plain=plain)[0]


def resize_linear_u8(image: torch.Tensor, dst_h: int, dst_w: int, *,
                     plain: bool = False) -> torch.Tensor:
    """[..., H, W, C] uint8 -> [..., dst_h, dst_w, C] uint8, each channel
    resized as resize_linear_u8_plane; on a CUDA tensor kernel H reads the
    channels as strided planes and writes the interleaved output itself."""
    if image.dim() < 3:
        raise ValueError(f"image: expected [..., H, W, C], got {tuple(image.shape)}")
    h, w, c = image.shape[-3:]
    planes = image.unbind(-1)
    if plain or image.device.type == "cpu":
        out = resize_planes(planes, h, dst_h, dst_w, plain=True)
        return torch.stack(out, dim=-1)
    out = torch.empty(tuple(image.shape[:-3]) + (dst_h, dst_w, c), dtype=torch.uint8,
                      device=image.device)
    resize_rows_cuda(planes, h, dst_h, dst_w, 0, dst_h, 0, out=out.unbind(-1))
    return out


def resize_linear_u8_rows(img: torch.Tensor, src_h: int, dst_h: int, dst_w: int,
                          y0: int, y1: int, row0: int) -> torch.Tensor:
    """Plain version of kernel H: rows [y0, y1) of the resize of an
    src_h-row frame to dst_h x dst_w, from `img` [..., h, W], the frame's
    rows [row0, row0 + h) (which must hold every source row those output
    rows read): [..., y1 - y0, dst_w] uint8, equal to those rows of
    resize_linear_u8_plane of the frame."""
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


def resize_table(src_h: int, src_w: int, dst_h: int, dst_w: int, y0: int, y1: int,
                 row0: int) -> np.ndarray:
    """Kernel H's table for the output rows [y0, y1) of an src_h x src_w ->
    dst_h x dst_w resize, the source rows counted from the frame's row
    row0: _rows_on's host tables narrowed to int32 and laid end to end,
    sx, sx2, a0, a1 (dst_w each), then sy, sy2, b0, b1 (y1 - y0 each)."""
    sx, sx2, a0, a1 = _tables_x(src_w, dst_w)
    sy, sy2, b0, b1 = _tables_y(src_h, dst_h)
    ys = (sy[y0:y1] - row0, sy2[y0:y1] - row0, b0[y0:y1], b1[y0:y1])
    return np.concatenate([np.asarray(a, np.int32) for a in (sx, sx2, a0, a1) + ys])


@functools.lru_cache(maxsize=64)
def _resize_table_on(src_h: int, src_w: int, dst_h: int, dst_w: int, device: str,
                     y0: int, y1: int, row0: int) -> Tuple[torch.Tensor, int, int]:
    """resize_table on `device`, uploaded once per shape and slab, and the
    lowest and highest source row it reads (counted from row0)."""
    table = resize_table(src_h, src_w, dst_h, dst_w, y0, y1, row0)
    ys = table[4 * dst_w:4 * dst_w + 2 * (y1 - y0)]
    lo, hi = (int(ys.min()), int(ys.max())) if ys.size else (0, -1)
    return torch.as_tensor(table, device=device), lo, hi


BAND_ROWS = 2  # output rows an item of kernel H's rows path (the C entry's)
ROWS_STAGES = 2  # items a block of the rows path stages ahead (the C entry's)
ROWS_SMEM_LIMIT = 96 * 1024  # shared memory a block of the rows path may use (the C entry's)


def row_pitch(src_w: int) -> int:
    """Shared-memory bytes kernel H's rows path gives a staged source row:
    the 16-byte chunks from the one holding its first byte to the one
    holding its last, whatever the row's alignment."""
    return 16 * (src_w // 16 + 2)


def rows_smem(planes: int, slots: int, src_w: int) -> int:
    """Shared-memory bytes a block of kernel H's rows path uses: ROWS_STAGES
    buffers of `slots` staged rows of each of `planes` planes, filled ahead
    of the rows being read."""
    return ROWS_STAGES * planes * slots * row_pitch(src_w)


def resize_bands(table: np.ndarray, dst_w: int) -> Tuple[int, np.ndarray]:
    """Kernel H's bands on its rows path, from a resize_table of dst_w
    output columns: output rows [k * BAND_ROWS, (k + 1) * BAND_ROWS) form
    band k. Returns (slots, bands), bands int32 [n_bands, slots + 2 *
    BAND_ROWS]: each band's distinct source rows, the table's sy and sy2 of
    its output rows (counted as the table counts them, from row0) in
    increasing order and -1 past them (slots: the most any band has), then
    for each of its output rows the slots of its sy and its sy2 (-1 past the
    slab's last row). A block stages its band's rows once each."""
    rows = (len(table) - 4 * dst_w) // 4
    sy = table[4 * dst_w:4 * dst_w + rows]
    sy2 = table[4 * dst_w + rows:4 * dst_w + 2 * rows]
    starts = range(0, rows, BAND_ROWS)
    staged = [np.union1d(sy[y:y + BAND_ROWS], sy2[y:y + BAND_ROWS]) for y in starts]
    slots = max((len(r) for r in staged), default=1)
    bands = np.full((len(staged), slots + 2 * BAND_ROWS), -1, np.int32)
    for k, (y, r) in enumerate(zip(starts, staged)):
        n = min(BAND_ROWS, rows - y)
        bands[k, :len(r)] = r
        bands[k, slots:slots + 2 * n:2] = np.searchsorted(r, sy[y:y + n])
        bands[k, slots + 1:slots + 2 * n:2] = np.searchsorted(r, sy2[y:y + n])
    return slots, bands


@functools.lru_cache(maxsize=64)
def _resize_bands_on(src_h: int, src_w: int, dst_h: int, dst_w: int, device: str,
                     y0: int, y1: int, row0: int) -> Tuple[torch.Tensor, int]:
    """resize_bands of the slab's table on `device`, uploaded once per shape
    and slab, and its slots."""
    slots, bands = resize_bands(resize_table(src_h, src_w, dst_h, dst_w, y0, y1, row0), dst_w)
    return torch.as_tensor(bands, device=device), slots


# frames a launch from which kernel H's rows path is the faster one: on an
# NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's phase ccc_range, PERF.md)
# the gather path wins up to 8 frames at 1920x1080 and 1440x1080 (at 8 the
# two are within 4%, the gather path ahead in four readings of six) and
# the rows path from 9 on, by 4-25%
ROWS_MIN_BATCH = 9


def resize_path(in_col: int, out_col: int, src_w: int, planes: int, slots: int,
                batch: Optional[int] = None) -> str:
    """Kernel H's path for `batch` frames (None: any number) of planes of
    column stride in_col (elements) and src_w columns, written with column
    stride out_col, `planes` a launch and `slots` staged rows a band:
    "rows" (stage each tapped source row whole in shared memory) where both
    column strides are 1, the block's rows_smem fits ROWS_SMEM_LIMIT and the
    batch has at least ROWS_MIN_BATCH frames, else "gather" (a thread an
    output pixel)."""
    fits = rows_smem(planes, slots, src_w) <= ROWS_SMEM_LIMIT
    many = batch is None or batch >= ROWS_MIN_BATCH
    return "rows" if in_col == 1 and out_col == 1 and fits and many else "gather"


def resize_rows_cuda(planes: Sequence[torch.Tensor], src_h: int, dst_h: int, dst_w: int,
                     y0: int, y1: int, row0: int, *, out=None,
                     batch_limit: int = kernels.MAX_BATCH,
                     path: Optional[str] = None) -> Tuple[torch.Tensor, ...]:
    """Kernel H: resize_linear_u8_rows of each of `planes` (CUDA u8 tensors
    [..., h, W] of one shape and one set of strides, any), as a tuple.
    `out`, if given, is one u8 tensor [..., y1 - y0, dst_w] a plane (of one
    set of strides, any) that H writes in place. One launch for every three
    planes, per batch_limit frames (kernels.batch_runs). `path` forces
    "rows" or "gather" (default: resize_path's choice; "rows" where it does
    not apply raises ValueError)."""
    if path not in (None, "rows", "gather"):
        raise ValueError(f"path: expected None, 'rows' or 'gather', got {path!r}")
    planes = tuple(planes)
    if not planes:
        return ()
    shape = tuple(planes[0].shape)
    if len(shape) < 2:
        raise ValueError(f"planes: expected [..., h, W], got {shape}")
    for i, p in enumerate(planes):
        if p.device.type != "cuda" or p.dtype != torch.uint8 or tuple(p.shape) != shape:
            raise ValueError(f"planes[{i}]: expected a CUDA uint8 tensor of shape {shape}, "
                             f"got {p.device} {p.dtype} {tuple(p.shape)}")
    h, w = shape[-2:]
    rows = y1 - y0
    lead = shape[:-2]
    device = str(planes[0].device)
    table, lo, hi = _resize_table_on(src_h, w, dst_h, dst_w, device, y0, y1, row0)
    if rows and (lo < 0 or hi >= h):
        raise ValueError(f"planes: the output rows [{y0}, {y1}) read the frame's rows "
                         f"[{row0 + lo}, {row0 + hi}] but the planes hold [{row0}, {row0 + h})")
    if out is None:
        dst = torch.empty((len(planes),) + lead + (rows, dst_w), dtype=torch.uint8,
                          device=planes[0].device)
        out = tuple(dst.unbind(0))
    out = tuple(out)
    for i, o in enumerate(out):
        if o.device != planes[0].device or o.dtype != torch.uint8 or \
                tuple(o.shape) != lead + (rows, dst_w):
            raise ValueError(f"out[{i}]: expected a uint8 tensor of shape "
                             f"{lead + (rows, dst_w)} on {planes[0].device}")
    if not rows or not dst_w or not math.prod(lead):
        return out
    # [N, h, W] views (a copy only where the leading dims do not fold)
    src = [p.reshape((-1, h, w)) for p in planes]
    dst = [o.reshape((-1, rows, dst_w)) for o in out]
    if any(d.data_ptr() != o.data_ptr() for d, o in zip(dst, out)):  # reshape copied
        raise ValueError("out: the leading dims of an output plane must fold into one")
    for name, ts in (("planes", src), ("out", dst)):
        if len({t.stride() for t in ts}) > 1:
            raise ValueError(f"{name}: expected one set of strides, got "
                             f"{[t.stride() for t in ts]}")
    (fs, rs, cs), (fo, ro, co) = src[0].stride(), dst[0].stride()
    bands, slots = _resize_bands_on(src_h, w, dst_h, dst_w, device, y0, y1, row0)
    chosen = resize_path(cs, co, w, min(3, len(src)), slots, src[0].shape[0])
    if path == "rows" and resize_path(cs, co, w, min(3, len(src)), slots) != "rows":
        raise ValueError(f"path: the rows path needs column strides of 1 (got {cs} in, {co} "
                         f"out) and {rows_smem(min(3, len(src)), slots, w)} bytes of "
                         f"shared memory within {ROWS_SMEM_LIMIT}")
    band_ptr = None if (path or chosen) == "gather" else bands.data_ptr()
    with torch.cuda.device(src[0].device):
        for k in range(0, len(src), 3):
            n_planes = len(src[k:k + 3])
            for s, n in kernels.batch_runs(src[0].shape[0], batch_limit):
                ptr_in = [p[s].data_ptr() for p in src[k:k + 3]] + [None] * (3 - n_planes)
                ptr_out = [o[s].data_ptr() for o in dst[k:k + 3]] + [None] * (3 - n_planes)
                kernels.CCC_RESIZE.launch(*ptr_in, *ptr_out, n_planes, table.data_ptr(),
                                          band_ptr, n, dst_w, rows, w, slots, fs, rs, cs, fo,
                                          ro, co, kernels.stream_handle(src[0]))
    return out


def resize_planes(planes: Sequence[torch.Tensor], src_h: int, dst_h: int, dst_w: int,
                  y0: int = 0, y1=None, row0: int = 0, *,
                  plain: bool = False) -> Tuple[torch.Tensor, ...]:
    """Rows [y0, y1) (default all) of the resize of each of `planes` ([...,
    h, W] u8, the frame's rows [row0, row0 + h) of src_h) to dst_h x dst_w:
    kernel H on CUDA tensors (resize_rows_cuda: the chain's three planes in
    one launch), resize_linear_u8_rows on CPU tensors or with plain=True."""
    y1 = dst_h if y1 is None else y1
    if plain or planes[0].device.type == "cpu":
        return tuple(resize_linear_u8_rows(p, src_h, dst_h, dst_w, y0, y1, row0)
                     for p in planes)
    return resize_rows_cuda(planes, src_h, dst_h, dst_w, y0, y1, row0)
