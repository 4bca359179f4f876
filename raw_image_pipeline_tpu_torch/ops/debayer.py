"""Bayer demosaic (PyTorch port of raw_image_pipeline_tpu/ops/debayer.py).

Two algorithms for 8-bit frames, each a plain version and a hand-written
kernel:

- bilinear, bit-exact vs cv::demosaicing: `debayer_bilinear_planar`
  (zero-padded shifted views, phase masks, then cv::demosaicing's 1-px
  border replication), op for op the reference package's; kernel A
  (csrc/debayer.cu);
- MHT, the Malvar-He-Cutler 5x5 stencil of the reference's CUDA backend
  (cv::cuda::demosaicing): `debayer_mht_planar`, the full stencil over a
  clamp-to-edge mosaic; kernel D (csrc/debayer_mht.cu).

16-bit frames (an extension of the reference) are always bilinear:
`debayer_bilinear16_plain` (the same stencil in int32) and kernel P
(csrc/debayer16.cu) write the values as u16, or >> 8 as u8 for the
chain's 8-bit stages.

All plain versions and kernels write planar [B, 3, H, W];
`debayer_bilinear`, `debayer_mht` and `debayer_bilinear16` are the
reference package's functions of a phase ([..., H, W] in, [..., H, W, 3]
out), on the kernel for a CUDA tensor.

`debayer_planes` and `debayer16_planes` are what the pipeline calls: on a
CUDA tensor they launch the kernel, on a CPU tensor they run the plain
version. `debayer` is the reference package's entry point over
[..., H, W] frames, [..., H, W, 3] out, through the same dispatch.

Phase convention: OpenCV's COLOR_BayerXX2BGR codes define the CFA phase from
pixel (1,1), so e.g. ``bayer_bggr8`` (ROS: top-left pixel Blue) maps to a
layout whose top-left sample is *Red* in OpenCV's interpretation. The
reference CPU path's R<->B swap (debayer.cpp:49-52) is applied by the
pipeline, not here.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from raw_image_pipeline_tpu_torch import kernels
from raw_image_pipeline_tpu_torch.ops.common import avg2, avg4

# OpenCV code -> channel at (row%2, col%2) == (0,0),(0,1),(1,0),(1,1).
_CV_PHASE = {
    "bg": "rggb",  # COLOR_BayerBG2BGR: (0,0)=R (0,1)=G (1,0)=G (1,1)=B
    "gb": "grbg",  # COLOR_BayerGB2BGR
    "rg": "bggr",  # COLOR_BayerRG2BGR
    "gr": "gbrg",  # COLOR_BayerGR2BGR
}

# ROS encoding -> OpenCV Bayer code used by the reference (debayer.cpp:45-79).
ENCODING_TO_CV_CODE = {
    "bayer_bggr8": "bg",
    "bayer_gbrg8": "gb",
    "bayer_grbg8": "gr",
    "bayer_rggb8": "rg",
}

BAYER_ENCODINGS = tuple(ENCODING_TO_CV_CODE)

# 16-bit patterns: listed by the reference but unimplemented there (it
# throws); demosaiced bilinearly (kernel P on the card) when
# DebayerConfig.bayer16 is "scale8"
BAYER16_ENCODINGS = ("bayer_bggr16", "bayer_gbrg16", "bayer_grbg16", "bayer_rggb16")

# Which parity cell holds (R site, G in an R row, G in a B row, B site),
# per phase; cells are ee/eo/oe/oo = (row&1, col&1) of (0,0)/(0,1)/(1,0)/(1,1).
_CELLS = {
    "rggb": ("ee", "eo", "oe", "oo"),
    "grbg": ("eo", "ee", "oo", "oe"),
    "gbrg": ("oe", "oo", "ee", "eo"),
    "bggr": ("oo", "oe", "eo", "ee"),
}
_CELL_INDEX = {"ee": 0, "eo": 1, "oe": 2, "oo": 3}


def phase_for_encoding(encoding: str) -> str:
    """Physical CFA phase (channel of sample (0,0) etc.) for a ROS encoding
    (8- or 16-bit), under OpenCV's interpretation of the matching
    COLOR_Bayer code."""
    if encoding in BAYER16_ENCODINGS:
        encoding = encoding[:-2] + "8"
    return _CV_PHASE[ENCODING_TO_CV_CODE[encoding]]


def _site_masks(h: int, w: int, phase: str, device) -> Tuple[torch.Tensor, ...]:
    """Boolean masks (h, w) for R / G-in-R-row / G-in-B-row / B sample sites."""
    row = (torch.arange(h, device=device) & 1)[:, None]
    col = (torch.arange(w, device=device) & 1)[None, :]
    cell = {
        "ee": (row == 0) & (col == 0), "eo": (row == 0) & (col == 1),
        "oe": (row == 1) & (col == 0), "oo": (row == 1) & (col == 1),
    }
    return tuple(cell[c] for c in _CELLS[phase])


def phase_kinds(phase: str) -> int:
    """Kernels A's and D's packed phase table: for parity cell (row&1)*2 + (col&1),
    bits [2*cell, 2*cell+2) hold 0 R site, 1 G in an R row, 2 G in a B row,
    3 B site. The kernels are instantiated for the four tables and launch
    the one this selects."""
    packed = 0
    for kind, cell in enumerate(_CELLS[phase]):
        packed |= kind << (2 * _CELL_INDEX[cell])
    return packed


def _replicate_border(img: torch.Tensor) -> torch.Tensor:
    """Replace output border rows/cols of [..., H, W] with the adjacent
    computed ones, as cv::demosaicing does."""
    img = torch.cat([img[..., 1:2, :], img[..., 1:-1, :], img[..., -2:-1, :]], dim=-2)
    return torch.cat([img[..., :, 1:2], img[..., :, 1:-1], img[..., :, -2:-1]], dim=-1)


def _bilinear_stencil(p: torch.Tensor, phase: str, hi: int) -> torch.Tensor:
    """The bilinear stencil over a zero-padded, widened mosaic p [B, H+2,
    W+2]: [B, 3, H, W] BGR in p's dtype, clamped to [0, hi], with
    cv::demosaicing's 1-px border replication."""
    h, w = p.shape[-2] - 2, p.shape[-1] - 2
    x = p[..., 1:-1, 1:-1]
    n, s = p[..., :-2, 1:-1], p[..., 2:, 1:-1]
    wv, e = p[..., 1:-1, :-2], p[..., 1:-1, 2:]
    nw, ne = p[..., :-2, :-2], p[..., :-2, 2:]
    sw, se = p[..., 2:, :-2], p[..., 2:, 2:]

    v2 = avg2(n, s)
    h2 = avg2(wv, e)
    n4 = avg4(n, s, wv, e)
    d4 = avg4(nw, ne, sw, se)

    r_site, g_r_row, g_b_row, b_site = _site_masks(h, w, phase, p.device)
    g_site = g_r_row | g_b_row

    g = torch.where(g_site, x, n4)
    r = torch.where(r_site, x, torch.where(g_r_row, h2, torch.where(g_b_row, v2, d4)))
    b = torch.where(b_site, x, torch.where(g_b_row, h2, torch.where(g_r_row, v2, d4)))
    return _replicate_border(torch.clamp(torch.stack([b, g, r], dim=-3), 0, hi))


def debayer_bilinear_planar(bayer: torch.Tensor, phase: str) -> torch.Tensor:
    """Plain bilinear demosaic (kernel A's plain version): [B, H, W] uint8
    -> [B, 3, H, W] uint8 planar BGR (the channel order cv2 produces),
    bit-exact vs cv::demosaicing."""
    p = F.pad(bayer, (1, 1, 1, 1)).to(torch.int16)
    return _bilinear_stencil(p, phase, 255).to(torch.uint8)


def debayer_bilinear16_plain(bayer: torch.Tensor, phase: str, *,
                             out_dtype: torch.dtype) -> torch.Tensor:
    """Bilinear demosaic of 16-bit frames (kernel P's plain version; the
    reference package's debayer_bilinear16, an extension: the reference
    lists these patterns and throws): [B, H, W] uint16 (or any integer
    dtype holding 16-bit values) -> [B, 3, H, W] planar BGR, uint16 or
    uint8 (each value >> 8, the chain's scale into its 8-bit stages). The
    8-bit stencil and rounding in int32: the frame is widened first, as
    uint16 tensors support few ops."""
    full = _bilinear_stencil(F.pad(bayer.to(torch.int32), (1, 1, 1, 1)), phase, 65535)
    if out_dtype == torch.uint8:
        return (full >> 8).to(torch.uint8)
    if out_dtype == torch.uint16:
        return full.to(torch.uint16)
    raise ValueError(f"out_dtype: expected torch.uint8 or torch.uint16, got {out_dtype}")


def strip_width(w: int, in_ptr: int, out_ptr: int, in_bytes: int = 1,
                out_bytes: int = 1) -> int:
    """Kernels A's, D's and P's strip width V: the widest of 16, 8 and 4
    columns whose strip row of the mosaic (in_bytes a sample) is one word
    of at most 16 bytes, that divides the row width, and whose rows of the
    mosaic and of each output plane (out_bytes a value, written in words
    of at most 16 bytes) start on their words' boundaries, given both
    addresses; else 1 (strips of 2 columns, sample by sample). So u8
    mosaics take up to 16 columns and u16 ones up to 8: kernel P with 16
    (two 16-byte loads a row) was slower at 1920x1080 (PERF.md section 6)."""
    for v in (16, 8, 4):
        if (v * in_bytes <= 16 and w % v == 0 and in_ptr % (v * in_bytes) == 0
                and out_ptr % min(v * out_bytes, 16) == 0):
            return v
    return 1


def _launch_debayer(kernel: kernels.Kernel, bayer: torch.Tensor, phase: str,
                    min_hw: int, batch_limit: int, in_dtype: torch.dtype = torch.uint8,
                    out_dtype: torch.dtype = torch.uint8, extra: tuple = ()) -> torch.Tensor:
    """Check a [B, H, W] CUDA mosaic of in_dtype, allocate [B, 3, H, W] of
    out_dtype and launch kernel A, D or P on each run of at most
    batch_limit frames (kernels.batch_runs) at the strip width strip_width
    picks for it; `extra`, the C entry's arguments before the stream (P's
    output bytes a value)."""
    kernels.check_cuda(bayer, "bayer", in_dtype)
    if bayer.dim() != 3 or bayer.shape[1] < min_hw or bayer.shape[2] < min_hw:
        raise ValueError(f"bayer: expected [B, H, W] with H, W >= {min_hw}, "
                         f"got {tuple(bayer.shape)}")
    b, h, w = bayer.shape
    out = torch.empty((b, 3, h, w), dtype=out_dtype, device=bayer.device)
    sizes = (bayer.element_size(), out.element_size())
    with torch.cuda.device(bayer.device):
        for s, n in kernels.batch_runs(b, batch_limit):
            src, dst = bayer[s:s + n], out[s:s + n]
            kernel.launch(src.data_ptr(), dst.data_ptr(), n, h, w, phase_kinds(phase),
                          strip_width(w, src.data_ptr(), dst.data_ptr(), *sizes), *extra,
                          kernels.stream_handle(bayer))
    return out


def debayer_bilinear16_cuda(bayer: torch.Tensor, phase: str, *, out_dtype: torch.dtype,
                            batch_limit: int = kernels.MAX_BATCH) -> torch.Tensor:
    """Kernel P: [B, H, W] uint16 CUDA -> [B, 3, H, W] planar BGR of
    out_dtype (uint16, or uint8 for each value >> 8), equal to
    debayer_bilinear16_plain for any H, W >= 2 and any B (one launch per
    batch_limit frames)."""
    if out_dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"out_dtype: expected torch.uint8 or torch.uint16, got {out_dtype}")
    return _launch_debayer(kernels.DEBAYER_BILINEAR16, bayer, phase, 2, batch_limit,
                           torch.uint16, out_dtype, (out_dtype.itemsize,))


def debayer_bilinear_cuda(bayer: torch.Tensor, phase: str, *,
                          batch_limit: int = kernels.MAX_BATCH) -> torch.Tensor:
    """Kernel A: [B, H, W] uint8 CUDA -> [B, 3, H, W] uint8 planar BGR,
    equal to debayer_bilinear_planar for any H, W >= 2 and any B (one launch
    per batch_limit frames, the grid's limit)."""
    return _launch_debayer(kernels.DEBAYER_BILINEAR, bayer, phase, 2, batch_limit)


def _desc8(v: torch.Tensor) -> torch.Tensor:
    """v/16 with round-half-even (= rint of the float stencil value); v is
    int32 and may be negative (>> is an arithmetic shift)."""
    q = (v + 8) >> 4
    return q - (((v & 15) == 8) & ((q & 1) == 1)).to(v.dtype)


def debayer_mht_planar(bayer: torch.Tensor, phase: str) -> torch.Tensor:
    """Plain Malvar-He-Cutler demosaic (kernel D's plain version): [B, H, W] uint8 -> [B, 3, H, W]
    uint8 planar BGR, equal to the reference package's debayer_mht for any
    H, W >= 1 (no R<->B swap: this is the reference's GPU algorithm).

    The full 5x5 stencil with x16 integer filters is evaluated at every
    pixel over a 2-px clamp-to-edge padded mosaic (the CUDA kernel's
    cudaAddressModeClamp texture reads); the padding is an index gather on
    the int32 mosaic."""
    h, w = bayer.shape[-2], bayer.shape[-1]
    dev = bayer.device
    rows = torch.clamp(torch.arange(-2, h + 2, device=dev), 0, h - 1)
    cols = torch.clamp(torch.arange(-2, w + 2, device=dev), 0, w - 1)
    p = bayer.to(torch.int32).index_select(-2, rows).index_select(-1, cols)

    def sh(dy: int, dx: int) -> torch.Tensor:
        return p[..., 2 + dy:2 + dy + h, 2 + dx:2 + dx + w]

    c = sh(0, 0)
    n1, s1, w1, e1 = sh(-1, 0), sh(1, 0), sh(0, -1), sh(0, 1)
    n2, s2, w2, e2 = sh(-2, 0), sh(2, 0), sh(0, -2), sh(0, 2)
    diag4 = sh(-1, -1) + sh(-1, 1) + sh(1, -1) + sh(1, 1)
    cross4 = n1 + s1 + w1 + e1
    axial4 = n2 + s2 + w2 + e2

    g_at_rb = _desc8(8 * c + 4 * cross4 - 2 * axial4)
    rb_at_g_h = _desc8(10 * c + 8 * (w1 + e1) - 2 * diag4 - 2 * (w2 + e2) + (n2 + s2))
    rb_at_g_v = _desc8(10 * c + 8 * (n1 + s1) - 2 * diag4 - 2 * (n2 + s2) + (w2 + e2))
    rb_at_br = _desc8(12 * c + 4 * diag4 - 3 * axial4)

    r_site, g_r_row, g_b_row, b_site = _site_masks(h, w, phase, dev)
    g = torch.where(g_r_row | g_b_row, c, g_at_rb)
    r = torch.where(r_site, c, torch.where(g_r_row, rb_at_g_h,
                                           torch.where(g_b_row, rb_at_g_v, rb_at_br)))
    b = torch.where(b_site, c, torch.where(g_b_row, rb_at_g_h,
                                           torch.where(g_r_row, rb_at_g_v, rb_at_br)))
    return torch.clamp(torch.stack([b, g, r], dim=-3), 0, 255).to(torch.uint8)


def debayer_mht_cuda(bayer: torch.Tensor, phase: str, *,
                     batch_limit: int = kernels.MAX_BATCH) -> torch.Tensor:
    """Kernel D: [B, H, W] uint8 CUDA -> [B, 3, H, W] uint8 planar BGR,
    equal to debayer_mht_planar for any H, W >= 1 and any B (one launch per
    batch_limit frames)."""
    return _launch_debayer(kernels.DEBAYER_MHT, bayer, phase, 1, batch_limit)


_ALGORITHMS = {
    "bilinear": (debayer_bilinear_planar, debayer_bilinear_cuda),
    "mht": (debayer_mht_planar, debayer_mht_cuda),
}


def _dispatch(algorithm: str, bayer: torch.Tensor, phase: str, plain: bool) -> torch.Tensor:
    """[N, H, W] u8 -> [N, 3, H, W]: the algorithm's kernel (A or D) on a
    CUDA tensor, its plain version on a CPU tensor or with plain=True."""
    plain_fn, cuda_fn = _ALGORITHMS[algorithm]
    if plain or bayer.device.type == "cpu":
        return plain_fn(bayer, phase)
    return cuda_fn(bayer.contiguous(), phase)


def _flat(bayer: torch.Tensor) -> torch.Tensor:
    return bayer.reshape((-1,) + tuple(bayer.shape[-2:]))


def _nhwc(out: torch.Tensor, lead) -> torch.Tensor:
    """[N, 3, H, W] -> [*lead, H, W, 3]."""
    return out.permute(0, 2, 3, 1).reshape(tuple(lead) + tuple(out.shape[-2:]) + (3,)) \
        .contiguous()


def debayer_bilinear(bayer: torch.Tensor, phase: str, *, plain: bool = False) -> torch.Tensor:
    """Bilinear demosaic in a CFA phase: [..., H, W] uint8 -> [..., H, W, 3]
    uint8 BGR, kernel A on a CUDA tensor."""
    return _nhwc(_dispatch("bilinear", _flat(bayer), phase, plain), bayer.shape[:-2])


def debayer_mht(bayer: torch.Tensor, phase: str, *, plain: bool = False) -> torch.Tensor:
    """Malvar-He-Cutler demosaic in a CFA phase: [..., H, W] uint8 ->
    [..., H, W, 3] uint8 BGR, kernel D on a CUDA tensor."""
    return _nhwc(_dispatch("mht", _flat(bayer), phase, plain), bayer.shape[:-2])


def _debayer16(bayer: torch.Tensor, phase: str, out_dtype: torch.dtype,
               plain: bool) -> torch.Tensor:
    """[N, H, W] u16 -> [N, 3, H, W] of out_dtype: kernel P on a CUDA
    tensor, its plain version on a CPU tensor or with plain=True."""
    if plain or bayer.device.type == "cpu":
        return debayer_bilinear16_plain(bayer, phase, out_dtype=out_dtype)
    return debayer_bilinear16_cuda(bayer.contiguous(), phase, out_dtype=out_dtype)


def debayer_bilinear16(bayer: torch.Tensor, phase: str, *, plain: bool = False) -> torch.Tensor:
    """Bilinear demosaic of 16-bit frames: [..., H, W] uint16 ->
    [..., H, W, 3] uint16 BGR, kernel P on a CUDA tensor."""
    out = _debayer16(_flat(bayer), phase, torch.uint16, plain)
    # interleaved through an int16 view: the bits are the same, and uint16
    # tensors support few ops on the card
    return _nhwc(out.view(torch.int16), bayer.shape[:-2]).view(torch.uint16)


def _demosaic(bayer: torch.Tensor, encoding: str, algorithm: str, plain: bool) -> torch.Tensor:
    """[N, H, W] 8-bit mosaic of an encoding -> [N, 3, H, W] BGR (_dispatch)."""
    if encoding not in ENCODING_TO_CV_CODE:
        raise NotImplementedError(f"debayer of encoding [{encoding}]")
    if algorithm not in _ALGORITHMS:
        raise NotImplementedError(f"the [{algorithm}] demosaic algorithm")
    return _dispatch(algorithm, bayer, phase_for_encoding(encoding), plain)


def debayer(bayer: torch.Tensor, encoding: str, algorithm: str = "bilinear", *,
            plain: bool = False) -> torch.Tensor:
    """Demosaic [..., H, W] frames by ROS encoding name to [..., H, W, 3]
    BGR in cv2's channel order (before the pipeline's CPU-path R<->B swap):
    uint8 for the 8-bit encodings ("bilinear" = kernel A, "mht" = kernel D
    on a CUDA tensor), uint16 for the 16-bit ones (bilinear, kernel P on a
    CUDA tensor); the plain versions on a CPU tensor or with plain=True."""
    if bayer.dim() < 2:
        raise ValueError(f"bayer: expected [..., H, W], got {tuple(bayer.shape)}")
    if encoding in BAYER16_ENCODINGS:  # whatever the algorithm, as the reference package
        return debayer_bilinear16(bayer, phase_for_encoding(encoding), plain=plain)
    return _nhwc(_demosaic(_flat(bayer), encoding, algorithm, plain), bayer.shape[:-2])


def debayer_planes(bayer: torch.Tensor, encoding: str, algorithm: str = "bilinear", *,
                   plain: bool = False):
    """Demosaic a [B, H, W] uint8 batch straight to three [B, H, W] planes
    (c0, c1, c2) in cv2's BGR order: debayer(...)[..., c] without the
    interleave, as the chain calls it (8-bit encodings only)."""
    out = _demosaic(bayer, encoding, algorithm, plain)
    return out[:, 0], out[:, 1], out[:, 2]


def debayer16_planes(bayer: torch.Tensor, encoding: str, *, plain: bool = False):
    """Demosaic a [B, H, W] uint16 batch of a 16-bit encoding straight to
    three [B, H, W] uint8 planes (c0, c1, c2) in cv2's BGR order, each value
    >> 8, as the chain scales 16-bit frames into its 8-bit stages: kernel P
    in u8 mode on a CUDA tensor, its plain version on a CPU tensor or with
    plain=True."""
    if encoding not in BAYER16_ENCODINGS:
        raise NotImplementedError(f"16-bit debayer of encoding [{encoding}]")
    out = _debayer16(bayer, phase_for_encoding(encoding), torch.uint8, plain)
    return out[:, 0], out[:, 1], out[:, 2]
