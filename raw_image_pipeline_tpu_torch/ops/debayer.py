"""Bayer demosaic (PyTorch port of raw_image_pipeline_tpu/ops/debayer.py).

Two algorithms for 8-bit frames, each a plain version and a hand-written
kernel:

- bilinear, bit-exact vs cv::demosaicing: `debayer_bilinear` (zero-padded
  shifted views, phase masks, then cv::demosaicing's 1-px border
  replication), op for op the reference package's; kernel A
  (csrc/debayer.cu);
- MHT, the Malvar-He-Cutler 5x5 stencil of the reference's CUDA backend
  (cv::cuda::demosaicing): `debayer_mht`, the full stencil over a
  clamp-to-edge mosaic; kernel D (csrc/debayer_mht.cu).

`debayer_planes` is what the pipeline calls: on a CUDA tensor it launches
the algorithm's kernel, on a CPU tensor it runs the plain version. 16-bit
frames (an extension of the reference) go through `debayer_bilinear16`,
plain int32 ops on any device.

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
# throws); demosaiced by debayer_bilinear16 when DebayerConfig.bayer16 is
# "scale8"
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


def debayer_bilinear(bayer: torch.Tensor, phase: str) -> torch.Tensor:
    """Plain bilinear demosaic: [B, H, W] uint8 -> [B, 3, H, W] uint8 planar
    BGR (the channel order cv2 produces), bit-exact vs cv::demosaicing."""
    p = F.pad(bayer, (1, 1, 1, 1)).to(torch.int16)
    return _bilinear_stencil(p, phase, 255).to(torch.uint8)


def debayer_bilinear16(bayer: torch.Tensor, phase: str) -> torch.Tensor:
    """Bilinear demosaic of 16-bit frames (the reference package's
    debayer_bilinear16, an extension: the reference lists these patterns
    and throws): [B, H, W] uint16 (or any integer dtype holding 16-bit
    values) -> [B, 3, H, W] int32 BGR in [0, 65535], the 8-bit stencil
    and rounding in int32. The frame is widened to int32 first: uint16
    tensors support few ops."""
    p = F.pad(bayer.to(torch.int32), (1, 1, 1, 1))
    return _bilinear_stencil(p, phase, 65535)


def strip_width(w: int, in_ptr: int, out_ptr: int) -> int:
    """Kernels A's and D's strip width V: the widest of 16, 8 and 4 bytes
    that divides the row width and both addresses, so that every row of the
    mosaic and of each output plane starts on a V-byte boundary and a
    thread reads and writes its 2 x V strip as V-byte words; else 1 (strips
    of 2 columns, byte by byte)."""
    for v in (16, 8, 4):
        if w % v == 0 and in_ptr % v == 0 and out_ptr % v == 0:
            return v
    return 1


def _launch_debayer(kernel: kernels.Kernel, bayer: torch.Tensor, phase: str,
                    min_hw: int) -> torch.Tensor:
    """Check a [B, H, W] uint8 CUDA mosaic, allocate [B, 3, H, W] and launch
    kernel A or D on it at the strip width strip_width picks."""
    kernels.check_cuda(bayer, "bayer", torch.uint8)
    if bayer.dim() != 3 or bayer.shape[1] < min_hw or bayer.shape[2] < min_hw:
        raise ValueError(f"bayer: expected [B, H, W] with H, W >= {min_hw}, "
                         f"got {tuple(bayer.shape)}")
    b, h, w = bayer.shape
    kernels.check_batch(b, "bayer")
    out = torch.empty((b, 3, h, w), dtype=torch.uint8, device=bayer.device)
    if b:
        with torch.cuda.device(bayer.device):
            kernel.launch(bayer.data_ptr(), out.data_ptr(), b, h, w, phase_kinds(phase),
                          strip_width(w, bayer.data_ptr(), out.data_ptr()),
                          kernels.stream_handle(bayer))
    return out


def debayer_bilinear_cuda(bayer: torch.Tensor, phase: str) -> torch.Tensor:
    """Kernel A: [B, H, W] uint8 CUDA -> [B, 3, H, W] uint8 planar BGR,
    equal to debayer_bilinear for any H, W >= 2."""
    return _launch_debayer(kernels.DEBAYER_BILINEAR, bayer, phase, 2)


def _desc8(v: torch.Tensor) -> torch.Tensor:
    """v/16 with round-half-even (= rint of the float stencil value); v is
    int32 and may be negative (>> is an arithmetic shift)."""
    q = (v + 8) >> 4
    return q - (((v & 15) == 8) & ((q & 1) == 1)).to(v.dtype)


def debayer_mht(bayer: torch.Tensor, phase: str) -> torch.Tensor:
    """Plain Malvar-He-Cutler demosaic: [B, H, W] uint8 -> [B, 3, H, W]
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


def debayer_mht_cuda(bayer: torch.Tensor, phase: str) -> torch.Tensor:
    """Kernel D: [B, H, W] uint8 CUDA -> [B, 3, H, W] uint8 planar BGR,
    equal to debayer_mht for any H, W >= 1."""
    return _launch_debayer(kernels.DEBAYER_MHT, bayer, phase, 1)


_ALGORITHMS = {
    "bilinear": (debayer_bilinear, debayer_bilinear_cuda),
    "mht": (debayer_mht, debayer_mht_cuda),
}


def debayer_planes(bayer: torch.Tensor, encoding: str, algorithm: str = "bilinear",
                   plain: bool = False):
    """Demosaic a [B, H, W] uint8 batch straight to three [B, H, W] planes
    (c0, c1, c2) in cv2's BGR order, by "bilinear" or "mht". A CUDA tensor
    goes through the algorithm's kernel (A or D), a CPU tensor (or
    plain=True) through the plain version."""
    if encoding not in ENCODING_TO_CV_CODE:
        raise NotImplementedError(f"debayer of encoding [{encoding}]")
    if algorithm not in _ALGORITHMS:
        raise NotImplementedError(f"the [{algorithm}] demosaic algorithm")
    plain_fn, cuda_fn = _ALGORITHMS[algorithm]
    phase = phase_for_encoding(encoding)
    if plain or bayer.device.type == "cpu":
        out = plain_fn(bayer, phase)
    else:
        out = cuda_fn(bayer.contiguous(), phase)
    return out[:, 0], out[:, 1], out[:, 2]
