"""The chain's pointwise stretch as one kernel (kernel G,
csrc/pointwise.cu): a statistical white balance's per-frame tables, the
CCC gains, colour calibration, a u8 LUT, vignetting through the exact Lab
roundtrip and the HSV enhancer, each optional, in the chain's order,
planes in and planes out (the mono chain's gamma LUT is kernel O,
ops/gamma.lut_cuda).

It composes the JAX package's stage functions, which it leaves to XLA:
the statistical white balances' per-pixel maps (ops/white_balance.py,
ops/learned_wb.py; the port's `apply_tables_plain`), ops/ccc.py
`apply_gains_planes`, ops/color_calibration.py
`color_correct_planes`, ops/gamma.py `apply_lut`, ops/vignetting.py
`correct_planes` (with `composed_gamma_lab_fn`'s table) and
ops/color_enhancer.py `enhance_planes`. The plain version
(`pointwise_plain`) is the composition of the port's own stage functions,
unchanged; `pointwise_planes` takes it for CPU planes or plain=True and
launches G for CUDA planes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from raw_image_pipeline_tpu_torch import kernels
from raw_image_pipeline_tpu_torch.ops import colorspace as cs
from raw_image_pipeline_tpu_torch.ops.ccc import apply_gains_planes
from raw_image_pipeline_tpu_torch.ops.color_calibration import color_correct_planes
from raw_image_pipeline_tpu_torch.ops.color_enhancer import enhance_planes
from raw_image_pipeline_tpu_torch.ops.common import as_tensor_on, image_planes
from raw_image_pipeline_tpu_torch.ops.gamma import apply_lut
from raw_image_pipeline_tpu_torch.ops.vignetting import correct_planes
from raw_image_pipeline_tpu_torch.ops.white_balance import apply_tables_plain, pca_nan_limit

PIXELS_PER_THREAD = 4  # csrc/pointwise.cu's kPx: a thread's group of a row's pixels

# const_tables' layout (csrc/pointwise.cu's kYIfy ... kConstBytes): name ->
# (byte offset, entries, type); "yify" is Lab2BGR's y | ify << 16
CONST_LAYOUT = {
    "yify": (0, 256, np.uint32),
    "cbrt": (1024, 3072, np.uint16),
    "inv_gamma": (7168, 8192, np.uint8),
    "hdiv": (15360, 256, np.int32),
    "sdiv": (16384, 256, np.int32),
}
CONST_BYTES = 17408
SDIV_BITS = 24  # the kernel packs the V gain above sdiv in one 32-bit entry


def _narrowed(values, dtype, name: str, bits: int = 0) -> np.ndarray:
    """values as dtype, raising unless every value fits it (and, with bits,
    fits that many low bits)."""
    a = np.asarray(values, np.int64)
    info = np.iinfo(dtype)
    hi = min(info.max, (1 << bits) - 1) if bits else info.max
    if a.size and (a.min() < info.min or a.max() > hi):
        raise ValueError(f"kernel G's {name} table: values in [{a.min()}, {a.max()}] do not "
                         f"fit {np.dtype(dtype).name}" + (f" in {bits} bits" if bits else ""))
    return a.astype(dtype)


def const_tables() -> np.ndarray:
    """The constant tables kernel G stages, as CONST_BYTES bytes in its
    layout (CONST_LAYOUT, little-endian), each in the narrowest type that
    holds its values (checked here): Lab2BGR's y and ify (u16 each, one
    u32 entry), the Lab cbrt table (u16), Lab2BGR's inverse gamma (u8),
    BGR2HSV's hdiv and sdiv (int32, sdiv below 2^SDIV_BITS)."""
    parts = {
        "yify": _narrowed(cs._LAB2_Y_TAB, np.uint16, "y").astype(np.uint32)
        | (_narrowed(cs._LAB2_IFY_TAB, np.uint16, "ify").astype(np.uint32) << 16),
        "cbrt": _narrowed(cs._CBRT_TAB, np.uint16, "cbrt"),
        "inv_gamma": _narrowed(cs._LAB2_INV_GAMMA_TAB, np.uint8, "inv_gamma"),
        "hdiv": _narrowed(cs._HDIV_TAB, np.int32, "hdiv"),
        "sdiv": _narrowed(cs._SDIV_TAB, np.int32, "sdiv", SDIV_BITS),
    }
    out = np.zeros(CONST_BYTES, np.uint8)
    for name, (at, n, dtype) in CONST_LAYOUT.items():
        raw = np.ascontiguousarray(parts[name], np.dtype(dtype).newbyteorder("<")).view(np.uint8)
        if raw.size != n * np.dtype(dtype).itemsize:
            raise AssertionError(f"kernel G's {name} table: {raw.size} bytes")
        out[at:at + raw.size] = raw
    return out


@functools.lru_cache(maxsize=8)
def _const_tables_on(device: str) -> torch.Tensor:
    return torch.as_tensor(const_tables(), device=device)


def _check_steps(matrix, bias, mask, lab_tab, wb_tables=None, wb_nan=None) -> None:
    if wb_nan is not None and wb_tables is None:
        raise ValueError("wb_nan is the table step's NaN flags: it needs wb_tables")
    if (matrix is None) != (bias is None):
        raise ValueError("colour calibration takes both matrix and bias")
    if lab_tab is not None and mask is None:
        raise ValueError("lab_tab is the vignetting step's table: it needs a mask")


def pointwise_plain(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor, *, wb_tables=None,
                    wb_nan=None, nan_limit=None, gains=None, matrix=None, bias=None, lut=None,
                    mask=None, lab_tab=None, enhancer_tables=None):
    """Kernel G's plain version: the stage functions in the chain's order,
    each where its argument is given. wb_tables [B, 3, 256] u8 with wb_nan
    [B, 3] u8 or None and nan_limit (apply_tables_plain); gains [B, 3] f32
    (apply_gains_planes);
    matrix [3, 3] and bias [3] f32 (color_correct_planes); lut [256]
    (apply_lut); mask [h, W] f32 with lab_tab, the int32 [256] linearize
    table or None for OpenCV's (vignetting.correct_planes);
    enhancer_tables [3, 256] u8 (enhance_planes)."""
    _check_steps(matrix, bias, mask, lab_tab, wb_tables, wb_nan)
    planes = (b, g, r)
    if wb_tables is not None:
        planes = apply_tables_plain(planes, wb_tables, wb_nan, nan_limit)
    if gains is not None:
        planes = apply_gains_planes(planes, gains)
    if matrix is not None:
        planes = color_correct_planes(*planes, matrix, bias)
    if lut is not None:
        planes = tuple(apply_lut(p, lut, plain=True) for p in planes)
    if mask is not None:
        planes = correct_planes(*planes, mask, gamma_tab=lab_tab)
    if enhancer_tables is not None:
        planes = enhance_planes(*planes, enhancer_tables)
    return planes


def _same_strides(planes):
    if len({p.stride() for p in planes}) == 1:
        return planes
    return tuple(p.contiguous() for p in planes)


def pointwise_cuda(planes, *, wb_tables=None, wb_nan=None, nan_limit=None, gains=None,
                   matrix=None, bias=None, lut=None, mask=None, lab_tab=None,
                   enhancer_tables=None, out=None, batch_limit: int = kernels.MAX_BATCH):
    """Kernel G: pointwise_plain for three [B, h, W] u8 CUDA planes of any
    strides (planes of unequal strides are copied to contiguous ones), the
    steps' arguments as pointwise_plain's (on the planes' card; mask
    broadcast to [h, W]; nan_limit default pca_nan_limit(h, W)). Writes
    into `out`, three [B, h, W] u8 planes of equal strides, or into three
    new contiguous planes, and returns them; one launch per run of
    kernels.batch_runs(B, batch_limit)."""
    _check_steps(matrix, bias, mask, lab_tab, wb_tables, wb_nan)
    if len(planes) != 3:
        raise ValueError(f"planes: expected 3, got {len(planes)}")
    shape = tuple(planes[0].shape)
    if len(shape) != 3:
        raise ValueError(f"planes: expected [B, H, W], got {shape}")
    for i, p in enumerate(planes):
        if p.device != planes[0].device:
            raise ValueError(f"planes[{i}]: on {p.device}, planes[0] on {planes[0].device}")
        if p.device.type != "cuda" or p.dtype != torch.uint8 or tuple(p.shape) != shape:
            raise ValueError(f"planes[{i}]: expected a [B, H, W] uint8 CUDA tensor of shape "
                             f"{shape}, got {tuple(p.shape)} {p.dtype} on {p.device}")
    dev = planes[0].device
    bsz, h, w = shape
    planes = _same_strides(planes)
    if out is None:
        buf = torch.empty((3,) + shape, dtype=torch.uint8, device=dev)
        out = (buf[0], buf[1], buf[2])
    out = tuple(out)
    if len(out) != 3 or len({o.stride() for o in out}) != 1:
        raise ValueError("out: expected three planes of equal strides")
    for i, o in enumerate(out):
        if o.device != dev or o.dtype != torch.uint8 or tuple(o.shape) != shape:
            raise ValueError(f"out[{i}]: expected {shape} uint8 on {dev}")
    args = {}
    if wb_tables is not None:
        args["wb"] = as_tensor_on(wb_tables, dev).contiguous()
        kernels.check_cuda(args["wb"], "wb_tables", torch.uint8, (bsz, 3, 256))
        if wb_nan is not None:
            args["wb_nan"] = as_tensor_on(wb_nan, dev).contiguous()
            kernels.check_cuda(args["wb_nan"], "wb_nan", torch.uint8, (bsz, 3))
    if gains is not None:
        args["gains"] = as_tensor_on(gains, dev, torch.float32).reshape(bsz, 3).contiguous()
    if matrix is not None:
        args["matrix"] = as_tensor_on(matrix, dev, torch.float32).reshape(3, 3).contiguous()
        args["bias"] = as_tensor_on(bias, dev, torch.float32).reshape(3).contiguous()
    if lut is not None:
        args["lut"] = as_tensor_on(lut, dev)
        kernels.check_cuda(args["lut"], "lut", torch.uint8, (256,))
    if mask is not None:
        m = as_tensor_on(mask, dev, torch.float32)
        if m.dim() > 2:
            raise ValueError(f"mask: expected [{h}, {w}] (shared by every frame), got "
                             f"{tuple(m.shape)}")
        args["mask"] = m.expand(h, w).contiguous()
        lab = cs._tables_on(str(dev))["lab_gamma"] if lab_tab is None else as_tensor_on(lab_tab,
                                                                                         dev)
        kernels.check_cuda(lab, "lab_tab", torch.int32, (256,))
        args["lab"] = lab
    if enhancer_tables is not None:
        args["enh"] = as_tensor_on(enhancer_tables, dev).contiguous()
        kernels.check_cuda(args["enh"], "enhancer_tables", torch.uint8, (3, 256))
    limit = pca_nan_limit(h, w) if nan_limit is None else int(nan_limit)
    _launch(planes, out, args, limit, batch_limit)
    return out


def _launch(planes, out, args: dict, nan_limit: int, batch_limit: int):
    """Kernel G's launches over planes and out (three [B, h, W] u8 CUDA
    planes each, of equal strides) with the steps' device tensors
    `args`."""
    bsz, h, w = planes[0].shape
    if h * -(-w // PIXELS_PER_THREAD) >= 2**31:
        raise ValueError(f"kernel G: {h} rows of {w} pixels exceed its task count")
    for name, t in (("planes", planes[0]), ("out", out[0])):
        if (h - 1) * t.stride(1) + (w - 1) * t.stride(2) + 3 >= 2**31:
            raise ValueError(f"kernel G: a frame of {name} spans 2^31 bytes or more")
    tables = _const_tables_on(str(planes[0].device))
    ptr = {k: v.data_ptr() for k, v in args.items()}
    with torch.cuda.device(planes[0].device):
        for f0, n in kernels.batch_runs(bsz, batch_limit):
            kernels.POINTWISE.launch(
                *(p[f0].data_ptr() for p in planes), *(o[f0].data_ptr() for o in out),
                *planes[0].stride(), *out[0].stride(), n, h, w,
                ptr["gains"] + 12 * f0 if "gains" in ptr else None, ptr.get("matrix"),
                ptr.get("bias"), ptr.get("lut"), ptr.get("mask"), ptr.get("lab"), ptr.get("enh"),
                ptr["wb"] + 768 * f0 if "wb" in ptr else None,
                ptr["wb_nan"] + 3 * f0 if "wb_nan" in ptr else None, nan_limit,
                tables.data_ptr(), kernels.stream_handle(out[0]),
            )


def pointwise_planes(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor, *, wb_tables=None,
                     wb_nan=None, nan_limit=None, gains=None, matrix=None, bias=None, lut=None,
                     mask=None, lab_tab=None, enhancer_tables=None, out=None,
                     plain: bool = False):
    """The pointwise stretch on three [B, h, W] u8 planes: kernel G on CUDA
    planes (pointwise_cuda), pointwise_plain on CPU planes or with
    plain=True. With no step given the planes come back as they are. With
    `out`, three planes of the input's shape (views of one [B, h, W, 3]
    tensor, say), the result is written there (G writes it directly) and
    `out` comes back."""
    _check_steps(matrix, bias, mask, lab_tab, wb_tables, wb_nan)
    steps = dict(wb_tables=wb_tables, gains=gains, matrix=matrix, bias=bias, lut=lut,
                 mask=mask, lab_tab=lab_tab, enhancer_tables=enhancer_tables)
    on = any(v is not None for v in steps.values())
    steps.update(wb_nan=wb_nan, nan_limit=nan_limit)
    if not plain and b.device.type != "cpu" and on:
        return pointwise_cuda((b, g, r), out=out, **steps)
    planes = pointwise_plain(b, g, r, **steps) if on else (b, g, r)
    if out is None:
        return planes
    for o, p in zip(out, planes):
        o.copy_(p)
    return tuple(out)


def pointwise_image(image: torch.Tensor, **steps) -> torch.Tensor:
    """Kernel G on [..., H, W, 3] u8 CUDA frames, written straight into a
    new [..., H, W, 3] tensor: the op layer's NHWC entry points."""
    lead, planes = image_planes(image)
    out = torch.empty(image.shape, dtype=torch.uint8, device=image.device)
    flat = out.reshape((-1,) + tuple(out.shape[-3:]))
    pointwise_cuda(planes, out=(flat[..., 0], flat[..., 1], flat[..., 2]), **steps)
    return out
