"""Functional ISP pipeline assembly (PyTorch port of
raw_image_pipeline_tpu/pipeline.py, planar path).

    isp = build_pipeline(config, "bayer_gbrg8", frame_hw, device="cuda")
    outputs, state = isp(pixels, state)

The chain runs eagerly on planar [B, H, W] u8 planes in B, G, R order (one
plane for mono frames), in the reference's fixed stage order: flip (hoisted
onto the mosaic for even 8-bit Bayer frames) -> debayer (bilinear = kernel
A, or the GPU-parity MHT = kernel D, on CUDA; 16-bit Bayer demosaiced in
int32 and scaled to 8 bits; colour and mono frames pass through) -> white
balance (CCC: resize, histogram = kernel B, response = kernel C, argmax,
Kalman, gains; or simple, grey_world, learned, pca: statistics = kernel K,
learned's histogram = kernel L, per-frame tables = kernel M, applied by
kernel G's table step) -> colour calibration
-> gamma (the k table, or the GPU backend's BT.709 table) -> vignetting ->
HSV enhancer (the pointwise stretch, with the CCC gains: one launch of
kernel G on CUDA, STRETCH and pointwise_steps) -> fisheye undistortion
(lerp and fixed32 = kernel F, float = kernel E on CUDA). Numeric
parameters live in `IspParams`, tensors on the pipeline's device; every
small table is its exact host table, applied as a gather. Mono frames
skip white balance, colour calibration, vignetting and the enhancer, as
the reference does.

The camera-blocked multicamera form (make_isp_fn(..., n_cameras=C), built
by parallel/multicamera.py) flattens [C, B, ...] frames camera-major into
one batch for every shared-parameter stage, routes each camera's block
through its own remap map where the maps are stacked, and gives each
camera its own Kalman track.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raw_image_pipeline_tpu_torch.config import PipelineConfig
from raw_image_pipeline_tpu_torch.models.ccc_model import CCCModel, load_ccc_model
from raw_image_pipeline_tpu_torch.ops import ccc as ccc_ops
from raw_image_pipeline_tpu_torch.ops.color_enhancer import gain_tables
from raw_image_pipeline_tpu_torch.ops.colorspace import _GAMMA_TAB
from raw_image_pipeline_tpu_torch.ops.common import resolve_device
from raw_image_pipeline_tpu_torch.ops.debayer import (
    _ALGORITHMS,
    BAYER16_ENCODINGS,
    BAYER_ENCODINGS,
    debayer16_planes,
    debayer_planes,
)
from raw_image_pipeline_tpu_torch.ops.flip import flip_rows, flipped_bayer_encoding
from raw_image_pipeline_tpu_torch.ops.flip import flipped_shape as _post_flip_shape
from raw_image_pipeline_tpu_torch.ops.gamma import apply_lut, build_bt709_lut, build_gamma_lut
from raw_image_pipeline_tpu_torch.ops.resize import resize_planes
from raw_image_pipeline_tpu_torch.ops.undistortion import (
    estimate_new_camera_matrix,
    init_undistort_rectify_map,
    remap_fixed32_code,
    remap_planes,
    remap_precompute,
)
from raw_image_pipeline_tpu_torch.ops.pointwise import pointwise_planes
from raw_image_pipeline_tpu_torch.ops.vignetting import (
    build_vignetting_mask,
    composed_gamma_lab_table,
)
from raw_image_pipeline_tpu_torch.ops.white_balance import METHODS, pca_nan_limit, wb_tables
from raw_image_pipeline_tpu_torch.utils.profiling import CALL_SPAN, span

# Cross-frame state: the CCC Kalman illuminant track.
IspState = ccc_ops.KalmanState


@dataclass
class IspParams:
    """Numeric pipeline parameters, tensors on the pipeline's device (None
    for a stage that is off)."""

    color_matrix: torch.Tensor  # [3, 3] f32
    color_bias: torch.Tensor  # [3] f32
    # [256] u8, the gamma table: the reference's k LUT, or the GPU
    # backend's BT.709 table (gamma_correction.gpu with method "default")
    gamma_lut: torch.Tensor
    # [256] int32 Lab linearize table with the k LUT composed in, used by the
    # vignetting forward when the k gamma feeds it directly (colour frames,
    # not debug); the plain sRGB linearize table when the k gamma is off
    lab_gamma_tab: torch.Tensor
    enhancer_tables: torch.Tensor  # [3, 256] u8 exact (H, S, V) gain tables
    vignetting_mask: Optional[torch.Tensor]  # [H, W] f32 (post-flip dims)
    # remap_precompute's factors in the configured mode: base [Ho*Wo] int32
    # (lerp: with the pack margin), weights [6, Ho*Wo] f32 in lerp mode,
    # [4, Ho*Wo] f32 in float and fixed32 modes
    remap_base: Optional[torch.Tensor]
    remap_weights: Optional[torch.Tensor]
    ccc_filt_dft_re: Optional[torch.Tensor]  # [256, 256] f32
    ccc_filt_dft_im: Optional[torch.Tensor]
    ccc_bias: Optional[torch.Tensor]
    ccc_exp_tab: Optional[torch.Tensor]  # [256] f32, exp_table(uv0)
    # pre-scaled 255*threshold cuts and the log-chroma origin, f32 values
    ccc_bright_cut: float = 0.0
    ccc_dark_cut: float = 0.0
    ccc_uv0: float = 0.0
    # the source rows [start, stop) remap_base indexes (a slab of the
    # spatial split: its map rebased to its window; None: the whole frame)
    remap_window: Optional[Tuple[int, int]] = None
    # fixed32 mode: kernel F's compact map of remap_weights, int16 [Ho*Wo]
    # (stacked [n_cameras, Ho*Wo] as the maps), undistortion.remap_fixed32_code;
    # None in the other modes
    remap_code: Optional[torch.Tensor] = None


def _runs_undistortion(config: PipelineConfig) -> bool:
    calib = config.calibration
    return (
        config.undistortion.enabled
        and calib.calibration_available
        and calib.distortion_model != "none"
    )


def _uses_ccc(config: PipelineConfig) -> bool:
    wb = config.white_balance
    return wb.enabled and wb.method == "ccc"


def _uses_bt709(config: PipelineConfig) -> bool:
    """The GPU backend's "default" gamma: the fixed BT.709 table."""
    gc = config.gamma_correction
    return gc.gpu and gc.method == "default"


# the pointwise stretch's steps (kernel G's, ops/pointwise.py) in the chain's
# order, each with its stage's profiler range and the dump point after it:
# the CCC gains, colour calibration, the gamma table as its own step, the
# vignetting with OpenCV's linearize table or with the k gamma composed into
# it, the HSV enhancer
STRETCH = (
    ("gains", "isp_white_balance", "02_white_balancing"),
    ("calibration", "isp_color_calibration", "03_color_calibration"),
    ("lut", "isp_gamma", "04_gamma_correction"),
    ("vignetting", "isp_vignetting", "05_vignetting_correction"),
    ("gamma_vignetting", "isp_vignetting", "05_vignetting_correction"),
    ("enhancer", "isp_color_enhancer", "06_color_enhancer"),
)


def pointwise_steps(config: PipelineConfig, is_color: bool, debug: bool) -> Tuple[str, ...]:
    """The pointwise stretch's steps (STRETCH's names) the chain runs on
    colour frames, in order; none on mono frames, which skip all but the
    gamma table, and run it as their own stage. The k gamma table folds
    into vignetting's linearize table ("gamma_vignetting") where it feeds
    straight into it, except in debug mode, whose 04 dump needs it; the
    BT.709 table never folds."""
    if not is_color:
        return ()
    gc, vig = config.gamma_correction, config.vignetting_correction
    fold = gc.enabled and not _uses_bt709(config) and vig.enabled and not debug
    on = {"gains": _uses_ccc(config), "calibration": config.color_calibration.enabled,
          "lut": gc.enabled and not fold, "vignetting": vig.enabled and not fold,
          "gamma_vignetting": fold, "enhancer": config.color_enhancer.enabled}
    return tuple(name for name, _, _ in STRETCH if on[name])


def pointwise_launches(config: PipelineConfig, is_color: bool, debug: bool,
                       on_card: bool = True) -> Tuple[Tuple[str, ...], ...]:
    """The calls of the stretch the chain makes, each a tuple of steps: on
    the card one call of kernel G for all the steps (none without a step),
    in debug mode or with the plain versions (on_card False) one call a
    step, each in its stage's range."""
    steps = pointwise_steps(config, is_color, debug)
    if on_card and not debug:
        return (steps,) if steps else ()
    return tuple((s,) for s in steps)


def _step_args(steps, params: IspParams, gains) -> dict:
    """pointwise_planes's arguments for `steps` (STRETCH's names)."""
    args = {}
    for step in steps:
        if step == "gains":
            args["gains"] = gains
        elif step == "calibration":
            args.update(matrix=params.color_matrix, bias=params.color_bias)
        elif step == "lut":
            args["lut"] = params.gamma_lut
        elif step == "vignetting":
            args["mask"] = params.vignetting_mask
        elif step == "gamma_vignetting":
            args.update(mask=params.vignetting_mask, lab_tab=params.lab_gamma_tab)
        elif step == "enhancer":
            args["enhancer_tables"] = params.enhancer_tables
    return args


def _statistical_wb(wb):
    """(method, its parameter) of a statistical white balance
    (ops/white_balance.METHODS), or None for an unknown method."""
    method = "grey_world" if wb.method == "gray_world" else wb.method
    if method not in METHODS:
        return None
    return method, (wb.clipping_percentile if method == "simple" else wb.saturation_bright_thr)


def _check_pixels(pixels: torch.Tensor, encoding: str) -> None:
    """Raise ValueError unless pixels fit the encoding: [B, H, W] uint8 for
    8-bit Bayer, [B, H, W] uint16 for 16-bit Bayer, and [B, H, W, 3]
    (colour) or [B, H, W] / [B, H, W, 1] (mono) uint8 otherwise."""
    shape, dtype = tuple(pixels.shape), pixels.dtype
    if encoding in BAYER_ENCODINGS:
        ok, want = pixels.dim() == 3 and dtype == torch.uint8, "[B, H, W] uint8"
    elif encoding in BAYER16_ENCODINGS:
        ok, want = pixels.dim() == 3 and dtype == torch.uint16, "[B, H, W] uint16"
    else:
        ok = dtype == torch.uint8 and (
            pixels.dim() == 3 or (pixels.dim() == 4 and shape[-1] in (1, 3)))
        want = "[B, H, W, 3], [B, H, W] or [B, H, W, 1] uint8"
    if not ok:
        raise ValueError(f"pixels for [{encoding}]: expected {want}, got {shape} {dtype}")


def remap_fields(config: PipelineConfig,
                 src_hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """The remap's base and weights (remap_precompute in the configured
    mode) for config's calibration, over a source of src_hw (post-flip)."""
    calib = config.calibration
    size = (calib.image_width, calib.image_height)
    new_size = config.undistortion.new_image_size or size
    new_K = estimate_new_camera_matrix(
        calib.K(), calib.D(), size, calib.R(),
        config.undistortion.balance, new_size, config.undistortion.fov_scale,
    )
    mx, my = init_undistort_rectify_map(calib.K(), calib.D(), calib.R(), new_K, size)
    return remap_precompute(mx, my, src_hw, mode=config.undistortion.interpolation)


def _host_fields(config: PipelineConfig, frame_hw: Tuple[int, int],
                 ccc_model: Optional[CCCModel] = None) -> Dict[str, np.ndarray]:
    """The numbers the reference package's make_params puts in its IspParams,
    as numpy arrays (same names; only the fields the port reads). The CCC
    filter comes from ccc_model, or from wbc.ccc_model_path where it is
    None."""
    h, w = frame_hw
    fh, fw = _post_flip_shape(h, w, config.flip.angle if config.flip.enabled else 0)
    fields: Dict[str, np.ndarray] = {
        "color_matrix": np.asarray(config.color_calibration.matrix_np(), np.float32),
        "color_bias": np.asarray(config.color_calibration.bias_np(), np.float32),
    }
    vig = config.vignetting_correction
    if vig.enabled:
        fields["vignetting_mask"] = build_vignetting_mask(fh, fw, vig.scale, vig.a2, vig.a4)
    if _runs_undistortion(config):
        fields["remap_base"], fields["remap_weights"] = remap_fields(config, (fh, fw))
    wbc = config.white_balance
    if _uses_ccc(config):
        if ccc_model is None:
            ccc_model = load_ccc_model(wbc.ccc_model_path)
        fields["ccc_filt_dft_re"] = ccc_model.filt_dft_re
        fields["ccc_filt_dft_im"] = ccc_model.filt_dft_im
        fields["ccc_bias"] = ccc_model.bias
        # f64 products narrowed to f32, as the reference package
        fields["ccc_bright_cut"] = np.float32(255.0 * wbc.saturation_bright_thr)
        fields["ccc_dark_cut"] = np.float32(255.0 * wbc.saturation_dark_thr)
        fields["ccc_uv0"] = np.float32(wbc.ccc_uv0)
    return fields


def params_from_numpy(fields, config: PipelineConfig, device="cuda") -> IspParams:
    """The port's parameters from numpy arrays named as the reference
    package's IspParams fields (a mapping, or an object with those
    attributes, e.g. the reference's params after jax.tree.map(np.asarray)),
    so that both sides compute from the same numbers. The exact tables
    (gamma or BT.709, composed Lab linearize, enhancer gains, exp) come
    from config and the uv0 field."""
    if not isinstance(fields, Mapping):
        fields = vars(fields)
    dev = resolve_device(device)

    def t(name: str, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.array(fields[name]), device=dev).to(dtype).contiguous()

    def opt(name: str, dtype: torch.dtype, on: bool) -> Optional[torch.Tensor]:
        return t(name, dtype) if on else None

    use_ccc = _uses_ccc(config)
    undist = _runs_undistortion(config)
    gc = config.gamma_correction
    bt709 = _uses_bt709(config)
    # BT.709 is its own stage (the reference package composes only the k
    # LUT into the vignetting forward), so vignetting then linearizes plain
    gamma_lut = build_bt709_lut(gc.k <= 1.0) if bt709 else build_gamma_lut(gc.k)
    lab_tab = composed_gamma_lab_table(gc.k) if gc.enabled and not bt709 else _GAMMA_TAB
    ce = config.color_enhancer
    uv0 = float(np.float32(fields["ccc_uv0"])) if use_ccc else 0.0
    return IspParams(
        color_matrix=t("color_matrix", torch.float32).reshape(3, 3),
        color_bias=t("color_bias", torch.float32).reshape(3),
        gamma_lut=torch.as_tensor(gamma_lut, device=dev),
        lab_gamma_tab=torch.as_tensor(np.asarray(lab_tab, np.int32), device=dev),
        enhancer_tables=torch.as_tensor(
            gain_tables([ce.hue_gain, ce.saturation_gain, ce.value_gain]), device=dev
        ),
        vignetting_mask=opt("vignetting_mask", torch.float32,
                            config.vignetting_correction.enabled),
        remap_base=opt("remap_base", torch.int32, undist),
        remap_weights=opt("remap_weights", torch.float32, undist),
        ccc_filt_dft_re=opt("ccc_filt_dft_re", torch.float32, use_ccc),
        ccc_filt_dft_im=opt("ccc_filt_dft_im", torch.float32, use_ccc),
        ccc_bias=opt("ccc_bias", torch.float32, use_ccc),
        ccc_exp_tab=(torch.as_tensor(ccc_ops.exp_table(uv0), device=dev)
                     if use_ccc else None),
        ccc_bright_cut=float(np.float32(fields["ccc_bright_cut"])) if use_ccc else 0.0,
        ccc_dark_cut=float(np.float32(fields["ccc_dark_cut"])) if use_ccc else 0.0,
        ccc_uv0=uv0,
        remap_code=remap_code_of(fields["remap_weights"], config, dev) if undist else None,
    )


def remap_code_of(weights, config: PipelineConfig, device) -> Optional[torch.Tensor]:
    """The chain's compact fixed32 map (undistortion.remap_fixed32_code) of
    the remap weights `weights` (host array, [4, N] or stacked per camera)
    on `device` in fixed32 mode; None in the other modes."""
    if config.undistortion.interpolation != "fixed32":
        return None
    return torch.as_tensor(remap_fixed32_code(np.asarray(weights)), device=device).contiguous()


def make_params(config: PipelineConfig, frame_hw: Tuple[int, int],
                ccc_model: Optional[CCCModel] = None, *, device="cuda") -> IspParams:
    """Build the parameters for frames of shape frame_hw (pre-flip, i.e.
    sensor orientation) on `device`. ccc_model (models/ccc_model.CCCModel,
    e.g. one trained or changed in memory) gives the CCC filter; None loads
    the configuration's ccc_model_path."""
    return params_from_numpy(_host_fields(config, frame_hw, ccc_model), config, device)


def init_state(batch_shape: Tuple[int, ...] = (), *, device="cuda") -> IspState:
    """Fresh temporal-consistency state (the reference's first_frame_=true)."""
    return ccc_ops.kalman_init(batch_shape, device=device)


def state_from_numpy(x, p, initialized, device="cuda") -> IspState:
    """The port's Kalman state from the reference package's KalmanState
    fields as numpy arrays."""
    dev = resolve_device(device)
    return ccc_ops.KalmanState(
        x=torch.as_tensor(np.array(x, np.float32), device=dev),
        p=torch.as_tensor(np.array(p, np.float32), device=dev),
        initialized=torch.as_tensor(np.array(initialized, bool), device=dev),
    )


def save_state(state: IspState, path: str) -> None:
    """Checkpoint the cross-frame state (the CCC Kalman track) to an .npz,
    in the reference package's format (keys x, p, initialized), so that a
    state saved by either package loads into the other."""
    np.savez(
        path,
        x=state.x.cpu().numpy(),
        p=state.p.cpu().numpy(),
        initialized=state.initialized.cpu().numpy(),
    )


def load_state(path: str, *, device="cuda") -> IspState:
    """Restore a checkpoint written by save_state (of either package)."""
    d = np.load(path)
    return state_from_numpy(d["x"], d["p"], d["initialized"], device)


def make_isp_fn(
    config: PipelineConfig,
    encoding: str,
    with_state: bool,
    keep_intermediates: bool = True,
    debug: bool = False,
    temporal_mode: str = "cameras",
    remap_src_hw: Optional[Tuple[int, int]] = None,
    planar_internals: bool = True,
    remap_tuning: Optional[Tuple[int, int]] = None,
    n_cameras: int = 1,
    mesh_devices: int = 1,
    *,
    plain: bool = False,
):
    """The chain for a fixed encoding: fn(params, pixels, state) ->
    (outputs, new_state), pixels on the params' device: [B, H, W] uint8
    Bayer, [B, H, W] uint16 16-bit Bayer (with DebayerConfig.bayer16
    "scale8"), [B, H, W, 3] uint8 colour ("rgb8" is reversed to BGR, other
    encodings pass through) or [B, H, W] / [B, H, W, 1] uint8 mono. On
    CUDA the chain launches the hand-written kernels; plain=True runs every
    op on its plain version instead (the card's reference chain). The
    parameters sit at the reference package's positions; plain, the port's
    own, is keyword-only.

    outputs["processed"] is [B, Ho, Wo, 3] u8 BGR (mono: the input's
    layout); with keep_intermediates also "debayered" (post-flip) and
    "dist_color" (pre-undistort). With debug=True, every stage's output is
    also returned, packed, under "debug/00_debayer" .. "debug/07_undistortion",
    in the reference's stage order (no flip hoist, no gamma fold).
    temporal_mode (CCC temporal consistency with state): "cameras" — one
    Kalman track per batch entry; "sequence" — one track advanced through
    the batch in order.

    n_cameras > 1 is the camera-blocked multicamera form (the reference
    package's, see parallel/multicamera.py): pixels arrive as [n_cameras,
    B, ...] and are flattened camera-major to one [n_cameras*B] batch, so
    that every shared-parameter stage runs once over all cameras; where
    params.remap_base is stacked [n_cameras, N] (distinct calibrations)
    each camera's block goes through its own map, a flat [N] map serves
    the whole batch. State: [n_cameras, B, ...] tracks in "cameras" mode,
    one track per camera ([n_cameras, ...]) in "sequence" mode, advanced
    through its own block's frames. Outputs and state come back with their
    [n_cameras, B] leading axes.

    planar_internals, remap_tuning and mesh_devices are accepted and
    ignored: in the reference package they choose the TPU program's layout
    (packed [..., 3] or planar), its remap gather's pack and chunking, and
    the implementations GSPMD can partition over a mesh, and every choice
    gives the same bytes. The port runs one planar chain, and a mesh is
    build_pipeline's mesh=."""
    from raw_image_pipeline_tpu_torch.parallel.spatial import Part, run_whole

    chain = make_isp_chain(config, encoding, with_state, keep_intermediates,
                           temporal_mode=temporal_mode, remap_src_hw=remap_src_hw,
                           debug=debug, n_cameras=n_cameras, plain=plain)

    def fn(params: IspParams, pixels: torch.Tensor, state: Optional[IspState]):
        outputs, state, _ = run_whole(chain(params, pixels, state, Part()))
        return outputs, state

    return fn


def make_isp_chain(
    config: PipelineConfig,
    encoding: str,
    with_state: bool,
    keep_intermediates: bool = True,
    *,
    temporal_mode: str = "cameras",
    remap_src_hw: Optional[Tuple[int, int]] = None,
    debug: bool = False,
    n_cameras: int = 1,
    camera_blocked: Optional[bool] = None,
    plain: bool = False,
):
    """make_isp_fn's chain as a generator over one slab of the frame
    (parallel/spatial.py): chain(params, pixels, state, part) runs the
    stages on the part's rows of pixels (all of them for Part()), yields a
    request where slabs exchange rows or numbers, and returns (outputs,
    state, heights), heights[key] the global row count of outputs[key]
    (the slab's rows are part.rows(heights[key])). camera_blocked: the
    [n_cameras, B, ...] form (default n_cameras > 1; True with one camera
    keeps the camera axis)."""
    from raw_image_pipeline_tpu_torch.parallel.spatial import (
        Fetch,
        GatherData,
        SumSpace,
        debayer_halo,
        flip180_rows,
        resize_slab,
    )

    if temporal_mode not in ("cameras", "sequence"):
        raise ValueError(f"unknown temporal_mode [{temporal_mode}]")
    deb = config.debayer
    if encoding in BAYER16_ENCODINGS and deb.bayer16 == "error":
        # the reference throws for the 16-bit patterns (debayer.cpp:76-78)
        raise ValueError(f"Encoding [{encoding}] is a valid pattern but is not supported!")
    algorithm = deb.algorithm
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"Unknown demosaic algorithm: {algorithm}")
    blocked = n_cameras > 1 if camera_blocked is None else camera_blocked
    wb = config.white_balance
    use_ccc = _uses_ccc(config)
    use_kalman = use_ccc and wb.temporal_consistency and with_state
    stat_wb = _statistical_wb(wb)
    run_undist = _runs_undistortion(config)
    gc = config.gamma_correction
    calib = config.calibration
    flip_angle = config.flip.angle if config.flip.enabled else 0
    # the CPU-parity demosaic carries the reference CPU path's R<->B swap
    # (debayer.cpp:49-52); the GPU-parity MHT has none
    cpu_swap = algorithm != "mht"
    bayer8 = encoding in BAYER_ENCODINGS
    bayer = bayer8 or encoding in BAYER16_ENCODINGS
    # flip the 1-channel mosaic instead of the three planes wherever the
    # rotated pattern has an exact demosaic equivalent (8-bit, even sizes);
    # debug keeps the reference's order for its 00_debayer dump
    hoist_enc = flipped_bayer_encoding(encoding, flip_angle) if bayer8 and not debug else None
    mono_axis_possible = not bayer

    def flipped_rows(tensors, have, h, angle, want):
        """Rows `want` of the flip of the frame whose rows `have` are
        `tensors` (the 180 rule, or the gather rule for 90 and 270): on the
        card one launch of kernel N for all the tensors, which writes only
        those rows."""
        if angle == 180:
            src = yield Fetch(tensors, have, flip180_rows(h, *want))
            return flip_rows(src, 180, plain=plain)
        if angle in (90, 270):
            full = yield Fetch(tensors, have, (0, h))
            return flip_rows(full, angle, want, plain=plain)
        return (yield Fetch(tensors, have, want))

    def chain(params: IspParams, pixels: torch.Tensor, state: Optional[IspState], part: Part):
        cam_b = 0
        if blocked:
            if pixels.dim() < 2 or pixels.shape[0] != n_cameras:
                raise ValueError(f"pixels: expected [{n_cameras}, B, ...] for {n_cameras} "
                                 f"cameras, got {tuple(pixels.shape)}")
            cam_b = pixels.shape[1]
            pixels = pixels.reshape((-1,) + tuple(pixels.shape[2:]))
            if state is not None and temporal_mode != "sequence":
                state = _map_state(lambda v: v.reshape((-1,) + tuple(v.shape[2:])), state)
        _check_pixels(pixels, encoding)
        outputs: Dict[str, torch.Tensor] = {}
        heights: Dict[str, int] = {}
        img = pixels
        # mono frames may arrive as [B, H, W, 1]: processed as [B, H, W],
        # the trailing axis restored on exit
        mono_axis = mono_axis_possible and img.dim() == 4 and img.shape[-1] == 1
        if mono_axis:
            img = img[..., 0]
        # the frame's rows (all of them, or this part's slab of them)
        h = part.height if part.height is not None else img.shape[1]
        w = img.shape[2]
        rows = part.rows(h)

        def pack(planes):
            if len(planes) != 3:
                return planes[0]
            with span("isp_pack"):
                return torch.stack(planes, dim=-1)

        def keep(name, planes, height):
            outputs[name] = pack(planes)
            heights[name] = height

        def dump(name, planes):
            # the reference's stage dump points (raw_image_pipeline.hpp:144-172)
            if debug:
                keep("debug/" + name, planes, h)

        # each stage is a profiler range (torch.profiler attributes time per
        # ISP stage, as the reference package's jax.named_scope do)
        with span("isp_debayer"):
            hoist = hoist_enc is not None and w % 2 == 0 and h % 2 == 0
            if hoist:
                # the flipped mosaic's slab and its debayer halo
                fh, fw = _post_flip_shape(h, w, flip_angle)
                mine = part.rows(fh)
                halo = debayer_halo(fh, *mine)
                (img,) = yield from flipped_rows((img,), rows, h, flip_angle, halo)
                h, w, rows = fh, fw, mine
            elif bayer:
                halo = debayer_halo(h, *rows)
                (img,) = yield Fetch((img,), rows, halo)
            if bayer8:
                planes = debayer_planes(img, hoist_enc if hoist else encoding, algorithm,
                                        plain=plain)
                if cpu_swap:
                    planes = planes[::-1]
            elif encoding in BAYER16_ENCODINGS:
                # demosaic at full depth, then scale into the 8-bit chain
                # (always the bilinear stencil, as the reference package):
                # on the card one launch of kernel P, which writes the
                # scaled planes
                planes = debayer16_planes(img, encoding, plain=plain)
                if cpu_swap:
                    planes = planes[::-1]
            elif encoding == "rgb8" and img.dim() == 4:  # the channels reversed, as views
                planes = (img[..., 2], img[..., 1], img[..., 0])
            else:
                if encoding == "rgb8":  # one channel: the JAX package's [..., ::-1] reverses W
                    img = torch.flip(img, dims=(-1,))
                # other encodings pass through untouched (debayer.cpp:75)
                planes = (img[..., 0], img[..., 1], img[..., 2]) if img.dim() == 4 else (img,)
            if bayer and halo != rows:  # the slab without its halo
                planes = tuple(p[:, rows[0] - halo[0]:rows[1] - halo[0]] for p in planes)
        dump("00_debayer", planes)
        is_color = len(planes) == 3

        if config.flip.enabled and not hoist:
            with span("isp_flip"):
                fh, fw = _post_flip_shape(h, w, config.flip.angle)
                mine = part.rows(fh)
                planes = yield from flipped_rows(planes, rows, h, config.flip.angle, mine)
                h, w, rows = fh, fw, mine
        if keep_intermediates:
            keep("debayered", planes, h)
        dump("01_flip", planes)

        # the pointwise stretch's calls (pointwise_launches): one of kernel G
        # on the card, under the range isp_pointwise
        launches = pointwise_launches(config, is_color, debug,
                                      not plain and planes[0].device.type != "cpu")
        gains = None
        wb_args = {}  # a statistical white balance's table step (pointwise_planes's)
        # the [B, H, W, 3] output where the chain's last pointwise call writes
        # it (no remap, no debug dumps after it), so that no stack of the
        # planes follows
        packed = None
        # the statistical methods, colour calibration, vignetting and the
        # enhancer are skipped for mono frames (white_balance.hpp:50-52)
        if wb.enabled and is_color:
            with span("isp_white_balance"):
                if use_ccc:
                    # on the card kernels H, B, C, I and J, one launch each
                    # (C four grids), no copy and no sync
                    if part.count == 1:
                        small = resize_planes(planes, h, ccc_ops.SMALL_H, ccc_ops.SMALL_W,
                                              plain=plain)
                        hist = ccc_ops.log_chroma_histogram_planes(
                            *small, params.ccc_bright_cut, params.ccc_dark_cut,
                            params.ccc_uv0, plain=plain,
                        )
                    else:
                        # the slab's resized rows, their integer counts
                        # summed over the slabs, scaled once
                        y0, y1, a, b = resize_slab(h, ccc_ops.SMALL_H, *rows)
                        src = yield Fetch(planes, rows, (a, b))
                        small = resize_planes(src, h, ccc_ops.SMALL_H, ccc_ops.SMALL_W, y0, y1,
                                              a, plain=plain)
                        counts = ccc_ops.log_chroma_histogram_planes(
                            *small, params.ccc_bright_cut, params.ccc_dark_cut,
                            params.ccc_uv0, plain=plain, pixel_weight=1.0,
                        )
                        total = yield SumSpace(counts)
                        hist = total.float() * ccc_ops.frame_pixel_weight(
                            ccc_ops.SMALL_H, ccc_ops.SMALL_W)
                    resp = ccc_ops.ccc_response(
                        hist, params.ccc_filt_dft_re, params.ccc_filt_dft_im, params.ccc_bias,
                        plain=plain,
                    )
                    uv = ccc_ops.response_argmax(resp, plain=plain)
                    # the peaks walked as Kalman tracks (ccc_ops.track_gains):
                    # a track a frame ("cameras" mode, or the gains alone)
                    n, first = uv.shape[0], 0
                    track = dict(track_shape=(n,))
                    if use_kalman and temporal_mode == "sequence":
                        if blocked:
                            # one track per camera through its own block's frames
                            track = dict(track_shape=(n_cameras,), steps=cam_b)
                        else:
                            # batch axis = time: one track advanced through
                            # every frame of the batch (of every data shard)
                            uv, first = yield GatherData(uv)
                            track = dict(track_shape=(), steps=uv.shape[0])
                    new_state, gains = ccc_ops.track_gains(
                        uv, params.ccc_exp_tab, state if use_kalman else None, plain=plain,
                        **track)
                    if use_kalman:
                        state = new_state
                    gains = gains[first:first + n]
                    if ("gains",) in launches:  # a call of its own: else G's first step
                        planes = pointwise_planes(*planes, gains=gains, plain=plain)
                elif stat_wb is not None:
                    # the gather rule: the frame's statistics need all rows;
                    # on the card kernels K (L) and M, then the tables applied
                    # to the slab's own rows by G's table step: a call of its
                    # own where no stretch follows (or with the plain
                    # versions), else the first step of G's call
                    full = yield Fetch(planes, rows, (0, h))
                    t = wb_tables(full, *stat_wb, plain=plain)
                    wb_args = dict(wb_tables=t.tables, wb_nan=t.nan,
                                   nan_limit=pca_nan_limit(h, w) - rows[0] * w)
                    if not (launches and not debug and not plain
                            and planes[0].device.type != "cpu"):
                        if not launches and not run_undist and not debug:
                            packed = torch.empty(tuple(planes[0].shape) + (3,),
                                                 dtype=torch.uint8, device=planes[0].device)
                        planes = pointwise_planes(
                            *planes, plain=plain,
                            out=None if packed is None else packed.unbind(-1), **wb_args)
                        wb_args = {}
                else:
                    raise ValueError(f"White Balance method [{wb.method}] not supported")
        dump("02_white_balancing", planes)

        # the other calls, each after the stage of its last step; every dump
        # point after its stage (a dump point is reached whether or not its
        # stage runs). Where the stretch's last call ends the chain, it writes
        # `packed` (on the card G writes it).
        last = {launch[-1]: launch for launch in launches if launch != ("gains",)}
        final = launches[-1] if launches and not run_undist and not debug else None
        for i, (name, stage_range, point) in enumerate(STRETCH[1:], start=1):
            launch = last.get(name)
            if launch is not None:
                with span(stage_range if len(launch) == 1 else "isp_pointwise"):
                    if launch == final:
                        packed = torch.empty(tuple(planes[0].shape) + (3,), dtype=torch.uint8,
                                             device=planes[0].device)
                    planes = pointwise_planes(*planes, plain=plain,
                                              out=None if packed is None else packed.unbind(-1),
                                              **_step_args(launch, params, gains), **wb_args)
                    wb_args = {}
            elif name == "lut" and gc.enabled and not is_color:
                with span("isp_gamma"):  # on the card G's table step on one plane
                    planes = tuple(apply_lut(p, params.gamma_lut, plain=plain) for p in planes)
            if i + 1 == len(STRETCH) or STRETCH[i + 1][2] != point:
                dump(point, planes)

        if keep_intermediates:
            keep("dist_color", planes, h)
        if run_undist:
            with span("isp_undistortion"):
                if remap_src_hw is not None and (h, w) != tuple(remap_src_hw):
                    raise ValueError(
                        f"remap precomputed for source {tuple(remap_src_hw)} but got "
                        f"frame {(h, w)}; rebuild the pipeline for this frame size"
                    )
                # the source rows the slab's map reads (every row unsharded)
                window = yield Fetch(planes, rows, params.remap_window or (0, h))
                ho, wo = calib.image_height, calib.image_width
                o0, o1 = part.rows(ho)
                img = remap_planes(
                    window, params.remap_base, params.remap_weights, (o1 - o0, wo),
                    config.undistortion.interpolation, plain=plain, code=params.remap_code,
                )
                if not is_color:
                    img = img[..., 0]
                h = ho
        else:
            img = packed if packed is not None else pack(planes)
        if debug:
            outputs["debug/07_undistortion"] = img
            heights["debug/07_undistortion"] = h
        outputs["processed"] = img[..., None] if mono_axis else img
        heights["processed"] = h
        if blocked:
            # the [C, B] leading axes back on every output and on the
            # flattened "cameras"-mode state
            outputs = {k: v.reshape((n_cameras, cam_b) + tuple(v.shape[1:]))
                       for k, v in outputs.items()}
            if state is not None and temporal_mode != "sequence":
                state = _map_state(lambda v: v.reshape((n_cameras, cam_b) + tuple(v.shape[1:])),
                                   state)
        return outputs, state, heights

    return chain


def _map_state(f, state: IspState) -> IspState:
    """f applied to every field of a Kalman state."""
    return ccc_ops.KalmanState(x=f(state.x), p=f(state.p), initialized=f(state.initialized))


def _chunked_fn(inner_fn, microbatch: int):
    """fn processing the batch as sequential chunks of `microbatch` frames
    (the reference package's _chunked_fn, as a loop): the state is carried
    through the chunks in order, and a remainder shorter than `microbatch`
    runs as one more chunk. Equal to inner_fn on the whole batch."""

    def fn(params: IspParams, pixels: torch.Tensor, state: Optional[IspState]):
        if pixels.shape[0] <= microbatch:
            return inner_fn(params, pixels, state)
        chunks = []
        for start in range(0, pixels.shape[0], microbatch):
            out, state = inner_fn(params, pixels[start:start + microbatch], state)
            chunks.append(out)
        with span("isp_pack"):
            return {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}, state

    return fn


def impls_for_devices(devices) -> Dict[str, Tuple[str, ...]]:
    """The implementation each shard on `devices` runs, per op: "cuda" (the
    hand-written kernels A/D, B, C, E/F) on a card, "plain" (the plain
    PyTorch versions) on the CPU. Unlike the JAX package, which pins
    GSPMD-partitionable XLA formulations on any multi-device mesh (GSPMD
    cannot partition a pallas_call), the port splits the work itself and
    keeps its kernels on every shard."""
    impl = tuple("cuda" if torch.device(d).type == "cuda" else "plain" for d in devices)
    return {op: impl for op in ("demosaic", "histogram", "response", "remap_blend")}


class BuiltPipeline:
    """A pipeline built for one configuration, encoding and frame size:
    `outputs, state = pipe(pixels, state)`.

    With a mesh (build_pipeline's mesh= or spatial_shards=), pixels may be
    a ShardedBatch (parallel.mesh.shard_batch, multihost.distribute_batch)
    or a global batch, which the call splits; every output comes back as a
    ShardedBatch (`.gather(device)` gives the tensor). `params` are then
    the whole frame's on the mesh's first device, `shard_params` each
    shard's. selected_impls: see impls_for_devices. ccc_model: the CCC
    model the parameters were built from (None without CCC)."""

    def __init__(self, config: PipelineConfig, params: IspParams, fn, mesh=None,
                 shard_params=None, selected_impls=None,
                 ccc_model: Optional[CCCModel] = None):
        self.config = config
        self.params = params
        self.ccc_model = ccc_model
        self.fn = fn
        self.mesh = mesh
        self.shard_params = shard_params
        self.selected_impls = selected_impls or impls_for_devices([params.color_matrix.device])

    def __call__(self, pixels, state: Optional[IspState] = None):
        with span(CALL_SPAN):  # the root of the stages' spans
            if self.mesh is not None:
                return self.fn(pixels, state)
            return self.fn(self.params, pixels, state)


def build_pipeline(
    config: PipelineConfig,
    encoding: str = "bayer_gbrg8",
    frame_hw: Optional[Tuple[int, int]] = None,
    with_state: bool = False,
    keep_intermediates: bool = False,
    ccc_model: Optional[CCCModel] = None,
    donate: bool = False,
    debug: bool = False,
    temporal_mode: str = "cameras",
    microbatch: Optional[int] = None,
    mesh=None,
    spatial_shards: Optional[int] = None,
    *,
    device="cuda",
) -> BuiltPipeline:
    """Build the ISP for one configuration on `device` ("cuda", the
    default, launches the hand-written kernels and raises without a CUDA
    device; "cpu" runs every op on its plain version).

    frame_hw defaults to the calibration's image size. Input pixels: see
    make_isp_fn. temporal_mode and debug: see make_isp_fn. ccc_model: the
    CCC model to run (see make_params); None loads the configuration's
    ccc_model_path. donate is accepted and ignored: in the reference package
    it donates the input's device buffer to XLA, which eager PyTorch has no
    counterpart of. The parameters sit at the reference package's
    positions; device, the port's own, is keyword-only.

    microbatch: process the batch as sequential chunks of this many frames,
    which bounds the stages' intermediates at one chunk's (e.g. 512 1080p
    frames of a pointwise chain); the whole input and the chunks' outputs
    stay on the device, and their concatenation at the end holds the
    output twice. Equal to the unchunked chain, the Kalman track included.
    A remainder runs as one more chunk.

    mesh (parallel.mesh.make_mesh, multihost.global_data_mesh): run over
    the mesh's devices instead of `device` — frames over "data", each
    frame's rows over "space" in slabs (parallel/spatial.py), every shard
    with the kernels of its device; the call then takes and returns
    sharded batches (see BuiltPipeline). spatial_shards=k alone makes a
    mesh of k logical space shards on `device`; with a mesh it must equal
    its space axis. A sharded call equals the unsharded one byte for byte,
    the Kalman state included, so neither changes a number. "cameras"
    state is split over data with the frames (a process passes its own
    frames' tracks); "sequence" state is one track: every shard gathers
    the batch's CCC measurements (over processes too) and runs the same
    Kalman scan. keep_intermediates, debug and microbatch apply per
    shard."""
    if frame_hw is None:
        frame_hw = (config.calibration.image_height, config.calibration.image_width)
    src_hw = _post_flip_shape(*frame_hw, config.flip.angle if config.flip.enabled else 0)
    if spatial_shards is not None and mesh is not None and spatial_shards != mesh.shape["space"]:
        raise ValueError(f"spatial_shards={spatial_shards} differs from the mesh's space axis "
                         f"{mesh.shape['space']}")
    if mesh is None and spatial_shards is not None and spatial_shards > 1:
        from raw_image_pipeline_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh([resolve_device(device)] * spatial_shards, space=spatial_shards)
    if _uses_ccc(config) and ccc_model is None:
        ccc_model = load_ccc_model(config.white_balance.ccc_model_path)
    fields = _host_fields(config, frame_hw, ccc_model)
    kw = dict(temporal_mode=temporal_mode, remap_src_hw=src_hw, debug=debug)
    if mesh is None:
        fn = make_isp_fn(config, encoding, with_state, keep_intermediates, **kw)
        if microbatch:
            fn = _chunked_fn(fn, microbatch)
        return BuiltPipeline(config, params_from_numpy(fields, config, resolve_device(device)),
                             fn, ccc_model=ccc_model)
    from raw_image_pipeline_tpu_torch.parallel.spatial import (
        MeshFn,
        check_mesh_rows,
        shard_params,
    )

    check_mesh_rows(config, frame_hw, src_hw, mesh)
    per_shard = shard_params(config, fields, mesh, src_hw)
    wb = config.white_balance
    sequence_kalman = (temporal_mode == "sequence" and with_state and _uses_ccc(config)
                       and wb.temporal_consistency)
    chain = make_isp_chain(config, encoding, with_state, keep_intermediates, **kw)
    fn = MeshFn(chain, mesh, per_shard, state_sharded=temporal_mode != "sequence",
                gathers=sequence_kalman, microbatch=microbatch)
    return BuiltPipeline(config, params_from_numpy(fields, config, mesh.devices[0, 0]), fn,
                         mesh=mesh, shard_params=per_shard,
                         selected_impls=impls_for_devices(mesh.local_devices()),
                         ccc_model=ccc_model)
