"""Multi-camera execution on one card (BASELINE config 5: 4 cameras), the
PyTorch port of raw_image_pipeline_tpu/parallel/multicamera.py.

The form is camera-blocked, as in the reference package: frames [C, B, H,
W] flatten camera-major into one batch of C*B, so that every stage whose
parameters the cameras share (debayer, flip, CCC statistics, colour
calibration, gamma∘Lab, vignetting, HSV) runs once over all cameras, and
each of kernels A, B and C launches once per call. Only the undistortion
remap takes parameters per camera: with distinct calibrations the maps are
stacked [C, N] / [C, k, N] and each camera's block of frames goes through
its own map (kernel E in one launch, with grid z over the cameras); with
equal calibrations one flat map serves the whole batch. Each camera keeps
its own Kalman illuminant track.

Cameras share the static configuration (stage enables, white-balance
method, frame size); their calibrations' values differ freely.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from raw_image_pipeline_tpu_torch.config import CameraCalibration, PipelineConfig
from raw_image_pipeline_tpu_torch.ops import ccc as ccc_ops
from raw_image_pipeline_tpu_torch.ops.common import resolve_device
from raw_image_pipeline_tpu_torch.pipeline import (
    BuiltPipeline,
    IspState,
    _post_flip_shape,
    _runs_undistortion,
    make_isp_fn,
    make_params,
    remap_fields,
)


def multicamera_state(n_cameras: int, batch: int = 1, temporal_mode: str = "cameras",
                      device="cuda") -> IspState:
    """Per-camera Kalman state: [n_cameras, batch, ...] tracks in "cameras"
    mode (every batch slot an independent stream), [n_cameras, ...] in
    "sequence" mode (one track per camera, batch axis = time)."""
    if temporal_mode == "sequence":
        return ccc_ops.kalman_init((n_cameras,), device=device)
    return ccc_ops.kalman_init((n_cameras, batch), device=device)


def build_multicamera_pipeline(
    base_config: PipelineConfig,
    calibrations: Sequence[CameraCalibration],
    encoding: str = "bayer_gbrg8",
    frame_hw: Optional[Tuple[int, int]] = None,
    with_state: bool = False,
    temporal_mode: str = "cameras",
    mesh=None,
    device="cuda",
) -> BuiltPipeline:
    """One camera-blocked chain over frames [n_cameras, B, H, W] on
    `device` ("cuda", the default, launches the hand-written kernels;
    "cpu" runs the plain versions): outputs, state = pipe(frames, state),
    every output [n_cameras, B, ...]. Its params carry stacked per-camera
    remap maps where the calibrations differ. mesh: not supported yet (the
    port runs on one card; ROADMAP Queue 1, multi-device)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh: the port runs on one card; multi-device is ROADMAP Queue 1, item 5")
    n = len(calibrations)
    if n == 0:
        raise ValueError("need at least one camera calibration")
    if frame_hw is None:
        frame_hw = (calibrations[0].image_height, calibrations[0].image_width)
    for c in calibrations:
        # calibrations may differ in values but must share the frame size
        if (c.image_height, c.image_width) != tuple(frame_hw):
            raise ValueError("all cameras must share one frame size")
    dev = resolve_device(device)
    config0 = base_config.replace(calibration=calibrations[0])
    params = make_params(config0, frame_hw, dev)
    # the cameras' configs differ only in their calibration, from which
    # only the remap's maps derive; sharing is decided on the host
    # dataclasses, so that equal calibrations give one flat map
    maps_shared = all(c == calibrations[0] for c in calibrations[1:])
    src_hw = _post_flip_shape(*frame_hw,
                              base_config.flip.angle if base_config.flip.enabled else 0)
    if not maps_shared and _runs_undistortion(config0):
        maps = [remap_fields(base_config.replace(calibration=c), src_hw)
                for c in calibrations[1:]]
        params = dataclasses.replace(
            params,
            remap_base=torch.stack([params.remap_base] + [
                torch.as_tensor(b, device=dev).to(torch.int32) for b, _ in maps]),
            remap_weights=torch.stack([params.remap_weights] + [
                torch.as_tensor(w, device=dev).to(torch.float32) for _, w in maps]),
        )
    fn = make_isp_fn(config0, encoding, with_state, False, temporal_mode=temporal_mode,
                     remap_src_hw=src_hw, n_cameras=n)
    if not with_state:
        inner = fn
        fn = lambda p, px, state=None: (inner(p, px, None)[0], state)  # noqa: E731
    return BuiltPipeline(base_config, params, fn)
