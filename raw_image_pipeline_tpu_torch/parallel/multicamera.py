"""Multi-camera execution on one card (BASELINE config 5: 4 cameras), the
PyTorch port of raw_image_pipeline_tpu/parallel/multicamera.py.

The form is camera-blocked, as in the reference package: frames [C, B, H,
W] flatten camera-major into one batch of C*B, so that every stage whose
parameters the cameras share (debayer, flip, CCC statistics, colour
calibration, gamma∘Lab, vignetting, HSV) runs once over all cameras, and
each of kernels A, B and C launches once per call. Only the undistortion
remap takes parameters per camera: with distinct calibrations the maps are
stacked [C, N] / [C, k, N] and each camera's block of frames goes through
its own map (kernel E or F in one launch, with grid z over the cameras); with
equal calibrations one flat map serves the whole batch. Each camera keeps
its own Kalman illuminant track.

Cameras share the static configuration (stage enables, white-balance
method, frame size); their calibrations' values differ freely.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from raw_image_pipeline_tpu_torch.config import CameraCalibration, PipelineConfig
from raw_image_pipeline_tpu_torch.models.ccc_model import load_ccc_model
from raw_image_pipeline_tpu_torch.ops import ccc as ccc_ops
from raw_image_pipeline_tpu_torch.ops.common import resolve_device
from raw_image_pipeline_tpu_torch.parallel.mesh import split_frames
from raw_image_pipeline_tpu_torch.parallel.spatial import (
    MeshFn,
    check_mesh_rows,
    shard_params,
)
from raw_image_pipeline_tpu_torch.pipeline import (
    BuiltPipeline,
    IspState,
    _host_fields,
    _post_flip_shape,
    _runs_undistortion,
    impls_for_devices,
    make_isp_chain,
    make_isp_fn,
    params_from_numpy,
    remap_fields,
)


def multicamera_state(n_cameras: int, batch: int = 1, temporal_mode: str = "cameras", *,
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
    *,
    device="cuda",
) -> BuiltPipeline:
    """One camera-blocked chain over frames [n_cameras, B, H, W] on
    `device` ("cuda", the default, launches the hand-written kernels;
    "cpu" runs the plain versions): outputs, state = pipe(frames, state),
    every output [n_cameras, B, ...]. Its params carry stacked per-camera
    remap maps where the calibrations differ.

    mesh (parallel.mesh.make_mesh): the cameras split over "data" (as
    tensor_split splits them), each data shard running the camera-blocked
    chain of its cameras with their stacked maps (a flat map where its
    cameras' calibrations are equal) and their Kalman tracks, and each
    frame's rows over "space" (parallel/spatial.py); `device` is then not
    used. Frames may be a ShardedBatch (shard_batch(..., row_axis=2)) or
    the global [C, B, H, W] batch; outputs come back as ShardedBatch,
    the state (split over the cameras in both temporal modes) whole. Equal
    to the unsharded chain byte for byte."""
    n = len(calibrations)
    if n == 0:
        raise ValueError("need at least one camera calibration")
    if frame_hw is None:
        frame_hw = (calibrations[0].image_height, calibrations[0].image_width)
    for c in calibrations:
        # calibrations may differ in values but must share the frame size
        if (c.image_height, c.image_width) != tuple(frame_hw):
            raise ValueError("all cameras must share one frame size")
    config0 = base_config.replace(calibration=calibrations[0])
    src_hw = _post_flip_shape(*frame_hw,
                              base_config.flip.angle if base_config.flip.enabled else 0)
    # the model is read once and shared by every camera's parameters
    wb = base_config.white_balance
    ccc_model = load_ccc_model(wb.ccc_model_path) if wb.enabled and wb.method == "ccc" else None
    if mesh is not None:
        return _mesh_multicamera(base_config, calibrations, encoding, frame_hw, with_state,
                                 temporal_mode, mesh, src_hw, ccc_model)
    dev = resolve_device(device)
    fields = _camera_fields(base_config, calibrations, frame_hw, src_hw, ccc_model)
    params = params_from_numpy(fields, config0, dev)
    fn = make_isp_fn(config0, encoding, with_state, False, temporal_mode=temporal_mode,
                     remap_src_hw=src_hw, n_cameras=n)
    if not with_state:
        inner = fn
        fn = lambda p, px, state=None: (inner(p, px, None)[0], state)  # noqa: E731
    return BuiltPipeline(base_config, params, fn, ccc_model=ccc_model)


def _camera_fields(base_config: PipelineConfig, calibrations, frame_hw, src_hw, ccc_model):
    """The host fields of a camera-blocked chain over `calibrations`: the
    first camera's, with the remap maps stacked [C, N] / [C, k, N] where
    the calibrations differ (one flat map where they are all equal)."""
    config0 = base_config.replace(calibration=calibrations[0])
    fields = _host_fields(config0, frame_hw, ccc_model)
    # the cameras' configs differ only in their calibration, from which
    # only the remap's maps derive; sharing is decided on the host
    # dataclasses, so that equal calibrations give one flat map
    maps_shared = all(c == calibrations[0] for c in calibrations[1:])
    if not maps_shared and _runs_undistortion(config0):
        maps = [(fields["remap_base"], fields["remap_weights"])] + [
            remap_fields(base_config.replace(calibration=c), src_hw) for c in calibrations[1:]]
        fields["remap_base"] = np.stack([b for b, _ in maps])
        fields["remap_weights"] = np.stack([w for _, w in maps])
    return fields


def _mesh_multicamera(base_config, calibrations, encoding, frame_hw, with_state,
                      temporal_mode, mesh, src_hw, ccc_model) -> BuiltPipeline:
    """The cameras over the mesh's data axis (see build_multicamera_pipeline)."""
    if mesh.process_count != 1:
        raise ValueError("a multicamera mesh spans one process")
    n = len(calibrations)
    config0 = base_config.replace(calibration=calibrations[0])
    check_mesh_rows(config0, frame_hw, src_hw, mesh)
    ranges = split_frames(n, mesh.local_data)
    row_fields = {d: _camera_fields(base_config, calibrations[a:b] or calibrations[:1],
                                    frame_hw, src_hw, ccc_model)
                  for d, (a, b) in enumerate(ranges)}
    per_shard = shard_params(config0, row_fields[0], mesh, src_hw, rows=row_fields)
    chains = {}

    def chain(params, pixels, state, part):
        # each data shard's chain for its own number of cameras
        c = pixels.shape[0]
        if c not in chains:
            chains[c] = make_isp_chain(config0, encoding, with_state, False,
                                       temporal_mode=temporal_mode, remap_src_hw=src_hw,
                                       n_cameras=c, camera_blocked=True)
        outputs, new_state, heights = yield from chains[c](params, pixels, state, part)
        return outputs, (new_state if with_state else None), heights

    fn = MeshFn(chain, mesh, per_shard, state_sharded=True, gathers=False, row_axis=2)
    if not with_state:
        inner = fn
        fn = lambda px, state=None: (inner(px, None)[0], state)  # noqa: E731
    return BuiltPipeline(base_config, params_from_numpy(row_fields[0], config0,
                                                        mesh.devices[0, 0]),
                         fn, mesh=mesh, shard_params=per_shard,
                         selected_impls=impls_for_devices(mesh.local_devices()),
                         ccc_model=ccc_model)
