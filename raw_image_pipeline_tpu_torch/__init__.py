"""raw_image_pipeline_tpu_torch — the ISP engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of the JAX package raw_image_pipeline_tpu, which stays the reference:
the same module names, the same numbers on the same inputs. It imports torch
and numpy, never jax.

Public API:
    RawImagePipeline — the reference's Python API, method for method;
        `device=` places the tensors, `use_gpu` keeps the reference's meaning.
    build_pipeline — (pixels, state) -> (outputs, state) on a device.
    save_state / load_state — the Kalman track to and from an .npz, in the
        reference package's format.
    flagship_config — the flagship 8-stage chain's configuration.
"""

from raw_image_pipeline_tpu_torch.config import (
    CameraCalibration,
    PipelineConfig,
    flagship_config,
    load_camera_calibration,
    load_color_calibration,
    load_pipeline_params,
)
from raw_image_pipeline_tpu_torch.pipeline import (
    IspState,
    build_pipeline,
    init_state,
    load_state,
    make_isp_fn,
    make_params,
    params_from_numpy,
    save_state,
    state_from_numpy,
)
from raw_image_pipeline_tpu_torch.api import RawImagePipeline

__all__ = [
    "RawImagePipeline",
    "PipelineConfig",
    "CameraCalibration",
    "flagship_config",
    "load_pipeline_params",
    "load_camera_calibration",
    "load_color_calibration",
    "build_pipeline",
    "make_isp_fn",
    "make_params",
    "init_state",
    "save_state",
    "load_state",
    "params_from_numpy",
    "state_from_numpy",
    "IspState",
]
