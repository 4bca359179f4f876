"""Execution over several cameras (the port has no device mesh yet: one
card runs every camera)."""

from raw_image_pipeline_tpu_torch.parallel.multicamera import (
    build_multicamera_pipeline,
    multicamera_state,
)

__all__ = ["build_multicamera_pipeline", "multicamera_state"]
