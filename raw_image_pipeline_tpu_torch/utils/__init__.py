"""Utilities of the port's tools: logging, profiling and image files."""

from raw_image_pipeline_tpu_torch.utils.logging import get_logger
from raw_image_pipeline_tpu_torch.utils.profiling import stage_timings, trace_profile

__all__ = ["get_logger", "stage_timings", "trace_profile"]
