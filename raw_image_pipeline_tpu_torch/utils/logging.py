"""Structured logging (the port of raw_image_pipeline_tpu/utils/logging.py).

The reference logs with std::cout / ROS_INFO / glog (SURVEY.md §5); here a
standard library logger namespaced under "raw_image_pipeline_tpu_torch"
with a one-line structured format, its level from $RIP_TPU_LOG (INFO by
default). Library code logs through get_logger(__name__); applications
configure handlers as usual.
"""

from __future__ import annotations

import logging
import os
import sys

ROOT = "raw_image_pipeline_tpu_torch"
_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
_configured = False


def get_logger(name: str = ROOT) -> logging.Logger:
    """The logger `name` if it lies in the port's namespace, else a child of
    the port's root logger called `name`. The JAX package's names share the
    port's prefix without the "_torch": they are children here too."""
    global _configured
    root = logging.getLogger(ROOT)
    if not _configured:
        level = os.environ.get("RIP_TPU_LOG", "INFO").upper()
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(level)
        root.propagate = False
        _configured = True
    if name == ROOT or name.startswith(ROOT + "."):
        return logging.getLogger(name)
    return root.getChild(name)
