"""Reference-compatible Python API (PyTorch port of the
raw_image_pipeline_tpu/api.py subset that processes frames).

`RawImagePipeline` mirrors the reference pybind11 surface, with numpy in and
out. Single frames ([H, W] Bayer) are processed like the reference; batched
frames ([B, H, W]) behave like a frame-by-frame loop. Built pipelines are
cached per (shape, encoding); the loaders invalidate the cache.

`use_gpu` keeps the reference's meaning: the reference's CUDA *semantics*
(the MHT demosaic with no R<->B swap, and the BT.709 table for the "default"
gamma method), not "run on the GPU". Where the tensors live is chosen with
`device=` ("cpu", or "cuda" for the hand-written kernels).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raw_image_pipeline_tpu_torch import config as cfg
from raw_image_pipeline_tpu_torch.pipeline import (
    BuiltPipeline,
    _resolve_device,
    build_pipeline,
    init_state,
)


class RawImagePipeline:
    """The frame-processing subset of py_raw_image_pipeline.RawImagePipeline."""

    def __init__(
        self,
        use_gpu: bool = False,
        params_path: str = "",
        calibration_path: str = "",
        color_calibration_path: str = "",
        device="cpu",
    ):
        self._device = _resolve_device(device)
        self._state = None
        self._cache: Dict[Tuple, BuiltPipeline] = {}
        self._last_outputs: Dict[str, torch.Tensor] = {}
        base = cfg.PipelineConfig()
        if use_gpu:
            base = base.replace(
                debayer=replace(base.debayer, algorithm="mht"),
                gamma_correction=replace(base.gamma_correction, gpu=True),
            )
        self._config = cfg.load_pipeline_params(
            params_path or cfg.DEFAULT_PARAMS_PATH, base
        )
        if calibration_path:
            self.load_camera_calibration(calibration_path)
        self.load_color_calibration(
            color_calibration_path or cfg.DEFAULT_COLOR_CALIBRATION_PATH
        )

    def _invalidate(self, **config_updates):
        if config_updates:
            self._config = self._config.replace(**config_updates)
        self._cache.clear()

    def _set_module(self, name: str, **kw) -> None:
        self._invalidate(**{name: replace(getattr(self._config, name), **kw)})

    def _with_state(self) -> bool:
        wb = self._config.white_balance
        return wb.enabled and wb.method == "ccc" and wb.temporal_consistency

    def _pipeline_for(self, shape, encoding) -> BuiltPipeline:
        key = (shape, encoding, self._with_state())
        pipe = self._cache.get(key)
        if pipe is None:
            pipe = build_pipeline(
                self._config, encoding, frame_hw=(shape[1], shape[2]),
                with_state=self._with_state(), keep_intermediates=True,
                temporal_mode="sequence", device=self._device,
            )
            self._cache[key] = pipe
        return pipe

    def _run(self, image: np.ndarray, encoding: str) -> np.ndarray:
        image = np.asarray(image)
        if image.size == 0:
            # empty-image early return like the node's callback guard
            return image
        if image.ndim not in (2, 3):
            raise NotImplementedError(f"input of shape {image.shape} (Bayer [H, W] or [B, H, W] only)")
        single = image.ndim == 2
        batch = torch.as_tensor(image[None] if single else image, device=self._device)
        pipe = self._pipeline_for(tuple(batch.shape), encoding)
        if self._with_state():
            # one sequential illuminant track, like the reference's single
            # camera stream, advanced through the batch in order
            if self._state is None:
                self._state = init_state((), device=self._device)
            outputs, self._state = pipe(batch, self._state)
        else:
            outputs, _ = pipe(batch, None)
        self._last_outputs = {k: (v[0] if single else v) for k, v in outputs.items()}
        return self._last_outputs["processed"].cpu().numpy()

    def process(self, image: np.ndarray, encoding: str) -> np.ndarray:
        return self._run(image, encoding)

    def load_camera_calibration(self, file_path: str) -> None:
        self._invalidate(calibration=cfg.load_camera_calibration(file_path))

    def load_color_calibration(self, file_path: str) -> None:
        self._invalidate(
            color_calibration=cfg.load_color_calibration(
                file_path, self._config.color_calibration
            )
        )

    def set_gpu(self, use_gpu: bool) -> None:
        """The reference's CUDA semantics on or off: the MHT demosaic and the
        GPU backend's BT.709 "default" gamma (the device stays as chosen)."""
        self._set_module("debayer", algorithm="mht" if use_gpu else "bilinear")
        self._set_module("gamma_correction", gpu=use_gpu)

    def set_undistortion_interpolation(self, mode: str) -> None:
        """Which OpenCV-build remap arithmetic to replicate: "lerp" (x86/IPP,
        the default) | "fixed32" (ARM/Jetson) | "float" (quantization-free)."""
        if mode not in ("lerp", "fixed32", "float"):
            raise ValueError(f"unknown remap interpolation [{mode}]")
        self._set_module("undistortion", interpolation=mode)

    def reset_white_balance_temporal_consistency(self) -> None:
        self._state = None

    def _materialize(self, key) -> Optional[np.ndarray]:
        v = self._last_outputs.get(key)
        return None if v is None else v.cpu().numpy()

    def get_processed_image(self) -> Optional[np.ndarray]:
        return self._materialize("processed")

    def get_dist_debayered_image(self) -> Optional[np.ndarray]:
        return self._materialize("debayered")

    def get_dist_color_image(self) -> Optional[np.ndarray]:
        return self._materialize("dist_color")
