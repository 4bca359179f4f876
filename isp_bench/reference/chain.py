"""The plain reference chain: the reference pipeline's stage order
(raw_image_pipeline.hpp:143-172) on one configuration file's settings,
debayer -> flip -> white balance -> colour calibration -> gamma ->
vignetting -> HSV enhancer -> undistortion, in plain PyTorch on the
stages of `ops` and the tables of `tables`.

The CCC white balance is split in two so that a long stream is cheap to
follow: `measure` gives each frame's response peak, `track` walks the
peaks through the Kalman filter in scalar arithmetic (one rounding an
operation, as f32 or, for the control, bf16), and `process` runs the
chain on frames with the gains the track gave them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from isp_bench.reference import ops
from isp_bench.reference import tables as T

CCC_MODEL_DEFAULT_UV0 = -1.421875


def round_f32(x: float) -> float:
    return float(np.float32(x))


def round_bf16(x: float) -> float:
    """x rounded to bfloat16 (through f32), half to even."""
    u = int(np.array(x, np.float32).view(np.uint32))
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return float(np.array(u & 0xFFFFFFFF, np.uint32).view(np.float32))


@dataclass
class Track:
    """The Kalman illuminant track (cv::KalmanFilter(2, 2) with F = H = Q =
    I, R = 10 I; the covariance stays p I)."""

    x: Tuple[float, float] = (128.0, 128.0)
    p: float = 0.0
    initialized: bool = False


def track(state: Track, peaks: Sequence[Tuple[int, int]], ft=torch.float32):
    """Advance the track through the peaks in order: (new state, the
    filtered peak of each frame, truncated to integers)."""
    rnd = round_f32 if ft == torch.float32 else round_bf16
    (x0, x1), p, init = state.x, state.p, state.initialized
    out: List[Tuple[int, int]] = []
    for zx, zy in peaks:
        zx, zy = float(zx), float(zy)
        if init:
            pp = rnd(p + 1.0)
            k = rnd(pp / rnd(pp + 10.0))
            x0 = rnd(x0 + rnd(k * rnd(zx - x0)))
            x1 = rnd(x1 + rnd(k * rnd(zy - x1)))
            p = rnd(rnd(1.0 - k) * pp)
        else:
            x0, x1, init = zx, zy, True
        out.append((math.trunc(x0), math.trunc(x1)))
    return Track((x0, x1), p, init), out


class ReferenceChain:
    """The chain of one configuration file (`cfg`, the parsed JSON) for
    frames of frame_hw, on `device`, its floating-point steps in `ft`."""

    def __init__(self, cfg: dict, ccc_model_path: str, device, ft=torch.float32):
        self.cfg, self.device, self.ft = cfg, torch.device(device), ft
        p = cfg["pipeline"]
        self.encoding = cfg["encoding"]
        self.h, self.w = cfg["frame_hw"]
        self.angle = p["flip"]["angle"] if p["flip"]["enabled"] else 0
        fh, fw = (self.w, self.h) if self.angle in (90, 270) else (self.h, self.w)
        wb = p["white_balance"]
        self.ccc = wb["enabled"] and wb["method"] == "ccc"
        if wb["enabled"] and not self.ccc:
            raise ValueError(f"the reference has no white balance [{wb['method']}]")
        self.kalman = self.ccc and wb["temporal_consistency"] and cfg["with_state"]
        if self.kalman and cfg["temporal_mode"] != "sequence":
            raise ValueError("the reference follows one track through the stream")
        if self.ccc:
            self.bright = round_f32(255.0 * wb["saturation_bright_thr"])
            self.dark = round_f32(255.0 * wb["saturation_dark_thr"])
            self.uv0 = round_f32(wb.get("ccc_uv0", CCC_MODEL_DEFAULT_UV0))
            self.model = T.load_ccc_model(ccc_model_path)
            self.exp_tab = ops.on(T.exp_table(self.uv0), self.device)
        gc = p["gamma_correction"]
        if gc["enabled"] and gc.get("gpu", False) and gc["method"] == "default":
            raise ValueError("the reference has no BT.709 gamma")
        self.gamma = T.gamma_lut(gc["k"]) if gc["enabled"] else None
        vig = p["vignetting_correction"]
        self.mask = (T.vignetting_mask(fh, fw, vig["scale"], vig["a2"], vig["a4"])
                     if vig["enabled"] else None)
        ce = p["color_enhancer"]
        self.gain_tabs = (T.gain_tables([ce["hue_gain"], ce["saturation_gain"],
                                         ce["value_gain"]]) if ce["enabled"] else None)
        cc = p["color_calibration"]
        self.calib = (np.asarray(cc["matrix"], np.float32).reshape(3, 3),
                      np.asarray(cc["bias"], np.float32)) if cc["enabled"] else None
        und, cal = p["undistortion"], p["calibration"]
        self.undistort = (und["enabled"] and cal["calibration_available"]
                          and cal["distortion_model"] != "none")
        if self.undistort:
            if und.get("interpolation", "lerp") != "lerp":
                raise ValueError("the reference remaps with the lerp arithmetic only")
            K = np.asarray(cal["camera_matrix"], np.float64).reshape(3, 3)
            D = np.asarray(cal["distortion_coefficients"], np.float64)
            R = np.asarray(cal["rectification_matrix"], np.float64).reshape(3, 3)
            size = (cal["image_width"], cal["image_height"])
            new_size = tuple(und["new_image_size"] or size)
            newK = T.new_camera_matrix(K, D, size, R, und["balance"], new_size,
                                       und["fov_scale"])
            mx, my = T.undistort_maps(K, D, R, newK, size)
            flat, weights = T.lerp_taps(mx, my, (fh, fw))
            self.remap = (ops.on(flat, self.device), ops.on(weights, self.device))
            self.out_hw = (cal["image_height"], cal["image_width"])

    def planes(self, mosaic: torch.Tensor):
        """Debayer and flip: three [B, H, W] u8 planes."""
        return ops.flip(ops.debayer(mosaic, self.encoding), self.angle)

    def measure(self, planes) -> torch.Tensor:
        """Each frame's CCC response peak [B, 2] (x, y)."""
        small = [ops.resize(p, T.SMALL_H, T.SMALL_W) for p in planes]
        hist = ops.histogram(*small, self.bright, self.dark, self.uv0, self.ft)
        return ops.peak(ops.response(hist, *self.model, self.ft))

    def gains(self, peaks: torch.Tensor) -> torch.Tensor:
        return ops.gains_from_uv(peaks, self.exp_tab)

    def process(self, mosaic: torch.Tensor, peaks=None) -> Dict[str, torch.Tensor]:
        """The chain on [B, H, W] u8 frames: {"debayered", "dist_color",
        "processed"}, [B, h, w, 3] u8 each. peaks [B, 2]: the (filtered)
        CCC peaks of these frames; None measures them."""
        ft = self.ft
        planes = self.planes(mosaic)
        out = {"debayered": torch.stack(planes, dim=-1)}
        if self.ccc:
            if peaks is None:
                peaks = self.measure(planes)
            planes = ops.apply_gains(planes, self.gains(peaks.to(self.device)), ft)
        if self.calib is not None:
            planes = ops.color_correct(planes, *self.calib, ft)
        if self.gamma is not None:
            planes = ops.lut(planes, self.gamma)
        if self.mask is not None:
            planes = ops.vignetting(planes, self.mask, ft)
        if self.gain_tabs is not None:
            planes = ops.enhance(planes, self.gain_tabs, ft)
        out["dist_color"] = torch.stack(planes, dim=-1)
        out["processed"] = (ops.remap_lerp(planes, *self.remap, self.out_hw, ft)
                            if self.undistort else out["dist_color"])
        return out
