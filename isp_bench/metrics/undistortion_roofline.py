"""undistortion_roofline: the fisheye remap (the range isp_undistortion)
as a share of the HBM roofline, in %. The bytes any implementation must
move: each source byte that some output pixel blends with a nonzero
weight, read once (worked out from the calibration's maps: a fisheye
rectification leaves part of the source unread), and the [H, W, 3] u8
output written once. The map itself counts 0 bytes: it is a function of
the output pixel and the calibration's few numbers, which an
implementation may compute in place, so no later change to how it is
stored moves the count."""

import numpy as np

from isp_bench.peaks import frame_dims, roofline_share
from isp_bench.reference import tables as T


def source_pixels_read(cfg: dict) -> int:
    """The source pixels with a nonzero bilinear weight in some output pixel."""
    und, cal = cfg["pipeline"]["undistortion"], cfg["pipeline"]["calibration"]
    _, (fh, fw), _ = frame_dims(cfg)
    K = np.asarray(cal["camera_matrix"], np.float64).reshape(3, 3)
    D = np.asarray(cal["distortion_coefficients"], np.float64)
    R = np.asarray(cal["rectification_matrix"], np.float64).reshape(3, 3)
    size = (cal["image_width"], cal["image_height"])
    new_k = T.new_camera_matrix(K, D, size, R, und["balance"],
                                tuple(und["new_image_size"] or size), und["fov_scale"])
    flat, w = T.lerp_taps(*T.undistort_maps(K, D, R, new_k, size), (fh, fw))
    fx, fy = w[0].astype(np.float64), w[1].astype(np.float64)
    taps = ((0, (1 - fx) * (1 - fy)), (1, fx * (1 - fy)), (fw, (1 - fx) * fy), (fw + 1, fx * fy))
    used = np.zeros(fh * fw, bool)
    for k, (off, weight) in enumerate(taps):
        hit = (w[2 + k] > 0) & (weight > 0)
        used[flat[hit] + off] = True
    return int(used.sum())


def read(r):
    busy = r.trace.stage_busy_s.get("isp_undistortion") if r.trace else None
    if not busy:
        return None
    _, _, (ho, wo) = frame_dims(r.config)
    return roofline_share(3 * source_pixels_read(r.config) + 3 * ho * wo,
                          r.traced_frames, busy)
