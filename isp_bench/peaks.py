"""Published peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet, at
its 700 W power limit), which the roofline shares are taken against."""

HBM_BYTES_PER_S = 3.35e12  # HBM3


def frame_dims(cfg: dict):
    """((H, W) of the sensor frame, (H, W) after the flip, (H, W) of the
    undistorted output) of a configuration file."""
    h, w = cfg["frame_hw"]
    flip = cfg["pipeline"]["flip"]
    angle = flip["angle"] if flip["enabled"] else 0
    fh, fw = (w, h) if angle in (90, 270) else (h, w)
    cal = cfg["pipeline"]["calibration"]
    return (h, w), (fh, fw), (cal["image_height"], cal["image_width"])


def roofline_share(bytes_per_frame: float, frames: int, busy_s: float) -> float:
    """100 x the least time the card could move the bytes in, over the
    time it was busy: a share of the HBM roofline, in %."""
    return 100.0 * bytes_per_frame * frames / HBM_BYTES_PER_S / busy_s
