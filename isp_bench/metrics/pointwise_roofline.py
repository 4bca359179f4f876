"""pointwise_roofline: the pointwise stretch (the range isp_pointwise:
colour calibration, gamma, vignetting, the enhancer, with the CCC gains)
as a share of the HBM roofline, in %. The bytes any implementation must
move: three u8 planes read once and three written once, 6 bytes a
pixel. The vignetting mask counts 0 bytes: it is a function of the pixel's
position and three numbers, which an implementation may compute in place,
so no later change to how it is stored moves the count."""

from isp_bench.peaks import frame_dims, roofline_share


def read(r):
    busy = r.trace.stage_busy_s.get("isp_pointwise") if r.trace else None
    if not busy:
        return None
    _, (fh, fw), _ = frame_dims(r.config)
    return roofline_share(6 * fh * fw, r.traced_frames, busy)
