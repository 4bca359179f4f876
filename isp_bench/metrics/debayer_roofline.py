"""debayer_roofline: the debayer and the flip (the range isp_debayer) as a
share of the HBM roofline, in %. The bytes any implementation must move:
the u8 mosaic read once and the three u8 planes written once, 4 bytes a
pixel."""

from isp_bench.peaks import frame_dims, roofline_share


def read(r):
    busy = r.trace.stage_busy_s.get("isp_debayer") if r.trace else None
    if not busy:
        return None
    (h, w), _, _ = frame_dims(r.config)
    return roofline_share(4 * h * w, r.traced_frames, busy)
