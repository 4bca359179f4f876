"""pack_roofline: the packs of u8 planes into [B, H, W, 3] outputs (the
range isp_pack) as a share of the HBM roofline, in %. The bytes any
implementation must move, for each output the chain packs from planes:
the three planes read once and the packed output written once, 6 bytes a
pixel at the size after the flip. The outputs are counted from the
configuration, not from the program: the kept intermediates ("debayered"
and "dist_color"), and "processed" where no remap and no pointwise call
writes it (a CCC white balance alone applies its gains in place)."""

from isp_bench.peaks import frame_dims, roofline_share


def packed_outputs(cfg: dict) -> int:
    """How many [B, H, W, 3] outputs the chain packs from planes."""
    p = cfg["pipeline"]
    cal, wb = p["calibration"], p["white_balance"]
    remap = (p["undistortion"]["enabled"] and cal["calibration_available"]
             and cal["distortion_model"] != "none")
    stretch = (wb["enabled"] and wb["method"] != "ccc") or any(
        p[k]["enabled"] for k in ("color_calibration", "gamma_correction",
                                  "vignetting_correction", "color_enhancer"))
    return 2 * bool(cfg["keep_intermediates"]) + (not remap and not stretch)


def pack_bytes(cfg: dict) -> int:
    """The bytes a frame's packs must move."""
    _, (fh, fw), _ = frame_dims(cfg)
    return 6 * fh * fw * packed_outputs(cfg)


def read(r):
    busy = r.trace.stage_busy_s.get("isp_pack") if r.trace else None
    moved = pack_bytes(r.config)
    if not busy or not moved:
        return None
    return roofline_share(moved, r.traced_frames, busy)
