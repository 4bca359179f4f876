"""stage_us_per_frame.white_balance: the device's busy time inside the
range isp_white_balance (the CCC range: resize, histogram, response,
peak, Kalman track and gains; where no pointwise stretch follows, the
gains applied too), per frame, in us. Fixed work a frame, far below any
bytes bound, so it is timed and given no roofline."""


def read(r):
    busy = r.trace.stage_busy_s.get("isp_white_balance") if r.trace else None
    if not busy:
        return None
    return 1e6 * busy / r.traced_frames
