"""device_idle_share: 1 - the union of kernel, copy and set intervals over
the traced window, in %."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
