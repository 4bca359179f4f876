"""batch_ms_p95: the 95th percentile (nearest rank) of the latency of every
batch completed inside the window, from the host time the batch was
submitted to the host seeing its completion event, in ms."""

import math


def read(r):
    if not r.latencies_s:
        return None
    lat = sorted(r.latencies_s)
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
