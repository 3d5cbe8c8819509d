"""p50_ms (ms, host clock): the median latency of every request due in the
window, from its due time to its answer; one never answered counts to the
time the load stopped waiting for it."""

import numpy as np


def read(ctx):
    lat = ctx.latencies_s()
    return float(np.percentile(lat, 50) * 1e3) if len(lat) else None
