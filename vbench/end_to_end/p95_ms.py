"""p95_ms (ms, host clock): the 95th percentile of the latencies of every
request due in the window (due time to answer), over all of them; one never
answered counts to the time the load stopped waiting for it, past every
limit."""

import numpy as np


def read(ctx):
    lat = ctx.latencies_s()
    return float(np.percentile(lat, 95) * 1e3) if len(lat) else None
