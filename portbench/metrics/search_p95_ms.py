"""95th percentile of the latency of every request due in the window,
each timed from its due time; a request that failed counts as missing
(above every latency). None where more than 5% failed."""

import math

from portbench.yardstick.timeline import percentile


def read(run):
    if not run.latencies_ms:
        return None
    p = percentile(run.latencies_ms, 95)
    return p if math.isfinite(p) else None
