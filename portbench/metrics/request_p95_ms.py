"""request_p95_ms: the 95th percentile (linear between order statistics)
of the latency of every request completed in the window, from its
submission to its poses on the host (host clock)."""

import numpy as np


def read(run):
    if run.kind != "serve" or not run.latencies_s:
        return None
    return float(np.percentile(run.latencies_s, 95)) * 1e3
