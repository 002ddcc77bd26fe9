"""serve_p95_ms: the 95th percentile of every request's latency in the
window, call to uint8 output on the host (numpy's linear percentile)."""

import numpy as np


def read(r):
    return float(np.percentile(np.asarray(r["times_s"]), 95)) * 1e3
