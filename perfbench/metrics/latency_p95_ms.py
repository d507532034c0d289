"""latency_p95_ms: 95th percentile over every query of the window of the
time from its due time to its results being on the host (host clock)."""

import numpy as np


def read(rec):
    lat = rec.window.latency_s
    return float(np.percentile(lat, 95) * 1e3) if len(lat) else None
