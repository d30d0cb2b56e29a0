"""The 95th percentile of every request's latency in the window, from its
sending to its output on the device (numpy's linear interpolation)."""

import numpy as np


def read(run):
    if run.kind != 'query' or not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 95.0)) * 1e3
