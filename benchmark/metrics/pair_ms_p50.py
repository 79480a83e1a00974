"""The median latency of the pairs in the window (ms), from the host frame
to the result table on the host."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latencies_s) * 1e3, 50))
