"""The 95th percentile of the durations of all calls of the window, each
from its start to its results in host memory (host clock), in ms."""

import numpy as np


def read(run):
    if not run.calls:
        return None
    return float(np.percentile([(b - a) * 1e3 for a, b, _ in run.calls], 95))
