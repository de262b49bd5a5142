"""95th percentile of the host time between successive step returns,
over the traced window's steps before the profiled stretches (host clock)."""
import numpy as np


def read(t):
    s = t["steps_s"]
    return float(np.percentile(s, 95) * 1e3) if len(s) >= 20 else None
