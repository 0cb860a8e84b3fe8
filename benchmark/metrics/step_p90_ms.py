"""step_p90_ms: the 90th percentile of the window's step times, each from
its start to its spectra on the host (numpy's linear interpolation)."""

import numpy as np


def read(run):
    if not run.step_seconds:
        return None
    return float(np.percentile(run.step_seconds, 90)) * 1e3
