"""95th percentile, over every step of the window, of the device-side gap
between the CUDA events recorded after consecutive steps (no sync a step)."""

import numpy as np


def read(run):
    if run.work_unit != "edges" or not run.step_s:
        return None
    return float(np.percentile(np.asarray(run.step_s) * 1e3, 95))
