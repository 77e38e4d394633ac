"""The exact pass's row gathers against their roofline: their least bytes
(counts.py: each chunk's distinct rows read once, every gathered row
written once, the ids read once) at the card's HBM rate, over the device
time per pass of the ``gather_rows`` kernels (profiler trace)."""

import re

PATTERN = re.compile(r"gather_rows_(words|realign)_kernel")


def read(run):
    if run.work_unit != "nodes" or run.trace is None or run.peak is None:
        return None
    s = run.trace.device_seconds(PATTERN) / run.trace.steps
    if s <= 0:
        return None
    return run.least["gather_rows_bytes"] / run.peak["hbm_bytes_per_s"] / s * 100.0
