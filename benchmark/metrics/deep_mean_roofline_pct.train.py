"""The deepest tree level's gather and neighbour mean against its roofline:
its least bytes (counts.py: each distinct row read once, the ids, the means
written once in the table's dtype) at the card's HBM rate, over the device
time per step of the kernels that do it (profiler trace)."""

import re

PATTERN = re.compile(r"gather_fanout_mean_kernel")


def read(run):
    if run.work_unit != "edges" or run.trace is None or run.peak is None:
        return None
    s = run.trace.device_seconds(PATTERN) / run.trace.steps
    if s <= 0:
        return None
    return run.least["deep_mean_bytes"] / run.peak["hbm_bytes_per_s"] / s * 100.0
