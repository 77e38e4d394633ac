"""The whole exact pass against the card's peak: its least time (the larger
of its FLOPs at the table dtype's peak and its least bytes at HBM's,
counts.py) over the untraced window's pass time."""

from benchmark import counts


def read(run):
    if run.work_unit != "nodes" or run.peak is None:
        return None
    return counts.least_seconds(run.least, run.peak, run.dtype) / run.step_mean_s * 100.0
