"""The whole training step against the peak of the cards that share it: the
step's least time (the larger of its FLOPs at the products' dtype peak and
its least bytes at HBM's, counts.py) on ``run.chips`` cards over the
untraced window's step time."""

from benchmark import counts


def read(run):
    if run.work_unit != "edges" or run.peak is None:
        return None
    return counts.least_seconds(run.least, run.peak, run.dtype) / run.chips / run.step_mean_s \
        * 100.0
