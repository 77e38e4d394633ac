"""Median host time of one ``train_step`` call in the measured window: the
benchmark's own span around the call, no sync (host clock)."""

import statistics


def read(run):
    if run.work_unit != "edges" or not run.host_s:
        return None
    return statistics.median(run.host_s) * 1e3
