"""Sampled edges of every step completed in the window over the window's
wall time, which ends in a synchronize (host clock)."""


def read(run):
    if run.work_unit != "edges":
        return None
    return run.work / run.window_s
