"""Nodes embedded by every exact pass completed in the window over the
window's wall time, which ends in a synchronize (host clock)."""


def read(run):
    if run.work_unit != "nodes":
        return None
    return run.work / run.window_s
