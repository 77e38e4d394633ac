"""Share of an exact pass the device is idle: one less the union of the
device's operations per profiled pass over the untraced window's pass time."""


def read(run):
    if run.work_unit != "nodes" or run.trace is None:
        return None
    busy = run.trace.busy_s() / run.trace.steps
    if busy <= 0:
        return None
    return (1.0 - busy / run.step_mean_s) * 100.0
