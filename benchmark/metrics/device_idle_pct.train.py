"""Share of a training step the device is idle: one less the union of the
device's operations per profiled step over the untraced window's step time
(the profiler slows a host-bound step, so its own wall time is not used)."""


def read(run):
    if run.work_unit != "edges" or run.trace is None:
        return None
    busy = run.trace.busy_s() / run.trace.steps
    if busy <= 0:
        return None
    return (1.0 - busy / run.step_mean_s) * 100.0
