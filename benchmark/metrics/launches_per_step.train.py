"""Host-side CUDA runtime and driver calls that put work on the device, per
profiled step: kernel launches, graph launches, asynchronous copies and
sets (profiler trace, CPU side)."""

import re

PATTERN = re.compile(r"(cuda|cu)(LaunchKernel(ExC|Ex)?(_v\d+)?|GraphLaunch|Memcpy\w*Async|"
                     r"Memset\w*Async|LaunchCooperativeKernel)(_v\d+)?")


def read(run):
    if run.work_unit != "edges" or run.trace is None:
        return None
    calls = run.trace.host_calls(PATTERN)
    return calls / run.trace.steps if calls else None
