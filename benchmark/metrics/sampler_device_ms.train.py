"""Device milliseconds per step of the sampler's kernels: the fused hops,
the column picks, the CSR trees, and the uniforms they draw (profiler
trace, device side)."""

import re

PATTERN = re.compile(r"sample_hop_kernel|select_hop_kernel|select_columns_kernel|"
                     r"sample_hop_csr_kernel|sample_tree_csr_kernel|uniform_and_transform")


def read(run):
    if run.work_unit != "edges" or run.trace is None:
        return None
    s = run.trace.device_seconds(PATTERN)
    return s / run.trace.steps * 1e3 if s > 0 else None
