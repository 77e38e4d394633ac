"""Share of an exact pass the device is idle while the host is inside the
program's ``tsg.exact.*`` spans, on the traced clock: the profiled
stretch's idle gaps whose middle lies in such a span, less those under the
profiler's own buffer request, over the stretch's passes' device time
(their ``tsg.exact.pass`` events). Traced alike on both sides of a
comparison, it holds the profiler's cost at each launch."""

from benchmark import spans


def read(run):
    got = spans.idle_in_program_s(run)
    if got is None:
        return None
    idle_s, pass_s = got
    return idle_s / pass_s * 100.0
