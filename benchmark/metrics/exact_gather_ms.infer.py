"""Device milliseconds per exact pass inside the program's
``tsg.exact.gather`` spans: each chunk's id mask and its ``gather_rows``
(CUDA events the program records in the profiled stretch)."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "tsg.exact.gather")
