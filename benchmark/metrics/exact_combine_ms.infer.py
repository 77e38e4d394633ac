"""Device milliseconds per exact pass inside the program's
``tsg.exact.combine`` spans: each chunk's self and neighbour products, their
concatenation and activation (CUDA events the program records in the
profiled stretch)."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "tsg.exact.combine")
