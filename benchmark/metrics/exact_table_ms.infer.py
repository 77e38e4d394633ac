"""Device milliseconds per exact pass inside the program's
``tsg.exact.table`` spans: the pools' ``relu(mlp(h))`` of every node, once a
layer (CUDA events the program records in the profiled stretch)."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "tsg.exact.table")
