"""The neighbour summary of the exact pass against its roofline: its least
bytes from the cell's shapes (``spans.reduce_least_bytes``: each layer's
gathered block read once, its summaries written once) at the card's HBM
rate, over the device time per pass of the program's ``tsg.exact.reduce``
spans (CUDA events the program records in the profiled stretch)."""

from benchmark import spans


def read(run):
    if run.peak is None:
        return None
    ms = spans.span_ms(run, "tsg.exact.reduce")
    if ms is None:
        return None
    nbytes = spans.reduce_least_bytes(run)
    if nbytes is None:
        return None
    return nbytes / run.peak["hbm_bytes_per_s"] / (ms * 1e-3) * 100.0
