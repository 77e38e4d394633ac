"""What the per-layer readers take from the program's own spans
(``tpu_sage_torch/tracing.py``), which record only while the profiled
stretch runs: the stretch's exact passes, their summary per span name
(device milliseconds from CUDA events on the pass's stream), and the
device's idle gaps that fall inside them. Bytes come from the cell's
shapes, never from the program: only the time is the span's.

A program without the tracing module, or one that recorded no exact pass,
gives None: the metric is then left out of the line."""

from __future__ import annotations

import re
from typing import Optional, Tuple

import numpy as np

PASS = "tsg.exact.pass"
EXACT = "tsg.exact."
BUFFER_REQUEST = re.compile(r"Activity[ _]Buffer[ _]Request")  # the profiler's own
BLOCK = 256  # gaps laid against the host operations at once
POOLS = ("max_pool", "mean_pool")


def exact_passes(run) -> Optional[Tuple[dict, int]]:
    """``(summary, passes)``: ``tracing.summary()`` over the last
    ``run.trace.steps`` exact passes recorded (the profiled stretch's, one a
    step), and how many there are; None for a run of another unit, without
    a trace, or without recorded passes."""
    if run.work_unit != "nodes" or run.trace is None:
        return None
    try:
        from tpu_sage_torch import tracing
    except ImportError:
        return None
    roots = [i for i, r in enumerate(tracing.records()) if r.name == PASS][-run.trace.steps:]
    if not roots:
        return None
    return tracing.summary(roots=roots), len(roots)


def span_ms(run, name: str) -> Optional[float]:
    """The span ``name``'s device ms summed over the stretch's passes, per
    pass; None where it was not recorded or has no device time."""
    got = exact_passes(run)
    if got is None:
        return None
    summary, passes = got
    value = summary.get(name, {}).get("device_ms")
    return value / passes if value else None


def reduce_least_bytes(run) -> Optional[float]:
    """Least bytes of rank 0's part of a pass's neighbour summaries, from
    the cell's shapes: each layer's gathered block (``rows * degree`` rows
    of the width it gathers: the pools' hidden width, else the layer's
    input) read once and its ``rows`` summaries of that width written once,
    in the table's dtype. ``rows`` is rank 0's share of the ``n`` nodes,
    ``ceil(n / chips)`` padded rows (``dist/partition.py::pad_to_shards``):
    all ``n`` on one card. None where the run's shapes are not the cell's
    (its least counts differ from ``counts.exact_pass`` of them)."""
    from benchmark import counts, graphgen, harness

    spec = harness.load_cell(run.cell)
    g, model = spec["config"]["graph"], spec["config"]["model"]
    value_bytes = graphgen.DTYPES[spec["traffic"]["table_dtype"]].itemsize
    pool = int(model["agg_hidden_dim"]) if model["aggregator_class"] in POOLS else 0
    if counts.exact_pass(g["n_nodes"], g["feat_dim"], model["output_dims"], g["degree"],
                         value_bytes, int(spec["traffic"]["chunk"]), pool) != run.least:
        return None
    rows = -(-g["n_nodes"] // run.chips)
    total, d_in = 0.0, g["feat_dim"]
    for d_out in model["output_dims"]:
        total += rows * (g["degree"] + 1) * (pool or d_in) * value_bytes
        d_in = 2 * d_out  # concat, as counts.exact_pass takes it
    return total


def idle_in_program_s(run) -> Optional[Tuple[float, float]]:
    """``(idle, passes)`` seconds: the device's idle gaps in the stretch
    (from the first step's start) whose middle lies inside a
    ``tsg.exact.*`` span and whose innermost host operation there is not the
    profiler's buffer request, summed; and the stretch's passes' device time
    (their ``tsg.exact.pass`` events), both on the traced clock. None
    without recorded passes or device operations."""
    got = exact_passes(run)
    if got is None or not got[0][PASS]["device_ms"]:
        return None
    trace = run.trace
    iv = trace.busy_intervals()
    names = [n for n, _, _ in trace.host_ops]
    starts = np.array([s for _, s, _ in trace.host_ops], dtype=np.float64)
    ends = np.array([e for _, _, e in trace.host_ops], dtype=np.float64)
    program = np.array([n.startswith(EXACT) for n in names], dtype=bool)
    steps = [s for n, s, _ in trace.host_ops if n == "benchmark.step"]
    if len(iv) == 0 or not program.any():
        return None
    lo = min(steps) if steps else iv[0, 0]
    gaps = np.stack([iv[:-1, 1], iv[1:, 0]], axis=1)
    gaps = gaps[(gaps[:, 1] > gaps[:, 0]) & (gaps[:, 0] >= lo)]
    if lo < iv[0, 0]:
        gaps = np.concatenate([[[lo, iv[0, 0]]], gaps])
    buffer = np.array([bool(BUFFER_REQUEST.fullmatch(n)) for n in names], dtype=bool)
    total = 0.0
    for b in range(0, len(gaps), BLOCK):
        g = gaps[b:b + BLOCK]
        mid = 0.5 * (g[:, 0] + g[:, 1])
        inside = (starts[None, :] <= mid[:, None]) & (ends[None, :] >= mid[:, None])
        in_program = (inside & program[None, :]).any(axis=1)
        innermost = np.where(inside, starts[None, :], -np.inf).argmax(axis=1)
        keep = in_program & ~buffer[innermost]
        total += float((g[keep, 1] - g[keep, 0]).sum())
    return total * 1e-6, got[0][PASS]["device_ms"] * 1e-3
