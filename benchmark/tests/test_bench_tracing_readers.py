"""The readers of the program's spans on a hand-built run: known span
times, known idle gaps, bytes from the cell's shapes, and None wherever
there is nothing of the program's to read."""

import sys

import pytest
import torch

from benchmark import counts, harness, spans
from benchmark.trace import Trace

READERS = ("exact_gather_ms.infer", "exact_reduce_roofline.infer", "exact_combine_ms.infer",
           "exact_table_ms.infer", "idle_in_program_pct.infer")
HBM = 1e13
CELLS = {"reddit-sup.exact-embed": 232965 * 129 * (602 + 256) * 4,
         "reddit-maxpool.exact-embed": 232965 * 129 * (512 + 512) * 4}


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def _read(name, run):
    return harness.reader(harness.HERE, name)(run)


@pytest.fixture
def tracing(monkeypatch):
    from tpu_sage_torch import tracing

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    tracing.reset()
    yield tracing
    tracing.reset()


def _record(tracing, name, parent, t0, t1):
    recs = tracing.records()
    root = len(recs) if parent is None else recs[parent].root
    rec = tracing.Record(name, parent, root, (_Event(t0), _Event(t1)))
    rec.host_start_ns, rec.host_end_ns = 1, 2
    recs.append(rec)
    return len(recs) - 1


def _passes(tracing, n, t=0.0):
    """``n`` passes of 100 ms: table 3, gather 10 + 10, reduce 20 + 20,
    combine 5 + 5, as two chunks of one layer."""
    for _ in range(n):
        p = _record(tracing, "tsg.exact.pass", None, t, t + 100)
        layer = _record(tracing, "tsg.exact.layer", p, t, t + 99)
        _record(tracing, "tsg.exact.table", layer, t, t + 3)
        for c in range(2):
            b = t + 3 + 35 * c
            _record(tracing, "tsg.exact.gather", layer, b, b + 10)
            _record(tracing, "tsg.exact.reduce", layer, b + 10, b + 30)
            _record(tracing, "tsg.exact.combine", layer, b + 30, b + 35)
        t += 100


def _least(cell):
    """The least counts the cell's own session reports."""
    spec = harness.load_cell(cell)
    g, model = spec["config"]["graph"], spec["config"]["model"]
    pool = model["agg_hidden_dim"] if model["aggregator_class"] == "max_pool" else 0
    return counts.exact_pass(g["n_nodes"], g["feat_dim"], tuple(model["output_dims"]),
                             g["degree"], 4, spec["traffic"]["chunk"], pool)


def _run(work_unit="nodes", trace=True, cell="reddit-sup.exact-embed"):
    # device busy 0-10, 20-30, 50-60, 100-110 us; the host in a pass over 0-75
    # and, inside it, in an aten op at 12-18 and the buffer request at 38-42
    device = [("k", 0.0, 10.0), ("k", 20.0, 30.0), ("k", 50.0, 60.0), ("k", 100.0, 110.0)]
    host = [("benchmark.step", 0.0, 120.0), ("tsg.exact.pass", 0.0, 75.0),
            ("tsg.exact.layer", 1.0, 74.0), ("aten::where", 12.0, 18.0),
            ("Activity Buffer Request", 38.0, 42.0)]
    return harness.Run(cell=cell, work_unit=work_unit, setup_s=1.0, window_s=0.4, steps=2,
                       work=16.0, step_s=[], host_s=[], least=_least(cell), dtype="float32",
                       peak={"hbm_bytes_per_s": HBM},
                       trace=Trace(steps=2, window_s=0.2, device_ops=device, host_ops=host)
                       if trace else None)


def test_readers_on_known_spans_and_gaps(tracing):
    _passes(tracing, 1, t=-500.0)  # an earlier pass, not the stretch's
    _passes(tracing, 2)
    run = _run()
    assert _read("exact_gather_ms.infer", run) == pytest.approx(20.0)
    assert _read("exact_combine_ms.infer", run) == pytest.approx(10.0)
    assert _read("exact_table_ms.infer", run) == pytest.approx(3.0)
    # 103.1 GB a pass at 1e13 B/s: 10.31 ms of the spans' 40
    assert _read("exact_reduce_roofline.infer", run) == pytest.approx(
        CELLS[run.cell] / HBM / 40e-3 * 100)
    # gaps 10-20 (in the pass, under an aten op: counted), 30-50 (under the
    # buffer request: skipped), 60-100 (middle 80, past the pass: skipped);
    # 10 us over the 2 passes' 200 ms of device time
    assert _read("idle_in_program_pct.infer", run) == pytest.approx(10e-6 / 0.2 * 100)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_reduce_bytes_come_from_the_cells_shapes(tracing, cell):
    """A gathered block of n * 128 rows read once and n summaries written,
    in f32, each layer: the mean's 602 and 256 wide, the pool's 512."""
    run = _run(cell=cell)
    assert spans.reduce_least_bytes(run) == CELLS[cell]
    run.least = dict(run.least, flops=run.least["flops"] / 2)  # a run at other shapes
    assert spans.reduce_least_bytes(run) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_the_programs_spans(tracing, monkeypatch, name):
    _passes(tracing, 2)
    assert _read(name, _run(work_unit="edges")) is None
    assert _read(name, _run(trace=False)) is None
    # a program without the module (the parent of the commit that adds it)
    monkeypatch.setitem(sys.modules, "tpu_sage_torch.tracing", None)
    monkeypatch.delattr(sys.modules["tpu_sage_torch"], "tracing")
    assert _read(name, _run()) is None
    monkeypatch.undo()
    tracing.reset()
    assert _read(name, _run()) is None


def test_idle_reader_skips_the_buffer_request_alone(tracing):
    _passes(tracing, 2)
    run = _run()
    run.trace.host_ops = [op for op in run.trace.host_ops if op[0] != "Activity Buffer Request"]
    # now the gap 30-50 is the pass's too: 10 + 20 us
    assert _read("idle_in_program_pct.infer", run) == pytest.approx(30e-6 / 0.2 * 100)
    run.trace.host_ops = [op for op in run.trace.host_ops if not op[0].startswith("tsg.")]
    assert _read("idle_in_program_pct.infer", run) is None


def test_span_readers_leave_out_spans_without_device_time(tracing):
    _passes(tracing, 2)
    for rec in tracing.records():
        if rec.name == "tsg.exact.table":
            rec.events = None  # as a CPU run records it
    run = _run()
    assert _read("exact_table_ms.infer", run) is None
    assert _read("exact_gather_ms.infer", run) == pytest.approx(20.0)
    run.peak = None
    assert _read("exact_reduce_roofline.infer", run) is None
