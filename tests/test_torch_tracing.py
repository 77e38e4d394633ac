"""tpu_sage_torch.tracing on the CPU: spans and counters record only under
``torch.profiler``, nest pass → layer → gather/reduce/combine and step →
sample/forward/backward/optimizer, one gather, reduce and combine a chunk,
and leave every value bitwise as it is without them."""

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_sage_torch import tracing
from tpu_sage_torch.data.problem import NodeProblem
from tpu_sage_torch.data.synthetic import sbm_store
from tpu_sage_torch.dist import mesh
from tpu_sage_torch.dist.partition import shard_graph
from tpu_sage_torch.nn import full_graph
from tpu_sage_torch.train.trainer import TrainConfig, Trainer, build_model

N, CHUNK, MAX_DEG, FEAT, HIDDEN, DIMS = 150, 64, 16, 8, 20, (16, 12)
EXACT_SPANS = ("tsg.exact.pass", "tsg.exact.prep", "tsg.exact.layer", "tsg.exact.gather",
               "tsg.exact.reduce", "tsg.exact.combine")
TRAIN_SPANS = ("tsg.train.step", "tsg.train.sample", "tsg.train.forward", "tsg.train.backward",
               "tsg.train.optimizer")
POOLS = ("max_pool", "mean_pool")


@pytest.fixture(autouse=True)
def fresh_records():
    tracing.reset()
    yield
    tracing.reset()


def _store():
    st = sbm_store(n_nodes=N, n_classes=3, feat_dim=FEAT, avg_degree=5, max_degree=MAX_DEG,
                   seed=17)
    st.degrees[7] = 0
    st.adj[7] = 7
    return st


def _model(aggregator, combine="concat"):
    cfg = TrainConfig(aggregator_class=aggregator, n_train_samples=(4, 3),
                      n_val_samples=(4, 3), output_dims=DIMS, combine=combine,
                      agg_hidden_dim=HIDDEN)
    model = build_model(cfg, N, 3, FEAT)
    model.reset_parameters(torch.Generator().manual_seed(3))
    return model


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _children(recs, parent):
    return [recs[i] for i in range(len(recs)) if recs[i].parent == parent]


def _check_exact_records(recs, aggregator, n=N, chunk=CHUNK):
    chunks = math.ceil(n / chunk)
    assert [r.name for r in recs if r.parent is None] == ["tsg.exact.pass"]
    assert recs[0].name == "tsg.exact.pass" and recs[0].root == 0
    assert all(r.root == 0 and r.host_end_ns >= r.host_start_ns > 0 for r in recs)
    assert not any(r.counters for r in recs)
    assert all(r.events is None for r in recs)  # CPU tensors: no device events
    top = _children(recs, 0)
    assert [r.name for r in top] == ["tsg.exact.prep"] + ["tsg.exact.layer"] * len(DIMS)
    assert not _children(recs, recs.index(top[0]))
    for rec in top[1:]:
        kids = _children(recs, recs.index(rec))
        table = ["tsg.exact.table"] if aggregator in POOLS else []
        assert [r.name for r in kids] == table + ["tsg.exact.gather", "tsg.exact.reduce",
                                                  "tsg.exact.combine"] * chunks
        for r in kids:
            assert not _children(recs, recs.index(r))  # the leaves


def test_span_is_the_shared_no_op_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled and not tracing.enabled()
    assert tracing.span("tsg.x") is tracing.NO_SPAN
    assert tracing.span("tsg.y", torch.device("cpu")) is tracing.NO_SPAN
    with tracing.span("tsg.x") as rec:
        assert rec is None
        assert tracing.count(edges=3) is None
    assert tracing.records() == [] and tracing.summary() == {}


@pytest.mark.parametrize("aggregator", ["mean", "max_pool"])
def test_no_profiler_no_record_and_no_cuda_call(monkeypatch, aggregator):
    """Without a profiler the exact pass and the train step record nothing,
    count nothing and never reach the profiler's annotations or the CUDA
    runtime."""
    def refuse(*a, **k):
        raise AssertionError("called without a profiler")

    for name in ("Event", "current_stream", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(tracing, "_ANNOTATION", refuse)
    monkeypatch.setattr(tracing, "_Span", refuse)
    monkeypatch.setattr(tracing, "count", refuse)
    full_graph.embed_all_nodes(_model(aggregator), _store().to_device(train=False,
                                                                      device="cpu"), chunk=CHUNK)
    trainer, state, graph, ids, tgt = _trainer(aggregator)
    trainer.train_step(state, graph, ids, tgt)
    assert tracing.records() == []


@pytest.mark.parametrize("aggregator", ["mean", "gcn", "max_pool", "mean_pool", "attention"])
def test_exact_pass_spans_nest_and_count(aggregator):
    model = _model(aggregator)
    graph = _store().to_device(train=False, device="cpu")
    _, prof = _profiled(lambda: full_graph.embed_all_nodes(model, graph, chunk=CHUNK))
    recs = tracing.records()
    _check_exact_records(recs, aggregator)
    names = {e.name for e in prof.events()}
    wanted = set(EXACT_SPANS) | ({"tsg.exact.table"} if aggregator in POOLS else set())
    assert wanted <= names
    assert {r.name for r in recs} == wanted


@pytest.mark.parametrize("chunk", [CHUNK, 50, N, 1000])
@pytest.mark.parametrize("combine", ["concat", "add"])
def test_chunk_counts_follow_the_chunk(chunk, combine):
    model = _model("mean", combine)
    graph = _store().to_device(train=False, device="cpu")
    _profiled(lambda: full_graph.embed_all_nodes(model, graph, chunk=chunk))
    _check_exact_records(tracing.records(), "mean", chunk=chunk)
    s = tracing.summary()
    for name in ("tsg.exact.gather", "tsg.exact.reduce", "tsg.exact.combine"):
        assert s[name]["count"] == len(DIMS) * math.ceil(N / chunk)
    assert s["tsg.exact.layer"]["count"] == len(DIMS)


@pytest.mark.parametrize("aggregator", ["mean", "max_pool"])
def test_partitioned_pass_records_the_same_spans(aggregator):
    """At world 1 (a gloo group of one rank in this process) the
    node-sharded pass walks the same chunks through the halo exchange."""
    model = _model(aggregator)

    def run():
        graph, m = shard_graph(_store(), train=False, device="cpu")
        out = _profiled(lambda: full_graph.embed_all_nodes_partitioned(model, graph,
                                                                       chunk=CHUNK))[0]
        return out, m

    out, m = mesh.run_in_process(run, "cpu")
    _check_exact_records(tracing.records(), aggregator, n=m)
    single = full_graph.embed_all_nodes(model, _store().to_device(train=False, device="cpu"),
                                        chunk=CHUNK)
    assert torch.equal(out[:N], single)


@pytest.mark.parametrize("aggregator", ["mean", "max_pool", "attention"])
@pytest.mark.parametrize("with_head", [False, True], ids=["embeddings", "logits"])
def test_embeddings_bitwise_with_and_without_spans(aggregator, with_head):
    model = _model(aggregator)
    graph = _store().to_device(train=False, device="cpu")
    plain = full_graph.embed_all_nodes(model, graph, chunk=CHUNK, with_head=with_head)
    traced, _ = _profiled(lambda: full_graph.embed_all_nodes(model, graph, chunk=CHUNK,
                                                             with_head=with_head))
    assert tracing.records() and torch.equal(plain, traced)


def _trainer(aggregator="mean"):
    problem = NodeProblem(_store())
    cfg = TrainConfig(aggregator_class=aggregator, batch_size=16, n_train_samples=(4, 3),
                      n_val_samples=(4, 3), output_dims=DIMS, agg_hidden_dim=HIDDEN)
    model = build_model(cfg, problem.n_nodes, problem.n_classes, problem.feats_dim)
    trainer = Trainer(model, cfg, 4, task=problem.task)
    graph = problem.device_graph(train=True, device="cpu")
    state = trainer.init_state(graph)
    ids = torch.as_tensor(problem.folds["train"][:16], dtype=torch.int32)
    return trainer, state, graph, ids, graph.targets[ids.long()]


@pytest.mark.parametrize("aggregator", ["mean", "max_pool", "lstm"])
def test_train_step_spans_nest_and_leave_values_bitwise(aggregator):
    runs = []
    for traced in (False, True):
        trainer, state, graph, ids, tgt = _trainer(aggregator)
        step = lambda: trainer.train_step(state, graph, ids, tgt)  # noqa: E731
        state, m = _profiled(step)[0] if traced else step()
        runs.append((m["loss"], [p.grad.clone() for p in state.model.parameters()],
                     [p.detach().clone() for p in state.model.parameters()]))
    (loss0, grads0, params0), (loss1, grads1, params1) = runs
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(grads0 + params0, grads1 + params1))

    recs = tracing.records()
    assert [r.name for r in recs] == list(TRAIN_SPANS)
    assert recs[0].parent is None and all(r.parent == 0 and r.root == 0 for r in recs[1:])
    assert recs[0].counters == {"edges": 16 * 4 + 16 * 4 * 3}
    assert all(not r.counters for r in recs[1:])


def test_injected_levels_skip_the_sample_span():
    trainer, state, graph, ids, tgt = _trainer()
    from tpu_sage_torch.sample.csr import graph_sample_tree

    levels = graph_sample_tree(graph, ids, (4, 3), generator=torch.Generator().manual_seed(1))
    _profiled(lambda: trainer.train_step(state, graph, ids, tgt, levels=levels))
    assert [r.name for r in tracing.records()] == [n for n in TRAIN_SPANS
                                                   if n != "tsg.train.sample"]


def test_steps_are_roots_of_their_own():
    trainer, state, graph, ids, tgt = _trainer()

    def three():
        for _ in range(3):
            trainer.train_step(state, graph, ids, tgt)

    _profiled(three)
    recs = tracing.records()
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert roots == [0, 5, 10]
    assert all(r.root == roots[i // 5] for i, r in enumerate(recs))
    s = tracing.summary()
    assert s["tsg.train.step"]["count"] == 3
    assert s["tsg.train.step"]["edges"] == 3 * (16 * 4 + 16 * 4 * 3)
    assert s["tsg.train.backward"]["device_ms"] is None
    assert tracing.summary(roots=[5])["tsg.train.step"]["count"] == 1
    tracing.reset()
    assert tracing.records() == [] and tracing.summary() == {}


class _FakeEvent:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_summary_self_time_is_less_its_children(monkeypatch):
    """Device and self device ms from hand-made event pairs: a root of 10 ms
    with children of 6 and 3 ms, one with a grandchild of 2 ms."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    spans = [("tsg.a", None, 0, 10), ("tsg.b", 0, 0, 6), ("tsg.c", 1, 1, 3),
             ("tsg.b", 0, 6, 9)]
    for name, parent, t0, t1 in spans:
        rec = tracing.Record(name, parent, 0, (_FakeEvent(t0), _FakeEvent(t1)))
        rec.host_start_ns, rec.host_end_ns = 1, 1 + 10 ** 6
        rec.counters["bytes"] = 5
        tracing.records().append(rec)
    s = tracing.summary()
    assert s["tsg.a"] == {"count": 1, "device_ms": 10, "self_device_ms": 1, "host_ms": 1.0,
                          "bytes": 5}
    assert s["tsg.b"]["device_ms"] == 9 and s["tsg.b"]["self_device_ms"] == 7
    assert s["tsg.b"]["count"] == 2 and s["tsg.b"]["bytes"] == 10
    assert s["tsg.c"]["device_ms"] == s["tsg.c"]["self_device_ms"] == 2
