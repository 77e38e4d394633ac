"""A run with its timed path broken underneath comes out not correct: the
harness's whole run at a toy size on the CPU, with the look for a card
skipped, once for each fault a cell can have. The four-rank cell runs as
gloo ranks, each pass of every rank under the fault (``toy.wrapped``), and
can also leave out the exchange between chips."""

import contextlib

import pytest
import torch

from benchmark import harness, readings
from benchmark.tests.toy import EXACT, PART, POOL, TRAIN, copy_checkout, toy_cell, wrapped

CPU = torch.device("cpu")


def run(cell):
    return harness.run_cell(toy_cell(cell), 2**31 + 5, 0.2, False, CPU)


@contextlib.contextmanager
def state_unchanged():
    """Every optimizer step returns the parameters and its state as they were."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
        yield


@contextlib.contextmanager
def altered_id():
    """One id of each sampled tree's deepest level made a non-neighbour
    where the sampler produces it."""
    from tpu_sage_torch.sample import csr
    from tpu_sage_torch.train import trainer

    real = csr.graph_sample_tree

    def altered(graph, ids, fanouts, **kw):
        levels = real(graph, ids, fanouts, **kw)
        parent = int(levels[-2][0])
        row = set(graph.adj[parent].tolist())
        levels[-1][0] = next(v for v in range(graph.adj.shape[0]) if v not in row)
        return levels

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "graph_sample_tree", altered)
        yield


@contextlib.contextmanager
def altered_answer():
    """One node's embedding changed where the exact pass produces it (of a
    partitioned pass, one of each rank's nodes)."""
    from tpu_sage_torch.nn import full_graph

    def altering(real):
        def altered(*a, **kw):
            out = real(*a, **kw).clone()
            out[7] *= -1.0
            return out
        return altered

    with pytest.MonkeyPatch.context() as mp:
        for name in ("embed_all_nodes", "embed_all_nodes_partitioned"):
            mp.setattr(full_graph, name, altering(getattr(full_graph, name)))
        yield


@contextlib.contextmanager
def half_the_neighbours():
    """Each node's mean taken over the first half of its neighbours, the
    rest left out."""
    from tpu_sage_torch.nn import full_graph

    real = full_graph._chunk_combine

    def half(model, layer_idx, neigh, d_chunk, h_self, src_self):
        keep = neigh.shape[1] // 2
        return real(model, layer_idx, neigh[:, :keep], d_chunk.clamp(max=keep), h_self, src_self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(full_graph, "_chunk_combine", half)
        yield


@contextlib.contextmanager
def no_exchange():
    """The exchange between chips left out: each rank answers a chunk's
    neighbour ids from its own shard alone, a zero row for every id it
    does not own."""
    from tpu_sage_torch.dist.mesh import rank
    from tpu_sage_torch.nn import full_graph

    def local(src, ids):
        m = src.shape[0]
        own = ids - rank() * m
        return full_graph._gather_local(src, torch.where((ids >= 0) & (own >= 0) & (own < m),
                                                         own, -1))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(full_graph, "_gather_halo", local)
        yield


@pytest.mark.parametrize("cell", [TRAIN, EXACT, POOL, PART])
def test_sound_run_is_correct(cell):
    assert run(cell)["correct"] is True


@pytest.mark.parametrize("fault", [state_unchanged, readings.half_batch, altered_id])
def test_training_faults_fail(fault):
    with fault():
        r = run(TRAIN)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("fault", [altered_answer, half_the_neighbours])
@pytest.mark.parametrize("cell", [EXACT, POOL])
def test_exact_faults_fail(cell, fault):
    with fault():
        r = run(cell)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("fault", [altered_answer, half_the_neighbours, no_exchange])
def test_faults_of_the_four_rank_cell_fail(tmp_path, fault):
    spec = wrapped(toy_cell(PART), copy_checkout(tmp_path), f"{__name__}:{fault.__name__}")
    r = harness.run_cell(spec, 2**31 + 5, 0.2, False, CPU)
    assert r["device"]["count"] == 4
    assert r["correct"] is False, r["checks"]
