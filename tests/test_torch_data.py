"""tpu_sage_torch data layer against the JAX package: synthetic stores and the
padded adjacency are bit-equal, the h5 loader reads the reference's files."""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_sage.data import synthetic as jsyn
from tpu_sage.data.problem import NodeProblem as JNodeProblem
from tpu_sage.graph.graph_data import build_padded_adjacency as j_build
from tpu_sage_torch.data import synthetic as tsyn
from tpu_sage_torch.data.problem import NodeProblem, infer_degrees
from tpu_sage_torch.graph.graph_data import build_padded_adjacency


def _assert_stores_equal(a, b):
    for field in dataclasses.fields(a):
        x, y = getattr(a, field.name), getattr(b, field.name)
        if field.name == "folds":
            assert sorted(x) == sorted(y)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
                assert x[k].dtype == y[k].dtype
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, field.name
            np.testing.assert_array_equal(x, y, err_msg=field.name)
        else:
            assert x == y, field.name


def test_bench_store_bit_equal():
    a = tsyn.bench_store(n_nodes=2000, feat_dim=24, cache_dir="0")
    b = jsyn.bench_store(n_nodes=2000, feat_dim=24, cache_dir="0")
    _assert_stores_equal(a, b)


def test_bench_store_cache_roundtrip(tmp_path):
    fresh = tsyn.bench_store(n_nodes=500, feat_dim=8, n_classes=5, max_degree=16,
                             cache_dir=str(tmp_path))
    cached = tsyn.bench_store(n_nodes=500, feat_dim=8, n_classes=5, max_degree=16,
                              cache_dir=str(tmp_path))
    assert len(list(tmp_path.glob("*.npz"))) == 1
    _assert_stores_equal(fresh, cached)


@pytest.mark.parametrize("kwargs", [
    dict(n_nodes=600, n_classes=5, feat_dim=16, seed=1),
    dict(n_nodes=400, n_classes=4, feat_dim=8, max_degree=4, seed=2),
    dict(n_nodes=300, n_classes=3, feat_dim=8, task="multilabel_classification", seed=3),
    dict(n_nodes=300, n_classes=3, feat_dim=8, task="regression", seed=4),
    dict(n_nodes=300, n_classes=3, feat_dim=8, centroid_seed=9, seed=5),
])
def test_sbm_store_bit_equal(kwargs):
    _assert_stores_equal(tsyn.sbm_store(**kwargs), jsyn.sbm_store(**kwargs))


@pytest.mark.parametrize("max_degree,symmetrize", [(3, True), (8, False), (64, True)])
def test_build_padded_adjacency_bit_equal(max_degree, symmetrize):
    rng = np.random.default_rng(0)
    edges = rng.integers(0, 50, size=(400, 2))
    a_adj, a_deg = build_padded_adjacency(edges, 50, max_degree, np.random.default_rng(4),
                                          symmetrize=symmetrize)
    b_adj, b_deg = j_build(edges, 50, max_degree, np.random.default_rng(4),
                           symmetrize=symmetrize)
    np.testing.assert_array_equal(a_adj, b_adj)
    np.testing.assert_array_equal(a_deg, b_deg)
    assert a_adj.dtype == np.int32 and a_deg.dtype == np.int32


def test_build_padded_adjacency_empty_is_all_self():
    adj, deg = build_padded_adjacency(np.zeros((0, 2)), 4, 3)
    np.testing.assert_array_equal(adj, np.repeat(np.arange(4)[:, None], 3, axis=1))
    np.testing.assert_array_equal(deg, 0)


def test_from_h5_reads_reference_file(tmp_path):
    from tpu_sage.data.convert import save_problem_h5

    path = str(tmp_path / "p.h5")
    save_problem_h5(jsyn.sbm_store(n_nodes=200, n_classes=3, feat_dim=8, seed=6), path)
    ours, ref = NodeProblem.from_h5(path), JNodeProblem.from_h5(path)
    _assert_stores_equal(ours.store, ref.store)
    assert ours.task == ref.task and ours.n_classes == ref.n_classes


def test_infer_degrees_matches_reference():
    from tpu_sage.data.problem import infer_degrees as j_infer

    store = tsyn.sbm_store(n_nodes=300, n_classes=3, feat_dim=4, seed=7)
    np.testing.assert_array_equal(infer_degrees(store.adj), j_infer(store.adj))


def test_a_new_feature_storage_drops_the_cached_table():
    """The upload cache keeps only the last storage form asked for: once no
    graph holds the bf16 table, asking for the int8 one frees it; asking for
    bf16 again uploads it anew."""
    import gc
    import weakref

    problem = NodeProblem(tsyn.sbm_store(n_nodes=200, n_classes=3, feat_dim=8, seed=9))
    g = problem.device_graph(train=True, dtype=torch.bfloat16, device="cpu")
    first = weakref.ref(g.feats)
    del g
    gc.collect()
    assert first() is not None  # the cache still holds it
    q = problem.device_graph(train=True, dtype=torch.bfloat16, device="cpu", quantize=True)
    gc.collect()
    assert first() is None
    assert problem.device_graph(train=False, dtype=torch.bfloat16, device="cpu",
                                quantize=True).feats is q.feats
    again = problem.device_graph(train=True, dtype=torch.bfloat16, device="cpu")
    assert again.feats.dtype == torch.bfloat16
    np.testing.assert_array_equal(again.feats.float().numpy(),
                                  torch.from_numpy(problem.store.feats).to(torch.bfloat16)
                                  .float().numpy())


def test_iterate_matches_reference():
    store = tsyn.sbm_store(n_nodes=300, n_classes=3, feat_dim=4, seed=8)
    ours = list(NodeProblem(store).iterate("train", batch_size=50, shuffle=True, seed=3))
    ref = list(JNodeProblem(jsyn.sbm_store(n_nodes=300, n_classes=3, feat_dim=4, seed=8))
               .iterate("train", batch_size=50, shuffle=True, seed=3))
    assert len(ours) == len(ref)
    for (ai, at, ap), (bi, bt, bp) in zip(ours, ref):
        np.testing.assert_array_equal(ai, bi)
        np.testing.assert_array_equal(at, bt)
        assert ap == bp


def test_device_graph_cpu_shares_feature_table():
    problem = NodeProblem(tsyn.sbm_store(n_nodes=200, n_classes=3, feat_dim=8, seed=9))
    g_train = problem.device_graph(train=True, dtype=torch.bfloat16, device="cpu")
    g_full = problem.device_graph(train=False, dtype=torch.bfloat16, device="cpu")
    assert g_train.feats is g_full.feats
    assert g_train.adj.dtype == torch.int32 and g_train.degrees.dtype == torch.int32
    assert g_train.targets.dtype == torch.int32
    assert g_train.feats.dtype == torch.bfloat16
    np.testing.assert_array_equal(g_train.adj.numpy(), problem.store.train_adj)
    np.testing.assert_array_equal(g_full.adj.numpy(), problem.store.adj)
    assert problem.device_graph(train=True, dtype=torch.bfloat16, device="cpu") is g_train
