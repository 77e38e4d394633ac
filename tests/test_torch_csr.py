"""tpu_sage_torch CSR adjacency against the JAX package's, on the CPU.

``torch.Generator`` and ``jax.random`` draw different numbers, so the hops
take JAX's uniforms, drawn under ``sample_tree_csr``'s key splits, and must
pick JAX's neighbors bit for bit; the port's own draws are checked by a χ²
test and against its dense sampler (one generator state, the same tree).
The builders are numpy on both sides and bitwise. The training runs at the
end use int8 features and CSR adjacency together, in both packages, with
checkpoints crossing between them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from tpu_sage.sample import csr as jcsr
from tpu_sage_torch.graph.graph_data import build_padded_adjacency
from tpu_sage_torch.kernels.sample_hop import (csr_tree, csr_tree_reference, sample_hop_csr,
                                               sample_hop_csr_reference)
from tpu_sage_torch.sample import csr
from tpu_sage_torch.sample.sampler import sample_tree


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int32)


def _graph():
    """Nodes 4 and 5 isolated (5 the tail: its row start is nnz), node 3's
    only neighbor is 0; a padded copy of the reference's toy graphs."""
    edges = np.array([[0, 1], [0, 2], [3, 0], [1, 2], [2, 3], [1, 3]])
    return build_padded_adjacency(edges, 6, max_degree=4)


def _csr(adj, deg, window):
    indptr, indices = csr.csr_from_padded(adj, deg)
    if window:
        indices = csr.pad_indices_for_window(indices, window)
    return indptr, indices


def test_csr_builders_are_bitwise_the_reference():
    from tpu_sage_torch.data.synthetic import sbm_store

    store = sbm_store(n_nodes=300, n_classes=3, feat_dim=8, avg_degree=6, seed=7)
    store.degrees[[0, 17, 299]] = 0  # isolated, the tail node included
    indptr, indices = csr.csr_from_padded(store.adj, store.degrees)
    jindptr, jindices = jcsr.csr_from_padded(store.adj, store.degrees)
    assert indptr.dtype == indices.dtype == np.int32
    np.testing.assert_array_equal(indptr, jindptr)
    np.testing.assert_array_equal(indices, jindices)
    assert indptr[-1] == store.degrees.sum() == len(indices) < store.adj.size
    for window in (1, 6, int(store.degrees.max())):
        got = csr.pad_indices_for_window(indices, window)
        np.testing.assert_array_equal(got, jcsr.pad_indices_for_window(jindices, window))
        assert len(got) % window == 0 and len(got) >= len(indices) + 2 * window
    with pytest.raises(ValueError, match="exceeds int32 offsets"):
        csr.csr_from_padded(np.zeros((2, 1), np.int32), np.array([2**30, 2**30]))


@pytest.mark.parametrize("window", [0, 4], ids=["element", "window"])
@pytest.mark.parametrize("seed", [0, 1])
def test_csr_tree_is_bitwise_the_reference_for_its_uniforms(seed, window):
    """``sample_tree_csr`` fed the uniforms JAX's ``sample_tree_csr`` draws
    (one split per hop, ``uniform(sub, (B, k))``) returns JAX's levels, on a
    graph with degree-0 nodes, the tail node among them, and both hop forms;
    the kernel's plain version and its wrapper agree."""
    adj, deg = _graph()
    indptr, indices = _csr(adj, deg, window)
    ids = np.array([0, 1, 2, 3, 4, 5, 5, 3], np.int32)
    fanouts = (5, 3)
    key = jax.random.key(seed)
    want = jcsr.sample_tree_csr(key, jnp.asarray(indptr), jnp.asarray(indices),
                                jnp.asarray(deg), jnp.asarray(ids), fanouts, window=window)
    us, k, n = [], key, ids.shape[0]
    for f in fanouts:
        k, sub = jax.random.split(k)
        us.append(torch.from_numpy(np.array(jax.random.uniform(sub, (n, f)))))
        n *= f
    ours = csr.sample_tree_csr(_t(indptr), _t(indices), _t(deg), _t(ids), fanouts,
                               window=window, us=us)
    for a, b in zip(ours, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (ours[1].view(-1, 5)[[4, 5, 6]] == torch.tensor([[4], [5], [5]])).all()
    for hop_ids, u in zip(ours[:-1], us):
        np.testing.assert_array_equal(
            sample_hop_csr(_t(indptr), _t(indices), _t(deg), hop_ids, u).numpy(),
            sample_hop_csr_reference(_t(indptr), _t(indices), _t(deg), hop_ids, u).numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_window_pair_hop_is_bitwise_the_reference_window_hop(seed):
    """The window hop composed as the reference composes it (degree gather,
    the two covering rows of the (m, window) view, the select at off + col)
    against ``uniform_neighbor_sample_csr_window`` for the same key, and
    ``gather_window_pair`` against ``gather_window_pair``."""
    from tpu_sage_torch.data.synthetic import sbm_store

    store = sbm_store(n_nodes=200, n_classes=3, feat_dim=8, avg_degree=5, seed=9 + seed)
    store.degrees[[3, 199]] = 0
    window = int(store.degrees.max())
    indptr, indices = _csr(store.adj, store.degrees, window)
    ids = np.r_[np.arange(0, 200, 3), [199, 3]].astype(np.int32)
    key = jax.random.key(seed)
    want = jcsr.uniform_neighbor_sample_csr_window(
        key, jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(store.degrees),
        jnp.asarray(ids), 6, window)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (ids.shape[0], 6))))
    got = csr.window_pair_hop(_t(indptr), _t(indices), _t(store.degrees), _t(ids), u, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fused = csr.uniform_neighbor_sample_csr_window(_t(indptr), _t(indices), _t(store.degrees),
                                                   _t(ids), 6, window, u=u)
    np.testing.assert_array_equal(fused.numpy(), np.asarray(want))
    pair, off, start = csr.gather_window_pair(_t(indptr), _t(indices), _t(ids), window)
    jpair, joff, jstart = jcsr.gather_window_pair(jnp.asarray(indptr), jnp.asarray(indices),
                                                  jnp.asarray(ids), window)
    for a, b in ((pair, jpair), (off, joff), (start, jstart)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("window", [False, True], ids=["element", "window"])
def test_csr_tree_equals_the_dense_tree_for_one_generator(window):
    """Both samplers draw ``torch.rand((B, k))`` per hop in the same order,
    so one generator state gives the same tree; through the stores' device
    graphs and ``graph_sample_tree``, as the trainer samples."""
    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.data.synthetic import sbm_store

    store = sbm_store(n_nodes=400, n_classes=3, feat_dim=8, avg_degree=7, seed=31)
    isolated = np.arange(0, 400, 13)
    store.train_degrees[isolated] = 0
    store.train_adj[isolated] = isolated[:, None]  # the padding idiom: all-self rows
    problem = NodeProblem(store)
    dense = problem.device_graph(train=True, device="cpu")
    graph = problem.device_graph(train=True, device="cpu", csr=True)
    if not window:
        graph.window = 0
    ids = torch.arange(0, 400, 3, dtype=torch.int32)
    a = csr.graph_sample_tree(dense, ids, (6, 4), generator=torch.Generator().manual_seed(5))
    b = csr.graph_sample_tree(graph, ids, (6, 4), generator=torch.Generator().manual_seed(5))
    assert [t.shape[0] for t in b] == [134, 804, 3216]
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(a[1], sample_tree(dense.adj, dense.degrees, ids, (6, 4),
                                         generator=torch.Generator().manual_seed(5))[1])


def test_csr_sampler_is_uniform_over_true_neighbors():
    """χ² over 2,000 × 4 draws of node 0 (degree 3) by the port's own
    generator; every draw a true neighbor; isolated nodes self-loop."""
    adj, deg = _graph()
    sampler = csr.CSRNeighborSampler.from_padded(adj, deg, device="cpu")
    out = sampler(torch.zeros(2000, dtype=torch.int32), 4,
                  generator=torch.Generator().manual_seed(1)).reshape(-1).numpy()
    counts = [int((out == v).sum()) for v in adj[0, :deg[0]]]
    assert sum(counts) == out.size
    assert scipy.stats.chisquare(counts).pvalue > 0.001, counts
    iso = sampler(torch.tensor([4, 5], dtype=torch.int32), 3,
                  generator=torch.Generator().manual_seed(2))
    assert torch.equal(iso, torch.tensor([[4] * 3, [5] * 3], dtype=torch.int32))


def test_csr_hop_checks_its_arguments():
    adj, deg = _graph()
    indptr, indices = _csr(adj, deg, 0)
    with pytest.raises(ValueError, match="indptr has"):
        sample_hop_csr(_t(indptr[:-1]), _t(indices), _t(deg), _t([0]), torch.zeros(1, 2))
    with pytest.raises(ValueError, match="u must be"):
        sample_hop_csr(_t(indptr), _t(indices), _t(deg), _t([0, 1]), torch.zeros(1, 2))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        sample_hop_csr(*(_t(a).to("meta") for a in (indptr, indices, deg, [0])),
                       torch.zeros(1, 2, device="meta"))
    with pytest.raises(ValueError, match="window must be"):
        csr.uniform_neighbor_sample_csr_window(_t(indptr), _t(indices), _t(deg), _t([0]), 2, 0)


def test_fit_with_csr_and_exact_validation_keeps_the_eval_graph_dense():
    """Training and sampled validation sample CSR; exact validation walks
    whole rows of a dense full-graph adjacency, with the reference's note."""
    from tpu_sage_torch.data.synthetic import sbm_problem
    from tpu_sage_torch.graph.graph_data import CSRDeviceGraph, DeviceGraph
    from tpu_sage_torch.train.trainer import TrainConfig, fit

    problem = sbm_problem(n_nodes=400, n_classes=4, feat_dim=16, seed=21)
    notes = []
    cfg = TrainConfig(batch_size=64, epochs=3, n_train_samples=(5, 3), n_val_samples=(5, 3),
                      output_dims=(32, 32), exact_val=True, exact_val_every=2)
    _, _, hist = fit(problem, cfg, log=notes.append, device="cpu", csr=True)
    assert any("densifies the FULL-graph adjacency" in n.get("note", "") for n in notes)
    kinds = {(key[0], key[3]): type(g) for key, g in problem._device_graphs.items()}
    assert kinds == {(True, True): CSRDeviceGraph, (False, False): DeviceGraph}
    assert hist[-1]["train_loss"] < hist[0]["train_loss"] and hist[-1]["val_metric"] > 0.8


def test_forward_with_sampling_takes_either_storage():
    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.data.synthetic import sbm_store
    from tpu_sage_torch.nn.model import GSSupervised, default_layer_specs

    problem = NodeProblem(sbm_store(n_nodes=100, n_classes=3, feat_dim=8, seed=0))
    model = GSSupervised(default_layer_specs(fanouts=(4, 2), output_dims=(8, 8)), 3, feat_dim=8)
    model.reset_parameters(torch.Generator().manual_seed(0))
    ids = torch.arange(8, dtype=torch.int32)
    outs = [model.forward_with_sampling(problem.device_graph(train=True, device="cpu", csr=c),
                                        ids, problem.device_graph(train=True, device="cpu").feats,
                                        train=True, generator=torch.Generator().manual_seed(1))
            for c in (False, True)]
    assert torch.equal(outs[0], outs[1]) and tuple(outs[0].shape) == (8, 3)


def test_int8_and_csr_fit_in_both_packages_and_checkpoints_cross(tmp_path):
    """``feature_int8`` with CSR adjacency, bf16, trained by ``fit`` in both
    packages on the same SBM store (their samplers draw different
    neighbors): both losses fall and both validate above 0.9. Each run's
    checkpoint records ``feature_int8: true`` and resumes in the other
    package at the next epoch."""
    from tpu_sage.data.synthetic import sbm_problem as j_sbm_problem
    from tpu_sage.train import checkpoint as jck
    from tpu_sage.train import trainer as jtrainer
    from tpu_sage_torch.data.synthetic import sbm_problem
    from tpu_sage_torch.train import checkpoint as tck
    from tpu_sage_torch.train import trainer

    kw = dict(batch_size=64, n_train_samples=(5, 3), n_val_samples=(5, 3), output_dims=(32, 32),
              compute_dtype="bfloat16", feature_int8=True, epochs=2)
    store = dict(n_nodes=500, n_classes=4, feat_dim=16, seed=21)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    _, _, jhist = jtrainer.fit(j_sbm_problem(**store), jtrainer.TrainConfig(**kw),
                               log=lambda d: None, resume_from=jpath, checkpoint_every=1,
                               csr=True)
    _, _, thist = trainer.fit(sbm_problem(**store), trainer.TrainConfig(**kw),
                              log=lambda d: None, resume_from=tpath, checkpoint_every=1,
                              device="cpu", csr=True)
    for hist in (jhist, thist):
        assert [h["epoch"] for h in hist] == [0, 1]
        assert hist[-1]["train_loss"] < hist[0]["train_loss"] and hist[-1]["val_metric"] > 0.9
    assert jck.read_checkpoint_config(tpath)["feature_int8"] is True
    assert tck.read_checkpoint_config(jpath)["feature_int8"] is True
    kw["epochs"] = 3
    for fit_other, path, extra in ((trainer.fit, jpath, dict(device="cpu")),
                                   (jtrainer.fit, tpath, {})):
        notes = []
        cfg = (trainer.TrainConfig if fit_other is trainer.fit else jtrainer.TrainConfig)(**kw)
        _, _, hist = fit_other(sbm_problem(**store) if fit_other is trainer.fit
                               else j_sbm_problem(**store), cfg, log=notes.append,
                               resume_from=path, csr=True, **extra)
        assert [h["epoch"] for h in hist] == [2]
        assert any(n.get("start_epoch") == 2 for n in notes)
        assert np.isfinite(hist[0]["train_loss"]) and hist[0]["val_metric"] > 0.9


def test_csr_kernel_source_notes_what_it_replaces_and_counts_only_launches():
    from tpu_sage_torch import kernels
    from tpu_sage_torch.kernels import _build

    text = open(_build.library_path("select")[0]).read()
    assert "tpu_sage/kernels/select.py::select_columns_pallas in the CSR" in text
    assert 'extern "C" int tsg_sample_hop_csr(' in text and "Bound on the H100: bytes" in text
    adj, deg = _graph()
    indptr, indices = _csr(adj, deg, 0)
    kernels.reset_launch_counts()
    sample_hop_csr(_t(indptr), _t(indices), _t(deg), _t([0, 5]), torch.zeros(2, 3))
    assert kernels.launch_counts()["sample_hop_csr"] == 0
    assert kernels.KERNELS["sample_hop_csr"][:2] == (kernels.sample_hop, "select")


def _jax_hop_uniforms(key, n, fanouts):
    """The uniforms JAX's ``sample_tree_csr`` draws: one split a hop."""
    us, k = [], key
    for f in fanouts:
        k, sub = jax.random.split(k)
        us.append(torch.from_numpy(np.array(jax.random.uniform(sub, (n, f)))))
        n *= f
    return us


@pytest.mark.parametrize("fanouts", [(25, 10), (10,), (3, 2, 2)], ids=str)
@pytest.mark.parametrize("window", [0, 4], ids=["element", "window"])
def test_the_one_launch_tree_is_bitwise_the_reference_tree(window, fanouts):
    """``csr_tree`` (every hop in one launch on the card; on the CPU its
    plain version, ``sample_hop_csr_reference`` hop by hop) and
    ``sample_tree_csr`` through it, fed the uniforms of JAX's
    ``sample_tree_csr``: JAX's levels, on a graph whose isolated nodes (the
    tail node among them) self-loop, for the element and window forms."""
    adj, deg = _graph()
    indptr, indices = _csr(adj, deg, window)
    ids = np.array([0, 1, 2, 3, 4, 5, 5, 3], np.int32)
    key = jax.random.key(sum(fanouts) + window)
    want = jcsr.sample_tree_csr(key, jnp.asarray(indptr), jnp.asarray(indices),
                                jnp.asarray(deg), jnp.asarray(ids), fanouts, window=window)
    us = _jax_hop_uniforms(key, ids.shape[0], fanouts)
    plain = csr_tree_reference(_t(indptr), _t(indices), _t(deg), _t(ids), us)
    wrapped = csr_tree(_t(indptr), _t(indices), _t(deg), _t(ids), us)
    tree = csr.sample_tree_csr(_t(indptr), _t(indices), _t(deg), _t(ids), fanouts,
                               window=window, us=us)
    assert len(plain) == len(wrapped) == len(fanouts) == len(tree) - 1
    for level, b in enumerate(want[1:]):
        for got in (plain[level], wrapped[level], tree[level + 1]):
            assert got.dtype == torch.int32 and got.shape == (np.asarray(b).shape[0],)
            np.testing.assert_array_equal(got.numpy(), np.asarray(b))
    assert torch.equal(csr_tree(_t(indptr), _t(indices), _t(deg), _t(ids), us,
                                last_only=True)[0], plain[-1])


def _walk_graphs(window):
    from types import SimpleNamespace

    adj, deg = _graph()
    indptr, indices = _csr(adj, deg, window)
    jg = SimpleNamespace(indptr=jnp.asarray(indptr), indices=jnp.asarray(indices),
                         degrees=jnp.asarray(deg), window=window)
    tg = SimpleNamespace(indptr=_t(indptr), indices=_t(indices), degrees=_t(deg), window=window)
    return jg, tg


@pytest.mark.parametrize("length", [1, 2, 3, 4])
@pytest.mark.parametrize("window", [0, 4], ids=["element", "window"])
def test_the_one_launch_walk_is_bitwise_the_reference_walk(window, length):
    """A CSR walk is the tree of fanout 1 a hop, its last level kept:
    ``graph_random_walk`` fed the uniforms JAX's CSR walk draws (one key a
    hop, ``uniform(k, (B, 1))``) ends where JAX's ends, isolated nodes
    staying put."""
    from tpu_sage.train import unsupervised as jun
    from tpu_sage_torch.train import unsupervised as un

    jg, tg = _walk_graphs(window)
    ids = np.array([0, 1, 2, 3, 4, 5, 2, 0, 3], np.int32)
    key = jax.random.key(10 + length)
    want = jun.graph_random_walk(key, jg, jnp.asarray(ids), length)
    us = [torch.from_numpy(np.array(jax.random.uniform(k, (ids.shape[0], 1))))
          for k in jax.random.split(key, length)]
    got = un.graph_random_walk(tg, _t(ids), length, us=us)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[[4, 5]] == torch.tensor([4, 5], dtype=torch.int32)).all()
    last = csr_tree(tg.indptr, tg.indices, tg.degrees, _t(ids), us, last_only=True)
    assert len(last) == 1 and torch.equal(last[0], got)


@pytest.mark.parametrize("window", [0, 4], ids=["element", "window"])
def test_trees_and_walks_draw_what_the_hop_by_hop_code_draws(window):
    """One ``torch.Generator`` seed gives the same tree and the same walk as
    the hop-by-hop code (one ``uniform_neighbor_sample_csr`` a hop, each
    drawing its ``(N_l, f_l)`` uniforms in turn), on an SBM store with
    isolated nodes."""
    from types import SimpleNamespace

    from tpu_sage_torch.data.synthetic import sbm_store
    from tpu_sage_torch.train import unsupervised as un

    store = sbm_store(n_nodes=300, n_classes=3, feat_dim=8, avg_degree=5, seed=17)
    store.degrees[[0, 7, 299]] = 0
    w = int(store.degrees.max()) if window else 0
    indptr, indices = (_t(a) for a in _csr(store.adj, store.degrees, w))
    deg = _t(store.degrees)
    ids = torch.arange(0, 300, 7, dtype=torch.int32)
    for fanouts in ((6, 4), (3, 2, 2, 2, 2)):
        tree = csr.sample_tree_csr(indptr, indices, deg, ids, fanouts, window=w,
                                   generator=torch.Generator().manual_seed(21))
        gen, old = torch.Generator().manual_seed(21), [ids]
        for f in fanouts:
            old.append(csr.uniform_neighbor_sample_csr(indptr, indices, deg, old[-1], f,
                                                       generator=gen).reshape(-1))
        assert len(tree) == len(old)
        for a, b in zip(tree, old):
            assert torch.equal(a, b)
    graph = SimpleNamespace(indptr=indptr, indices=indices, degrees=deg, window=w)
    for length in (3, 6):
        walk = un.graph_random_walk(graph, ids, length,
                                    generator=torch.Generator().manual_seed(22))
        gen, cur = torch.Generator().manual_seed(22), ids
        for _ in range(length):
            cur = csr.uniform_neighbor_sample_csr(indptr, indices, deg, cur, 1,
                                                  generator=gen)[:, 0]
        assert torch.equal(walk, cur)


def test_the_tree_kernel_checks_its_arguments_and_counts_only_launches():
    from tpu_sage_torch import kernels
    from tpu_sage_torch.kernels import sample_hop

    adj, deg = _graph()
    indptr, indices = _csr(adj, deg, 0)
    args = (_t(indptr), _t(indices), _t(deg))
    with pytest.raises(ValueError, match="us\\[1\\] must be"):
        csr_tree(*args, _t([0, 1]), [torch.zeros(2, 3), torch.zeros(5, 2)])
    with pytest.raises(ValueError, match="indptr has"):
        csr_tree(_t(indptr[:-1]), *args[1:], _t([0]), [torch.zeros(1, 2)])
    wide = torch.zeros(1, 1).expand(2**16, 2**16)  # 2^32 leaves, no memory behind them
    with pytest.raises(ValueError, match="exceeds the kernel's 2\\^31 - 1"):
        csr_tree(*args, torch.zeros(2**16, dtype=torch.int32), [wide])
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        csr_tree(*(a.to("meta") for a in args), _t([0]).to("meta"),
                 [torch.zeros(1, 2, device="meta")])
    kernels.reset_launch_counts()
    levels = csr_tree(*args, _t([0, 5]), [torch.zeros(2, 3), torch.zeros(6, 0)])
    assert [tuple(lv.shape) for lv in levels] == [(6,), (0,)]
    assert torch.equal(levels[0], _t([1, 1, 1, 5, 5, 5]))
    assert csr_tree(*args, _t([0, 5]), []) == []
    assert kernels.launch_counts()["csr_tree"] == 0
    assert kernels.KERNELS["csr_tree"][:2] == (sample_hop, "select")
    assert sample_hop.TREE_HOPS == 4
