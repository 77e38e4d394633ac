"""The port's graph partitioning (tpu_sage_torch/dist/partition.py) against
the JAX package's, bitwise: the reordering passes, the cut fraction, the
padded and CSR shard arrays, the fold tables; each rank's device shard
against the JAX package's shard of the same array (dense in f32 and bf16,
int8 with its scales, CSR blocks); and the per-epoch batch draws' contract.
Single process: a shard is built for each rank by number.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sage.data.synthetic import sbm_store as j_sbm_store
from tpu_sage.dist import partition as jp
from tpu_sage.dist.mesh import make_mesh
from tpu_sage_torch.data.synthetic import sbm_store
from tpu_sage_torch.dist import partition as tp
from tpu_sage_torch.dist.train import epoch_batch_ids, epoch_perm, rng_seed

KW = dict(n_nodes=203, n_classes=4, feat_dim=12, avg_degree=5, max_degree=16, seed=21)


def _stores():
    return sbm_store(**KW), j_sbm_store(**KW)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _store_eq(a, b):
    for f in ("adj", "degrees", "train_adj", "train_degrees", "feats", "targets"):
        _eq(getattr(a, f), getattr(b, f))
    assert sorted(a.folds) == sorted(b.folds)
    for k in a.folds:
        _eq(a.folds[k], b.folds[k])


@pytest.mark.parametrize("n_shards", [1, 3, 4, 8])
def test_permutations_reorder_and_cut_are_bitwise_jax(n_shards):
    t, j = _stores()
    assert tp.pad_to_shards(t.n_nodes, n_shards) == jp.pad_to_shards(t.n_nodes, n_shards)
    _eq(tp.degree_balanced_permutation(t.degrees, n_shards),
        jp.degree_balanced_permutation(j.degrees, n_shards))
    perm = tp.locality_permutation(t.adj, t.degrees)
    _eq(perm, jp.locality_permutation(j.adj, j.degrees))
    _store_eq(tp.reorder_store(t, perm), jp.reorder_store(j, perm))
    assert tp.edge_cut_fraction(t, n_shards) == jp.edge_cut_fraction(j, n_shards)
    rt = tp.reorder_store(t, perm)
    assert tp.edge_cut_fraction(rt, n_shards) == jp.edge_cut_fraction(
        jp.reorder_store(j, perm), n_shards)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_arrays_and_fold_tables_are_bitwise_jax(n_shards, train):
    t, j = _stores()
    ta, tm = tp.partition_arrays(t, n_shards, train)
    ja, jm = jp.partition_arrays(j, n_shards, train)
    assert tm == jm and sorted(ta) == sorted(ja)
    for k in ta:
        _eq(ta[k], ja[k])
    tc, tm, tw = tp.partition_csr_arrays(t, n_shards, train)
    jc, jm, jw = jp.partition_csr_arrays(j, n_shards, train)
    assert (tm, tw) == (jm, jw) and sorted(tc) == sorted(jc)
    for k in tc:
        _eq(tc[k], jc[k])
    for fold in ("train", "val"):
        for a, b in zip(tp.shard_fold(t.folds[fold], n_shards, tm),
                        jp.shard_fold(j.folds[fold], n_shards, jm)):
            _eq(a, b)
        for mult in (1, 8):
            for a, b in zip(tp.shard_fold_masked(t.folds[fold], n_shards, tm, mult),
                            jp.shard_fold_masked(j.folds[fold], n_shards, jm, mult)):
                _eq(a, b)
    ids, mask = tp.shard_fold_masked(t.folds["val"], n_shards, tm, 8)
    assert mask.sum() == len(t.folds["val"])
    assert np.array_equal(np.sort(ids[mask > 0]), np.sort(t.folds["val"]))


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8", "csr"])
def test_each_ranks_device_shard_is_the_jax_shard(eight_devices, storage):
    """Rank s's tensors equal shard s of the JAX package's sharded arrays:
    adjacency, degrees, targets, features (f32, bf16, int8 with the
    replicated per-column scales in the compute dtype) and CSR blocks."""
    n_shards = 4
    t, j = _stores()
    mesh = make_mesh(n_devices=n_shards)
    quantize = storage == "int8"
    dt = torch.bfloat16 if storage in ("bfloat16", "int8") else None
    jdt = "bfloat16" if dt is not None else None
    if storage == "csr":
        jg, jm = jp.shard_graph_csr(j, mesh, train=True)
    else:
        jg, jm = jp.shard_graph(j, mesh, train=True, feat_dtype=jdt, quantize=quantize)
    for s in range(n_shards):
        if storage == "csr":
            g, m = tp.shard_graph_csr(t, train=True, device="cpu", n_shards=n_shards, shard=s)
            r = np.asarray(jg.indices).shape[0] // n_shards
            _eq(g.indptr, np.asarray(jg.indptr)[s * (m + 1):(s + 1) * (m + 1)])
            _eq(g.indices, np.asarray(jg.indices)[s * r:(s + 1) * r])
            assert g.window == jg.window
        else:
            g, m = tp.shard_graph(t, train=True, device="cpu", feat_dtype=dt,
                                  quantize=quantize, n_shards=n_shards, shard=s)
            _eq(g.adj, np.asarray(jg.adj)[s * m:(s + 1) * m])
        assert m == jm
        _eq(g.degrees, np.asarray(jg.degrees)[s * m:(s + 1) * m])
        _eq(g.targets, np.asarray(jg.targets)[s * m:(s + 1) * m])
        want = np.asarray(jnp.asarray(jg.feats[s * m:(s + 1) * m]).astype(jnp.float32))
        _eq(g.feats.float(), want)
        assert g.feats.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16,
                                 "int8": torch.int8, "csr": torch.float32}[storage]
        if quantize:
            _eq(g.feat_scale.float(), np.asarray(jg.feat_scale.astype(jnp.float32)))
            assert g.feat_scale.dtype == torch.bfloat16
        else:
            assert g.feat_scale is None  # the reference's ones: x · 1 is exact
            _eq(np.asarray(jg.feat_scale.astype(jnp.float32)), 1.0)


def test_shard_graph_adopts_given_feature_shards():
    t, _ = _stores()
    g, _ = tp.shard_graph(t, train=True, device="cpu", n_shards=2, shard=1)
    h, _ = tp.shard_graph(t, train=False, device="cpu", n_shards=2, shard=1,
                          reuse_feats=(g.feats, g.feat_scale))
    assert h.feats is g.feats
    k, _ = tp.shard_graph(t, train=False, device="cpu", n_shards=4, shard=1,
                          reuse_feats=(g.feats, g.feat_scale))  # another shape: uploaded anew
    assert k.feats is not g.feats and k.feats.shape[0] == 51


@pytest.mark.parametrize("have, want", [("int8", "bf16"), ("bf16", "int8"),
                                        ("bf16", "f32")])
@pytest.mark.parametrize("csr", [False, True])
def test_shard_graph_refuses_feature_shards_of_another_storage(have, want, csr):
    """reuse_feats of the right shape but another storage (int8 rows with a
    scale where dense bf16 is asked for, the reverse, or bf16 where f32 is)
    raises instead of being adopted."""
    t, _ = _stores()
    storage = {"int8": dict(quantize=True, feat_dtype=torch.bfloat16),
               "bf16": dict(feat_dtype=torch.bfloat16), "f32": {}}
    shard = tp.shard_graph_csr if csr else tp.shard_graph
    g, _ = shard(t, train=True, device="cpu", n_shards=2, shard=1, **storage[have])
    with pytest.raises(ValueError, match="reuse_feats holds"):
        shard(t, train=False, device="cpu", n_shards=2, shard=1,
              reuse_feats=(g.feats, g.feat_scale), **storage[want])
    h, _ = shard(t, train=False, device="cpu", n_shards=2, shard=1,
                 reuse_feats=(g.feats, g.feat_scale), **storage[have])
    assert h.feats is g.feats and h.feat_scale is g.feat_scale


def test_epoch_batch_ids_exact_uniform_and_cycling():
    """Within an epoch each real fold node is drawn as often as any other
    ±1, the first ``count`` draws are a permutation, the wrapped padding is
    never drawn; another epoch (or another rank) reshuffles; the draws are a
    function of (seed, epoch, rank)."""
    fold_row = torch.tensor([5, 6, 7, 5, 5], dtype=torch.int32)  # 3 real + wrapped tail
    bps, spe = 2, 4
    draws = [int(x) for t in range(spe)
             for x in epoch_batch_ids(0, t, fold_row, 3.0, bps, spe, 0)]
    assert set(draws) <= {5, 6, 7}
    counts = {v: draws.count(v) for v in (5, 6, 7)}
    assert max(counts.values()) - min(counts.values()) <= 1, counts
    assert len(set(draws[:3])) == 3
    perms = {tuple(epoch_perm(0, e, s, 40, 40.0, torch.device("cpu")).tolist())
             for e in range(3) for s in range(3)}
    assert len(perms) == 9
    again = [int(x) for t in range(spe) for x in epoch_batch_ids(0, t, fold_row, 3.0, bps, spe, 0)]
    assert again == draws
    tail = epoch_perm(1, 0, 0, 10, 6.0, torch.device("cpu"))
    assert sorted(tail[:6].tolist()) == list(range(6)) and sorted(tail[6:].tolist()) == [6, 7, 8, 9]
    assert rng_seed(1, 2, 3, 4) != rng_seed(1, 2, 3, 5)


def test_epoch_batches_are_uniform_over_many_epochs():
    """Over 3,000 epochs each of 5 real slots is drawn first about equally
    often (chi-square, 4 degrees of freedom, p > 0.001)."""
    first = np.zeros(5)
    for e in range(3000):
        first[int(epoch_perm(2, e, 0, 7, 5.0, torch.device("cpu"))[0])] += 1
    chi2 = ((first - 600.0) ** 2 / 600.0).sum()
    assert chi2 < 18.47, first
