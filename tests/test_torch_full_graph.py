"""tpu_sage_torch exact full-graph inference against the JAX package's
``embed_all_nodes``, on the CPU.

Both sides get the same SBM store (bit-equal generators, with forced
degree-0 nodes), the same flax parameters and a chunk that does not divide
the node count. Tolerances:

- f32: within 1e-5 x max|out|.
- bf16 table: layer 0's summary bitwise equal to JAX's (both sum in f32,
  round once to bf16 and divide in bf16); everything after it is f32 on both
  sides, so the outputs agree within one bf16 ulp of the output's scale
  (2^-8 x max|out|), far more than the f32 products' rounding needs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sage.data.synthetic import sbm_store as j_sbm_store
from tpu_sage.nn import full_graph as jfg
from tpu_sage.train.trainer import TrainConfig as JTrainConfig
from tpu_sage.train.trainer import build_model as j_build_model
from tpu_sage_torch.data.synthetic import sbm_store
from tpu_sage_torch.nn import full_graph as tfg
from tpu_sage_torch.nn.params import load_flax_params
from tpu_sage_torch.train.trainer import TrainConfig, build_model

N, CHUNK, ISOLATED = 150, 64, (7, 64, 149)
BF16_ULP = 2.0 ** -8


def _stores():
    kw = dict(n_nodes=N, n_classes=3, feat_dim=8, avg_degree=5, max_degree=16, seed=17)
    stores = (j_sbm_store(**kw), sbm_store(**kw))
    for st in stores:
        for v in ISOLATED:
            st.degrees[v] = 0
            st.adj[v] = v
    return stores


def _models(combine="concat", normalize=True, compute_dtype="float32", **extra):
    kw = dict(n_train_samples=(4, 3), n_val_samples=(4, 3), output_dims=(16, 12),
              combine=combine, normalize=normalize, compute_dtype=compute_dtype,
              agg_hidden_dim=20, embedding_dim=8, **extra)
    jst, tst = _stores()
    jmodel = j_build_model(JTrainConfig(**kw), N, jst.n_classes)
    levels = [jnp.zeros((4,), jnp.int32), jnp.zeros((16,), jnp.int32),
              jnp.zeros((48,), jnp.int32)]
    params = jmodel.init(jax.random.key(3), levels, jnp.asarray(jst.feats))
    tmodel = build_model(TrainConfig(**kw), N, tst.n_classes, tst.feat_dim)
    load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jst, tst, jmodel, params, tmodel


def _graphs(jst, tst, bf16):
    jgraph = jst.to_device(train=False, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tgraph = tst.to_device(train=False, dtype=torch.bfloat16 if bf16 else torch.float32,
                           device="cpu")
    return jgraph, tgraph


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("combine,normalize", [("concat", True), ("add", True),
                                               ("concat", False)])
@pytest.mark.parametrize("with_head", [False, True], ids=["embeddings", "logits"])
def test_embed_all_nodes_matches_jax(bf16, combine, normalize, with_head):
    jst, tst, jmodel, params, tmodel = _models(
        combine, normalize, "bfloat16" if bf16 else "float32")
    jgraph, tgraph = _graphs(jst, tst, bf16)
    ref = np.asarray(jfg.embed_all_nodes(jmodel, params, jgraph, chunk=CHUNK,
                                         with_head=with_head).astype(jnp.float32))
    out = tfg.embed_all_nodes(tmodel, tgraph, chunk=CHUNK, with_head=with_head)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    tol = (BF16_ULP if bf16 else 1e-5) * np.abs(ref).max()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol)
    if normalize and not with_head:
        np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=1), 1.0, rtol=1e-5)


def _layer0_summaries(monkeypatch, bf16):
    """Layer 0's neighbor summary on both sides: the combine step replaced by
    one that returns the summary."""
    jst, tst, jmodel, params, tmodel = _models(
        compute_dtype="bfloat16" if bf16 else "float32")
    jgraph, tgraph = _graphs(jst, tst, bf16)
    monkeypatch.setattr(jfg, "_combine_with_params",
                        lambda model, li, sub, h_self, summary, agg: summary)
    monkeypatch.setattr(tfg, "_combine_with_params", lambda agg, h_self, summary: summary)
    ref = jfg._layer_full(jmodel, params, 0, jgraph.feats, jgraph, CHUNK)
    with torch.inference_mode():
        out = tfg._layer_full(tmodel, 0, tgraph.feats, tgraph, CHUNK)
    return ref, out, tst


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_layer0_summary_matches_jax(monkeypatch, bf16):
    ref, out, store = _layer0_summaries(monkeypatch, bf16)
    if bf16:
        assert ref.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
        np.testing.assert_array_equal(out.view(torch.int16).numpy(),
                                      np.asarray(ref).view(np.int16))
    else:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # degree-0 nodes take their own row
    for v in ISOLATED:
        np.testing.assert_array_equal(out[v].float().numpy(),
                                      torch.from_numpy(store.feats[v]).to(out.dtype).float())


def test_chunk_size_does_not_change_the_result():
    """Summaries are per node; only the products' blocking differs with the
    chunk's row count (f32 rounding)."""
    _, tst, _, _, tmodel = _models()
    _, tgraph = _graphs(*_stores(), False)
    whole = tfg.embed_all_nodes(tmodel, tgraph, chunk=N + 10, with_head=True).numpy()
    for chunk in (1, 16, 63):
        np.testing.assert_allclose(
            tfg.embed_all_nodes(tmodel, tgraph, chunk=chunk, with_head=True).numpy(),
            whole, rtol=0, atol=1e-6 * np.abs(whole).max())


def test_exact_support_and_refusals():
    """Every permutation-invariant aggregator runs (gcn was refused until
    ROADMAP Queue 1 item 8 ported it); lstm is order-defined and raises as
    the JAX package does; a node-embedding table of another graph's size is
    refused."""
    _, tst, _, _, tmodel = _models()
    _, tgraph = _graphs(*_stores(), False)
    assert tfg.exact_supported(tmodel)
    assert tfg.EXACT_AGGREGATORS == jfg.EXACT_AGGREGATORS
    gcn = _models(aggregator_class="gcn")[-1]
    assert tfg.exact_supported(gcn)
    assert tuple(tfg.embed_all_nodes(gcn, tgraph).shape) == (N, 12)
    lstm = _models(aggregator_class="lstm")[-1]
    assert not tfg.exact_supported(lstm)
    with pytest.raises(ValueError, match="sample-defined"):
        tfg.embed_all_nodes(lstm, tgraph)
    emb = build_model(TrainConfig(n_train_samples=(4, 3), n_val_samples=(4, 3),
                                  output_dims=(16, 12), prep_class="node_embedding"),
                      N + 1, tst.n_classes, tst.feat_dim)
    with pytest.raises(ValueError, match="transductive"):
        tfg.embed_all_nodes(emb, tgraph)


# the other exact aggregators and the preps, against the JAX package, with
# the tolerances of the module docstring: after layer 0's summary everything
# is f32 on both sides; gcn's bf16 summary is held bitwise below. Pools and
# attention mask the columns past each degree; degree-0 nodes self-loop.
EXACT_CASES = [(a, "identity") for a in ("gcn", "max_pool", "mean_pool", "attention")] + [
    ("mean", "linear"), ("max_pool", "node_embedding")]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("agg,prep", EXACT_CASES, ids=[f"{a}-{p}" for a, p in EXACT_CASES])
def test_embed_all_nodes_every_aggregator_and_prep(agg, prep, bf16):
    jst, tst, jmodel, params, tmodel = _models(
        compute_dtype="bfloat16" if bf16 else "float32", aggregator_class=agg, prep_class=prep)
    jgraph, tgraph = _graphs(jst, tst, bf16)
    for with_head in (False, True):
        ref = np.asarray(jfg.embed_all_nodes(jmodel, params, jgraph, chunk=CHUNK,
                                             with_head=with_head).astype(jnp.float32))
        out = tfg.embed_all_nodes(tmodel, tgraph, chunk=CHUNK, with_head=with_head)
        assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
        tol = (BF16_ULP if bf16 else 1e-5) * np.abs(ref).max()
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol)


def test_gcn_layer0_summary_matches_jax_bitwise(monkeypatch):
    """gcn's bf16 summary ``(mean · deg + self) / (deg + 1)`` stays in the
    table's dtype, as JAX's does; degree-0 nodes keep their own row."""
    jst, tst, jmodel, params, tmodel = _models(compute_dtype="bfloat16", aggregator_class="gcn")
    jgraph, tgraph = _graphs(jst, tst, True)
    monkeypatch.setattr(jfg, "_combine_with_params",
                        lambda model, li, sub, h_self, summary, agg: summary)
    monkeypatch.setattr(tfg, "_combine_with_params", lambda agg, h_self, summary: summary)
    ref = jfg._layer_full(jmodel, params, 0, jgraph.feats, jgraph, CHUNK)
    with torch.inference_mode():
        out = tfg._layer_full(tmodel, 0, tgraph.feats, tgraph, CHUNK)
    assert ref.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.view(torch.int16).numpy(), np.asarray(ref).view(np.int16))
    for v in ISOLATED:
        np.testing.assert_array_equal(out[v].float().numpy(),
                                      torch.from_numpy(tst.feats[v]).bfloat16().float().numpy())
