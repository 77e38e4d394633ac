"""tpu_sage_torch int8 feature storage against the JAX package's, on the CPU.

Seeded numpy inputs go through ``tpu_sage/data/quantize.py`` and
``tpu_sage_torch/data/quantize.py``. Tolerances:

- bitwise: ``quantize_np``, the dequantized rows (``qf[ids]``,
  ``row_gather``, ``dequantize``), the fanout mean in both modes and both
  compute dtypes against ``jax.jit`` of the reference (the trainer's step
  runs under jit, where XLA multiplies by ``fl32(1/F)`` and, for f32 rows,
  contracts the dequantizing multiply into the sum), ``assortative_bench_store``;
- whole model and exact inference: the tolerances of
  ``tests/test_torch_model.py`` and ``tests/test_torch_full_graph.py`` for
  the dense table (f32 1e-5 on logits, 1e-4 on gradients; bf16 6e-3 of the
  logits' scale, 1.5e-2 of each gradient's scale of JAX's bf16 gradient or,
  where it is not, of JAX's f32 one; exact inference f32 1e-5, bf16 2^-8 of
  the output's scale), with one addition: bf16 logits may also differ by one
  bf16 ulp of their own size. On these inputs max_pool's bf16 logits differ
  by 8.3e-3 of scale (two ulps of a 0.18 logit against a 0.23 maximum) in
  both the int8 table and the dense table of its dequantized values, since
  each package's int8 model is bitwise its dense model on that table (held
  here for the paths without the fused int8 mean).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sage import ops as jops
from tpu_sage.data import quantize as jq
from tpu_sage.nn.model import GSSupervised as JGSSupervised
from tpu_sage.nn.model import default_layer_specs as j_specs
from tpu_sage.train.losses import cross_entropy as j_cross_entropy
from tpu_sage_torch import ops
from tpu_sage_torch.data import quantize as tq
from tpu_sage_torch.kernels.gather_mean import (gather_fanout_mean_int8,
                                                gather_fanout_mean_int8_reference)
from tpu_sage_torch.nn.model import GSSupervised, default_layer_specs
from tpu_sage_torch.nn.params import flax_key, load_flax_params
from tpu_sage_torch.train.losses import cross_entropy

DTYPES = [("bfloat16", torch.bfloat16), ("float32", torch.float32)]
DT_IDS = ["bf16", "f32"]


def _feats(n=300, d=37, seed=0):
    rng = np.random.default_rng(seed)
    feats = (rng.normal(size=(n, d)) * rng.uniform(0.05, 4.0, size=d)).astype(np.float32)
    feats[:, 5] = 0.0  # an all-zero column: scale 1.0
    return feats


def _both(feats, jdt, tdt):
    return jq.quantize_feats(feats, out_dtype=jdt), tq.quantize_feats(feats, out_dtype=tdt,
                                                                       device="cpu")


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_np_is_bitwise_the_reference(seed):
    feats = _feats(seed=seed)
    q, scale = tq.quantize_np(feats)
    jqv, jscale = jq.quantize_np(feats)
    assert q.dtype == np.int8 and scale.dtype == np.float32
    np.testing.assert_array_equal(q, jqv)
    np.testing.assert_array_equal(scale, jscale)
    assert scale[5] == 1.0 and np.abs(q).max() <= 127
    # each element within half a step of its column's scale
    assert np.all(np.abs(q * scale - feats) <= scale / 2 + 1e-6 * np.abs(feats))


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_dequantized_rows_are_bitwise_the_reference(jdt, tdt):
    """``qf[ids]``, ``ops.row_gather`` (plain and masked, out-of-range ids
    included) and ``dequantize``: the int8 rows gathered, then one multiply
    by the scale in the compute dtype; both operands are exact in bf16, so
    the product rounds once on both sides."""
    feats = _feats()
    jf, tf = _both(feats, jdt, tdt)
    n = feats.shape[0]
    ids = np.r_[np.random.default_rng(3).integers(0, n, 200), [0, n - 1]].astype(np.int32)
    oob = np.array([-1, -n - 4, n, n + 9, 4], np.int32)
    assert tf.shape == feats.shape and tf.ndim == 2 and tf.dtype == tdt
    assert tf.device == torch.device("cpu") and tf.nbytes == feats.size + 4 * feats.shape[1]
    got = tf[torch.from_numpy(ids)]
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  _np(jax.jit(lambda f, i: f[i])(jf, jnp.asarray(ids))))
    for form in ("plain", "masked"):
        want = jax.jit(lambda f, i: jops.row_gather(f, i, form=form))(jf, jnp.asarray(oob))
        np.testing.assert_array_equal(
            ops.row_gather(tf, torch.from_numpy(oob), form=form).float().numpy(), _np(want))
    np.testing.assert_array_equal(tf.dequantize().float().numpy(), _np(jf.dequantize()))


@pytest.mark.parametrize("fanout", [10, 40])
@pytest.mark.parametrize("summean", [True, False], ids=["summean", "dequantize_then_mean"])
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_fanout_mean_is_bitwise_the_jitted_reference(jdt, tdt, summean, fanout):
    """The int8 fanout mean (the kernel's plain version, through
    ``ops.row_gather_fanout_mean``) against ``jax.jit`` of the reference's
    ``ops.row_gather_fanout_mean``: ``summean`` is ``QuantizedFeats.
    fanout_mean`` (int32 sum times ``fl32(scale · fl32(1/F))``); otherwise
    ``jnp.mean`` of the dequantized rows. f32 pins the jitted forms: eager
    JAX divides by ``F`` and rounds another way in about one mean in six.
    One exception: f32 dequantize-then-mean over a fanout above 16 (not the
    fused level's 10 on any preset), where XLA's CPU reduction of the longer
    axis takes another order than f = 0, 1, ...: within 1e-6 of scale."""
    feats = _feats(n=500, d=37)
    jf, tf = _both(feats, jdt, tdt)
    roots = 64
    ids = np.random.default_rng(4).integers(0, feats.shape[0], roots * fanout).astype(np.int32)
    want = jax.jit(lambda f, i: jops.row_gather_fanout_mean(
        f, i, fanout, int8_summean=summean))(jf, jnp.asarray(ids))
    got = ops.row_gather_fanout_mean(tf, torch.from_numpy(ids), fanout, int8_summean=summean)
    assert got.dtype == tdt and tuple(got.shape) == (roots, feats.shape[1])
    if tdt == torch.float32 and not summean and fanout > 16:
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                                   atol=1e-6 * np.abs(_np(want)).max())
        return
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


def test_the_two_int8_means_differ_and_out_of_range_ids_clamp():
    """The int32-sum mean and the dequantize-then-mean round differently
    (``tpu_sage/data/quantize.py:74-80``): in f32 many means differ, each by
    a few ulps. Out-of-range ids take the ``plain`` form in both modes, as
    the reference's gather does."""
    feats = _feats(n=500, d=37)
    jf, tf = _both(feats, "float32", torch.float32)
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 500, 640).astype(np.int32))
    a = tf.fanout_mean(ids, 64, 10, summean=True)
    b = tf.fanout_mean(ids, 64, 10, summean=False)
    differ = (a != b).float().mean().item()
    assert 0.1 < differ < 1.0, differ
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * a.abs().max().item())
    oob = np.array([-1, -600, 500, 777, 3, 0], np.int32)
    for summean in (True, False):
        want = jax.jit(lambda f, i: jops.row_gather_fanout_mean(
            f, i, 3, int8_summean=summean))(jf, jnp.asarray(oob))
        got = gather_fanout_mean_int8(tf.q, tf.scale, torch.from_numpy(oob), 3, torch.float32,
                                      summean)
        np.testing.assert_array_equal(got.numpy(), _np(want))


def test_int8_fanout_mean_checks_its_arguments():
    q, scale = torch.zeros(4, 3, dtype=torch.int8), torch.ones(3)
    with pytest.raises(ValueError, match="multiple of fanout"):
        gather_fanout_mean_int8(q, scale, torch.zeros(7, dtype=torch.int32), 3, torch.float32)
    with pytest.raises(TypeError, match="out_dtype"):
        gather_fanout_mean_int8(q, scale, torch.zeros(6, dtype=torch.int32), 3, torch.float16)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        gather_fanout_mean_int8(q.to("meta"), scale.to("meta"),
                                torch.zeros(6, dtype=torch.int32, device="meta"), 3,
                                torch.float32)
    with pytest.raises(ValueError, match="scale must be"):
        tq.QuantizedFeats(q, torch.ones(4))
    out = gather_fanout_mean_int8_reference(q, scale, torch.zeros(6, dtype=torch.int32), 3,
                                            torch.bfloat16, summean=False)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 3)


# -- the whole model with an int8 table ---------------------------------------

N_NODES, D, N_CLASSES, B, FANOUTS, DIMS = 40, 16, 7, 6, (5, 3), (24, 24)
MODEL_CASES = [("mean", "identity"), ("max_pool", "identity"), ("mean", "linear")]


def _model_pair(agg, prep, jdt):
    kw = dict(aggregator_class=agg, prep_class=prep, n_nodes=N_NODES, embedding_dim=8,
              agg_hidden_dim=20)
    jmodel = JGSSupervised(layer_specs=j_specs(fanouts=FANOUTS, output_dims=DIMS),
                           n_classes=N_CLASSES, dtype=None if jdt == "float32" else jdt, **kw)
    tmodel = GSSupervised(default_layer_specs(fanouts=FANOUTS, output_dims=DIMS), N_CLASSES,
                          feat_dim=D, dtype=None if jdt == "float32" else getattr(torch, jdt),
                          **kw)
    return jmodel, tmodel


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _jax_logits_and_grads(agg, prep, jdt, feats, levels, targets):
    jmodel, _ = _model_pair(agg, prep, jdt)
    jf = jq.quantize_feats(feats, out_dtype=jdt)
    jlevels = [jnp.asarray(l) for l in levels]
    params = jmodel.init(jax.random.key(4), jlevels, jf)
    logits = _np(jmodel.apply(params, jlevels, jf))
    grads = _flat(jax.grad(lambda p: j_cross_entropy(
        jmodel.apply(p, jlevels, jf), jnp.asarray(targets)))(params))
    return params, logits, grads


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("agg,prep", MODEL_CASES, ids=[f"{a}-{p}" for a, p in MODEL_CASES])
def test_whole_model_with_an_int8_table_matches_flax(agg, prep, jdt, tdt):
    """mean/identity (the fused int8 fanout mean), max_pool/identity (the
    deepest level gathered whole, dequantized) and mean/linear (unfused):
    logits and parameter gradients with the same flax parameters."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(N_NODES, D)).astype(np.float32)
    sizes = [B, B * FANOUTS[0], B * FANOUTS[0] * FANOUTS[1]]
    levels = [rng.integers(0, N_NODES, size=s).astype(np.int32) for s in sizes]
    targets = rng.integers(0, N_CLASSES, size=B).astype(np.int32)
    params, jlogits, jgrads = _jax_logits_and_grads(agg, prep, jdt, feats, levels, targets)
    _, tmodel = _model_pair(agg, prep, jdt)
    load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    tlogits = tmodel([torch.from_numpy(l) for l in levels],
                     tq.quantize_feats(feats, out_dtype=tdt, device="cpu"))
    cross_entropy(tlogits, torch.from_numpy(targets)).backward()
    tgrads = {flax_key(n): p.grad.numpy() for n, p in tmodel.named_parameters()}
    assert sorted(tgrads) == sorted(jgrads)
    tlogits = tlogits.detach().float().numpy()
    if (agg, prep) != ("mean", "identity"):  # no fused int8 mean: dequantized rows only
        qf = tq.quantize_feats(feats, out_dtype=tdt, device="cpu")
        with torch.no_grad():
            dense = tmodel([torch.from_numpy(l) for l in levels], qf.dequantize())
        np.testing.assert_array_equal(tlogits, dense.float().numpy())
    if tdt == torch.float32:
        np.testing.assert_allclose(tlogits, jlogits, rtol=1e-5, atol=1e-5)
        for k in jgrads:
            np.testing.assert_allclose(tgrads[k], jgrads[k], rtol=1e-4, atol=1e-4, err_msg=k)
        return
    np.testing.assert_allclose(tlogits, jlogits, rtol=2.0 ** -8,
                               atol=6e-3 * np.abs(jlogits).max())
    jgrads32 = None
    for k in jgrads:
        if np.abs(tgrads[k] - jgrads[k]).max() > 1.5e-2 * np.abs(jgrads[k]).max():
            jgrads32 = jgrads32 or _jax_logits_and_grads(agg, prep, "float32", feats, levels,
                                                         targets)[2]
            assert (np.abs(tgrads[k] - jgrads32[k]).max()
                    <= 1.5e-2 * np.abs(jgrads32[k]).max()), k


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("agg", ["mean", "max_pool"])
def test_exact_inference_of_an_int8_graph_matches_jax(agg, jdt, tdt):
    """``embed_all_nodes`` dequantizes the table first on both sides, as a
    ``QuantizedFeats`` and (f32 cases) as raw int8 rows with ``feat_scale``,
    the partitioned layout, which a ``torch.Tensor``'s own ``dequantize``
    must not take for a ``QuantizedFeats``."""
    from tpu_sage.data.synthetic import sbm_store as j_sbm_store
    from tpu_sage.nn import full_graph as jfg
    from tpu_sage.train.trainer import TrainConfig as JTrainConfig
    from tpu_sage.train.trainer import build_model as j_build_model
    from tpu_sage_torch.data.synthetic import sbm_store
    from tpu_sage_torch.graph.graph_data import DeviceGraph
    from tpu_sage_torch.nn import full_graph as tfg
    from tpu_sage_torch.train.trainer import TrainConfig, build_model

    n = 150
    kw = dict(n_nodes=n, n_classes=3, feat_dim=8, avg_degree=5, max_degree=16, seed=17)
    jst, tst = j_sbm_store(**kw), sbm_store(**kw)
    for st in (jst, tst):
        st.degrees[7] = 0
        st.adj[7] = 7
    ckw = dict(n_train_samples=(4, 3), n_val_samples=(4, 3), output_dims=(16, 12),
               compute_dtype=jdt, agg_hidden_dim=20, aggregator_class=agg, feature_int8=True)
    jmodel = j_build_model(JTrainConfig(**ckw), n, jst.n_classes)
    levels = [jnp.zeros((4,), jnp.int32), jnp.zeros((16,), jnp.int32),
              jnp.zeros((48,), jnp.int32)]
    params = jmodel.init(jax.random.key(3), levels, jnp.asarray(jst.feats))
    tmodel = build_model(TrainConfig(**ckw), n, tst.n_classes, tst.feat_dim)
    load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    jgraph = jst.to_device(train=False, dtype=jnp.bfloat16 if jdt == "bfloat16" else jnp.float32,
                           quantize=True)
    tgraph = tst.to_device(train=False, dtype=tdt, device="cpu", quantize=True)
    ref = _np(jfg.embed_all_nodes(jmodel, params, jgraph, chunk=64, with_head=True))
    tol = (2.0 ** -8 if jdt == "bfloat16" else 1e-5) * np.abs(ref).max()
    out = tfg.embed_all_nodes(tmodel, tgraph, chunk=64, with_head=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol)
    if jdt == "bfloat16":
        return
    # the raw int8 + feat_scale layout dequantizes to the scales' f32 on both sides
    q, scale = tq.quantize_np(tst.feats)
    raw = DeviceGraph(adj=tgraph.adj, degrees=tgraph.degrees, feats=torch.from_numpy(q),
                      targets=tgraph.targets, feat_scale=torch.from_numpy(scale))
    jraw = jgraph.replace(feats=jnp.asarray(q), feat_scale=jnp.asarray(scale))
    ref = _np(jfg.embed_all_nodes(jmodel, params, jraw, chunk=64, with_head=True))
    out = tfg.embed_all_nodes(tmodel, raw, chunk=64, with_head=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_the_int8_table_is_uploaded_once_at_half_the_bytes():
    """The train-edge and full-edge graphs share one int8 table (cached per
    dtype, device and quantize), half the bf16 table's bytes plus the
    scales; dense and CSR graphs share it too."""
    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.data.synthetic import sbm_store

    problem = NodeProblem(sbm_store(n_nodes=200, n_classes=3, feat_dim=64, seed=2))
    graphs = [problem.device_graph(train=t, dtype=torch.bfloat16, device="cpu", csr=c,
                                   quantize=True) for t in (True, False) for c in (False, True)]
    assert all(g.feats is graphs[0].feats for g in graphs)
    dense = problem.device_graph(train=True, dtype=torch.bfloat16, device="cpu")
    assert graphs[0].feats.nbytes == dense.feats.numel() * 2 // 2 + 4 * 64
    assert graphs[0].feats.dtype == torch.bfloat16


def test_assortative_bench_store_is_bitwise_the_reference():
    from tpu_sage.data.synthetic import assortative_bench_store as j_store
    from tpu_sage_torch.data.synthetic import assortative_bench_store

    a, b = assortative_bench_store(n_nodes=2000, seed=3), j_store(n_nodes=2000, seed=3)
    for field in ("adj", "degrees", "train_adj", "train_degrees", "feats", "targets"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    for fold in ("train", "val", "test"):
        np.testing.assert_array_equal(a.folds[fold], b.folds[fold])
    assert a.feats.shape == (2000, 602) and a.n_classes == 41


def test_int8_kernel_source_notes_what_it_replaces_and_counts_only_launches():
    """The second entry point of ``csrc/gather_mean.cu`` names what it
    replaces and its bound, reports its launch error, and has its own
    counter, which the plain version on CPU tensors leaves at 0."""
    from tpu_sage_torch import kernels
    from tpu_sage_torch.kernels import _build

    text = open(_build.library_path("gather_mean")[0]).read()
    assert "tpu_sage/data/quantize.py::QuantizedFeats.fanout_mean" in text
    assert 'extern "C" int tsg_gather_fanout_mean_int8(' in text
    assert "Bound on the H100: bytes" in text and "cudaGetLastError()" in text
    kernels.reset_launch_counts()
    gather_fanout_mean_int8(torch.zeros(3, 2, dtype=torch.int8), torch.ones(2),
                            torch.zeros(4, dtype=torch.int32), 2, torch.bfloat16)
    assert kernels.launch_counts()["gather_fanout_mean_int8"] == 0
    assert kernels.COUNTERS["gather_fanout_mean_int8"] == "INT8_LAUNCHES"
