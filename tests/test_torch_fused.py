"""The fused first layer (``tpu_sage_torch/nn/fused.py::project_gather``,
``GSSupervised(fuse_first_layer=True)``) against the JAX package's, on
injected levels (mirroring ``tests/test_parity.py``'s fused test), and
against the port's own unfused path.

Tolerances: f32 logits within 1e-5 and gradients within 1e-4 (relative and
absolute), the parity tests' limits. bf16 is held against JAX's bf16 fused
model with the model tests' bf16 limits (logits within 6e-3 of their scale
plus one bf16 ulp of the element, gradients within 1.5e-2 of theirs): both
sides project the table in bf16, take the neighbor mean in f32 rounded once
to bf16, and hand back ``dW`` in the table's dtype, but the products sum in
other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sage.data.quantize import quantize_feats as j_quantize_feats
from tpu_sage.nn.fused import project_gather as j_project_gather
from tpu_sage.nn.model import GSSupervised as JGSSupervised
from tpu_sage.nn.model import default_layer_specs as j_specs
from tpu_sage_torch.data.quantize import quantize_feats
from tpu_sage_torch.nn.fused import project_gather
from tpu_sage_torch.nn.model import GSSupervised, default_layer_specs
from tpu_sage_torch.nn.params import flax_key, load_flax_params

N_NODES, D, N_CLASSES, B = 50, 16, 4, 6


def _levels(fanouts, seed=3):
    rng = np.random.default_rng(seed)
    sizes = [B]
    for f in fanouts:
        sizes.append(sizes[-1] * f)
    return [rng.integers(0, N_NODES, size=s).astype(np.int32) for s in sizes]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _models(fanouts, dtype, combine="concat", fuse=True, **kw):
    dims = (24,) * len(fanouts)
    common = dict(aggregator_class="mean", prep_class="identity", n_nodes=N_NODES,
                  combine=combine, **kw)
    jmodel = JGSSupervised(layer_specs=j_specs(fanouts=fanouts, output_dims=dims),
                           n_classes=N_CLASSES, dtype=dtype, fuse_first_layer=fuse, **common)
    tmodel = GSSupervised(default_layer_specs(fanouts=fanouts, output_dims=dims), N_CLASSES,
                          feat_dim=D, dtype=None if dtype is None else getattr(torch, dtype),
                          fuse_first_layer=fuse, **common)
    return jmodel, tmodel


def _loss_and_grads_both(fanouts, dtype, combine="concat"):
    """Logits and the gradients of sum(logits²), JAX fused against port fused,
    from the same flax parameters on the same feature table and levels."""
    rng = np.random.default_rng(10)
    feats = rng.normal(size=(N_NODES, D)).astype(np.float32)
    levels = _levels(fanouts)
    jmodel, tmodel = _models(fanouts, dtype, combine)
    jdt = jnp.bfloat16 if dtype else jnp.float32
    jfeats, jlevels = jnp.asarray(feats, jdt), [jnp.asarray(l) for l in levels]
    params = jmodel.init(jax.random.key(11), jlevels, jfeats)
    jlogits = np.asarray(jmodel.apply(params, jlevels, jfeats).astype(jnp.float32))
    jgrads = _flat(jax.grad(lambda p: jnp.sum(jnp.square(
        jmodel.apply(p, jlevels, jfeats).astype(jnp.float32))))(params))

    load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    tfeats = torch.from_numpy(feats).to(torch.bfloat16 if dtype else torch.float32)
    tlogits = tmodel([torch.from_numpy(l) for l in levels], tfeats)
    tlogits.float().square().sum().backward()
    tgrads = {flax_key(n): p.grad.numpy() for n, p in tmodel.named_parameters()}
    assert sorted(tgrads) == sorted(jgrads)
    return jlogits, tlogits.detach().float().numpy(), jgrads, tgrads


@pytest.mark.parametrize("fanouts,combine", [((5,), "concat"), ((5, 3), "concat"),
                                             ((4, 3, 2), "concat"), ((5, 3), "add")],
                         ids=["1layer", "2layers", "3layers", "2layers-add"])
def test_f32_fused_logits_and_grads_match_flax(fanouts, combine):
    jlogits, tlogits, jgrads, tgrads = _loss_and_grads_both(fanouts, None, combine)
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-5, atol=1e-5)
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k], jgrads[k], rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("fanouts", [(5, 3), (4, 3, 2)], ids=lambda f: f"{len(f)}layers")
def test_bf16_fused_logits_and_grads_within_bf16_tolerance(fanouts):
    """Logits within 6e-3 of their scale plus one bf16 ulp of the element
    (the logits are bf16: at these small logits, near 0.3, one ulp is 6.4e-3
    of the scale, as in ``tests/test_torch_quantize.py``), gradients within
    1.5e-2 of theirs."""
    jlogits, tlogits, jgrads, tgrads = _loss_and_grads_both(fanouts, "bfloat16")
    scale = np.abs(jlogits).max()
    np.testing.assert_allclose(tlogits, jlogits, rtol=2.0 ** -7, atol=6e-3 * scale)
    for k in jgrads:
        g = np.abs(jgrads[k]).max()
        np.testing.assert_allclose(tgrads[k], jgrads[k], rtol=0, atol=1.5e-2 * g, err_msg=k)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_fused_matches_the_ports_unfused_path(dtype):
    """Projection and fanout mean commute: the fused model gives the unfused
    model's logits and gradients (f32: 1e-5 / 1e-4; bf16: the bf16 limits
    above, as the two paths round the product at other places)."""
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(N_NODES, D)).astype(np.float32)
    levels = [torch.from_numpy(l) for l in _levels((5, 3), seed=8)]
    tdt = None if dtype is None else torch.bfloat16
    tfeats = torch.from_numpy(feats).to(tdt or torch.float32)
    outs = []
    for fuse in (False, True):
        _, model = _models((5, 3), dtype, fuse=fuse)
        model.reset_parameters(torch.Generator().manual_seed(2))
        logits = model(levels, tfeats)
        logits.float().square().sum().backward()
        outs.append((logits.detach().float().numpy(),
                     {n: p.grad.numpy() for n, p in model.named_parameters()}))
    (a, ga), (b, gb) = outs
    scale = np.abs(a).max()
    if dtype is None:
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(b, a, rtol=2.0 ** -7, atol=6e-3 * scale)
    for k in ga:
        tol = dict(rtol=1e-4, atol=1e-5) if dtype is None else \
            dict(rtol=0, atol=1.5e-2 * np.abs(ga[k]).max())
        np.testing.assert_allclose(gb[k], ga[k], err_msg=k, **tol)


def test_project_gather_against_the_reference_and_autograd():
    """f32: rows and fanout means equal JAX's ``project_gather`` followed by
    ``jnp.mean`` (within 1e-6), and ``dW`` equals JAX's custom VJP and plain
    autograd through ``(table @ w)[ids]`` (within 1e-5); the table gets no
    gradient."""
    rng = np.random.default_rng(1)
    table = rng.normal(size=(N_NODES, D)).astype(np.float32)
    w = rng.normal(size=(D, 8)).astype(np.float32)
    ids = [rng.integers(0, N_NODES, size=s).astype(np.int32) for s in (6, 30, 90)]
    fanouts = (1, 5, 3)
    cots = [rng.normal(size=(len(i) // f, 8)).astype(np.float32) for i, f in zip(ids, fanouts)]

    def jloss(wj):
        rows = j_project_gather(jnp.asarray(table), wj, [jnp.asarray(i) for i in ids])
        outs = [r if f == 1 else jnp.mean(r.reshape(-1, f, r.shape[-1]), axis=1)
                for r, f in zip(rows, fanouts)]
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, jouts), jdw = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(w))

    tt = torch.from_numpy(table).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    outs = project_gather(tt, tw, [torch.from_numpy(i) for i in ids], fanouts)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5, atol=1e-5)
    assert tt.grad is None

    aw = torch.from_numpy(w).requires_grad_()
    proj = torch.from_numpy(table) @ aw
    auto = [proj[torch.from_numpy(i).long()].view(-1, f, 8).mean(1) for i, f in zip(ids, fanouts)]
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(auto, cots)).backward()
    np.testing.assert_allclose(tw.grad.numpy(), aw.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_project_gather_bf16_rounds_where_the_reference_rounds():
    """bf16 table and W: JAX's rows (``jnp.dot`` in bf16) and fanout means
    (``jnp.mean``) within one bf16 ulp of each element (the product's sums
    run in another order, rarely flipping its last bit), and ``dW`` arrives
    in bf16, the table's dtype, within one bf16 ulp of JAX's plus 1e-3 of
    its scale."""
    rng = np.random.default_rng(2)
    table = jnp.asarray(rng.normal(size=(N_NODES, D)), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(D, 8)) / 4, jnp.bfloat16)
    ids = [rng.integers(0, N_NODES, size=s).astype(np.int32) for s in (6, 60)]
    fanouts = (1, 10)
    cots = [jnp.asarray(rng.normal(size=(len(i) // f, 8)), jnp.bfloat16)
            for i, f in zip(ids, fanouts)]

    def jouts(wj):
        rows = j_project_gather(table, wj, [jnp.asarray(i) for i in ids])
        return [r if f == 1 else jnp.mean(r.reshape(-1, f, r.shape[-1]), axis=1)
                for r, f in zip(rows, fanouts)]

    outs_j, vjp = jax.vjp(jouts, w)
    (jdw,) = vjp(cots)
    assert jdw.dtype == jnp.bfloat16

    f32 = lambda a: torch.from_numpy(np.asarray(jnp.asarray(a, jnp.float32)))  # noqa: E731
    tw = f32(w).bfloat16().requires_grad_()
    outs = project_gather(f32(table).bfloat16(), tw, [torch.from_numpy(i) for i in ids],
                          fanouts)
    torch.autograd.backward(outs, [f32(c).bfloat16() for c in cots])
    for o, jo in zip(outs, outs_j):
        assert o.dtype == torch.bfloat16
        ref = f32(jo).numpy()
        np.testing.assert_allclose(o.detach().float().numpy(), ref, rtol=2.0 ** -7, atol=0)
    assert tw.grad.dtype == torch.bfloat16
    ref = f32(jdw).numpy()
    np.testing.assert_allclose(tw.grad.float().numpy(), ref, rtol=2.0 ** -7,
                               atol=1e-3 * np.abs(ref).max())


def test_int8_table_raises_as_the_reference_does():
    """The reference's ``jnp.dot`` refuses its int8 ``QuantizedFeats``
    table with a ``TypeError``; so does the port's fused model."""
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(N_NODES, D)).astype(np.float32)
    levels = _levels((5, 3))
    jmodel, tmodel = _models((5, 3), "bfloat16")
    jlevels = [jnp.asarray(l) for l in levels]
    params = jmodel.init(jax.random.key(0), jlevels, jnp.asarray(feats, jnp.bfloat16))
    with pytest.raises(TypeError):
        jmodel.apply(params, jlevels, j_quantize_feats(feats))
    tmodel.reset_parameters(torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="dense feature table"):
        tmodel([torch.from_numpy(l) for l in levels], quantize_feats(feats, device="cpu"))


@pytest.mark.parametrize("kw", [dict(aggregator_class="gcn"), dict(prep_class="linear")],
                         ids=["gcn", "linear"])
def test_fusion_applies_only_to_mean_with_the_identity_prep(kw):
    """Outside the reference's conditions the flag changes nothing: the
    model runs its ordinary path, bitwise."""
    rng = np.random.default_rng(6)
    feats = torch.from_numpy(rng.normal(size=(N_NODES, D)).astype(np.float32))
    levels = [torch.from_numpy(l) for l in _levels((5, 3))]
    outs = []
    for fuse in (False, True):
        model = GSSupervised(default_layer_specs((5, 3), output_dims=(24, 24)), N_CLASSES,
                             feat_dim=D, fuse_first_layer=fuse, n_nodes=N_NODES,
                             embedding_dim=8, **kw)
        model.reset_parameters(torch.Generator().manual_seed(3))
        outs.append(model(levels, feats).detach())
    assert torch.equal(outs[0], outs[1])
