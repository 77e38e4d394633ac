"""tpu_sage_torch aggregators against the JAX package's, one module at a time.

Each aggregator gets the same numpy inputs ``x_self (B, D)``, ``x_neigh
(B, F, D)`` and the same flax parameters (``load_flax_params``); outputs and
parameter gradients of ``sum(out * g)`` must agree. Tolerances:

- f32: ``rtol=atol=1e-5`` on outputs, ``1e-4`` on gradients (summation
  order only).
- bf16 (inputs and compute in bf16, f32 params): outputs within 6e-3 of
  their scale and gradients within 1.5e-2 of theirs, as the whole model's
  bf16 test: the two frameworks round at different places (XLA on the CPU
  may keep an elementwise chain in f32 where PyTorch rounds every op).
  Two bf16 effects are not the port's error and are treated so:

  * an output whose pre-activation lies within bf16 rounding of 0 can fall
    on either side of the ReLU, and then its cotangent reaches the
    parameters on one side only (one such element moves a bias gradient by
    a whole ``g`` entry). The cotangent is zeroed where the two outputs'
    ReLU masks disagree; such elements must be few (at most 2 %) and
    within 1e-2 of the output scale of 0 on the side where they are positive.
  * where JAX's own bf16 gradient is further than the tolerance from its f32
    gradient (XLA sums the pool MLP's bias gradient over the B·F rows in
    bf16: 2.9 % off here; PyTorch sums in f32), the port's must be at least
    as close to that f32 gradient as JAX's is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sage.nn import aggregators as jagg
from tpu_sage_torch.nn import aggregators as tagg
from tpu_sage_torch.nn.dense import lecun_normal_, orthogonal_
from tpu_sage_torch.nn.params import flax_key, load_flax_params

B, F, D, OUT, HID = 6, 25, 16, 12, 20
NEW = ["gcn", "max_pool", "mean_pool", "attention", "lstm"]
TOL = {"float32": (1e-5, 1e-4),  # rtol = atol
       "bfloat16": (6e-3, 1.5e-2)}  # a share of each one's max |value|


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x_self = rng.normal(size=(B, D)).astype(np.float32)
    x_neigh = rng.normal(size=(B, F, D)).astype(np.float32)
    g = rng.normal(size=(B, 2 * OUT)).astype(np.float32)
    return x_self, x_neigh, g


def _run_both(name, dtype, combine):
    """Outputs and parameter gradients of both sides, and a function giving
    the JAX side's f32 gradients with the same parameters (the bf16 runs'
    yardstick)."""
    x_self, x_neigh, g = _inputs()
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jmods = {dt: jagg.aggregator_lookup[name](output_dim=OUT, combine=combine, hidden_dim=HID,
                                              dtype=None if dt == jnp.float32 else dt)
             for dt in {jdt, jnp.float32}}
    tmod = tagg.aggregator_lookup[name](D, OUT, combine=combine, hidden_dim=HID,
                                        dtype=None if dtype == "float32" else tdt)
    params = jmods[jdt].init(jax.random.key(1), jnp.asarray(x_self), jnp.asarray(x_neigh))

    def jax_fn(dt):
        js, jn = jnp.asarray(x_self, dt), jnp.asarray(x_neigh, dt)
        return lambda p: jmods[dt].apply(p, js, jn).astype(jnp.float32)

    jout, jvjp = jax.vjp(jax_fn(jdt), params)
    load_flax_params(tmod, jax.tree_util.tree_map(np.asarray, params))
    tout = tmod(torch.from_numpy(x_self).to(tdt), torch.from_numpy(x_neigh).to(tdt))
    assert tout.dtype == tdt and tuple(tout.shape) == tuple(jout.shape)
    jout = np.asarray(jout)
    tout_np = tout.detach().float().numpy()
    g = g[:, :jout.shape[1]]
    flipped = (jout > 0) != (tout_np > 0)
    if tmod.activation is not None and flipped.any():
        assert dtype == "bfloat16" and flipped.mean() <= 0.02
        assert np.maximum(jout, tout_np)[flipped].max() <= 1e-2 * np.abs(jout).max()
        g = np.where(flipped, 0.0, g).astype(np.float32)
    jgrads = _flat(jvjp(jnp.asarray(g))[0])

    def jgrads32():
        return _flat(jax.vjp(jax_fn(jnp.float32), params)[1](jnp.asarray(g))[0])

    (tout.float() * torch.from_numpy(g)).sum().backward()
    tgrads = {flax_key(n): p.grad.numpy() for n, p in tmod.named_parameters()}
    assert sorted(tgrads) == sorted(jgrads)
    return jout, tout_np, jgrads, tgrads, jgrads32


CASES = [(n, c) for n in NEW for c in (["concat"] if n == "gcn" else ["concat", "add"])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,combine", CASES)
def test_aggregator_matches_flax(name, combine, dtype):
    jout, tout, jgrads, tgrads, jgrads32 = _run_both(name, dtype, combine)
    out_tol, grad_tol = TOL[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(tout, jout, rtol=out_tol, atol=out_tol)
        for k in jgrads:
            np.testing.assert_allclose(tgrads[k], jgrads[k], rtol=grad_tol, atol=grad_tol,
                                       err_msg=k)
        return
    np.testing.assert_allclose(tout, jout, rtol=0, atol=out_tol * np.abs(jout).max())
    grads32 = None
    for k in jgrads:
        limit = grad_tol * np.abs(jgrads[k]).max()
        if np.abs(tgrads[k] - jgrads[k]).max() <= limit:
            continue
        grads32 = grads32 or jgrads32()
        jax_off = np.abs(jgrads[k] - grads32[k]).max()
        assert jax_off > limit, k
        assert np.abs(tgrads[k] - grads32[k]).max() <= jax_off, k


@pytest.mark.parametrize("name", NEW)
def test_combine_from_summary_equals_the_unreduced_call(name):
    """The deepest pairing finishes from ``neigh_summary``; for gcn the
    neighbor mean re-enters with weight ``fanout`` (its reduce spans self):
    ``(x + F·mean(N)) / (F + 1) == mean(self ∪ N)``, held here against a
    direct mean over the ``F + 1`` rows too."""
    x_self, x_neigh, _ = _inputs(3)
    mod = tagg.aggregator_lookup[name](D, OUT, hidden_dim=HID)
    for m in mod.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(torch.Generator().manual_seed(2))
    xs, xn = torch.from_numpy(x_self), torch.from_numpy(x_neigh)
    with torch.no_grad():
        summary = mod.neigh_summary(xs, xn)
        got = mod.combine_from_summary(xs, summary, F)
        torch.testing.assert_close(got, mod(xs, xn), rtol=0, atol=0)
        if name == "gcn":
            both = torch.cat([xs[:, None], xn], dim=1).mean(dim=1)
            torch.testing.assert_close(got, torch.relu(mod.fc(both)), rtol=1e-6, atol=1e-6)


def test_out_dim_and_the_model_width_chain():
    """gcn keeps ``output_dim``; the two-branch aggregators double it under
    concat; the model's next layer and head take what ``out_dim`` says."""
    from tpu_sage_torch.nn.model import GSSupervised, default_layer_specs

    specs = default_layer_specs(fanouts=(3, 2), output_dims=(12, 8))
    for name, widths in (("gcn", (12, 8)), ("max_pool", (24, 16)), ("lstm", (24, 16))):
        model = GSSupervised(specs, 5, feat_dim=D, aggregator_class=name, agg_hidden_dim=HID)
        assert tuple(a.out_dim() for a in model.agg_layers) == widths
        assert model.fc.kernel.shape == (widths[-1], 5)
    add = tagg.MaxPoolAggregator(D, OUT, combine="add", hidden_dim=HID)
    assert add.out_dim() == OUT and add.fc_neigh.kernel.shape == (HID, OUT)


def test_fresh_init_statistics():
    """flax's initialisers: lecun-normal kernels (``mlp``, ``att_*``,
    ``lstm/xz``), zero biases, an orthogonal ``lstm/cell/hz`` whose rows are
    orthonormal (``hz @ hz.T = I``, as a flax init gives to 6e-7)."""
    from tpu_sage_torch.nn.model import GSSupervised, default_layer_specs

    gen = torch.Generator().manual_seed(0)
    specs = default_layer_specs(fanouts=(3, 2), output_dims=(64, 64))
    for name in ("max_pool", "attention", "lstm"):
        model = GSSupervised(specs, 5, feat_dim=300, aggregator_class=name, agg_hidden_dim=128)
        with torch.no_grad():
            for p in model.parameters():
                p.fill_(float("nan"))
        model.reset_parameters(gen)  # reaches every parameter
        assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
        agg = model.agg_layers[0]
        for path in {"max_pool": ["mlp"], "attention": ["att_q", "att_k"],
                     "lstm": ["lstm.xz"]}[name]:
            k = agg.get_submodule(path).kernel.detach().numpy()
            assert abs(k.var() * 300 - 1.0) < 0.03, (name, k.var() * 300)
            assert np.abs(k).max() <= 2.0 * np.sqrt(1 / 300) / 0.87962566103423978 + 1e-6
        for n, p in model.named_parameters():
            if n.endswith("bias"):
                assert torch.equal(p, torch.zeros_like(p)), n
        if name == "lstm":
            for layer in model.agg_layers:
                hz = layer.lstm.cell.hz.kernel.detach().double()
                assert hz.shape == (128, 512)
                torch.testing.assert_close(hz @ hz.T, torch.eye(128, dtype=torch.float64),
                                           rtol=0, atol=2e-6)


def test_orthogonal_init_of_tall_and_wide_kernels():
    gen = torch.Generator().manual_seed(4)
    wide = orthogonal_(torch.empty(8, 32), gen).double()
    tall = orthogonal_(torch.empty(32, 8), gen).double()
    torch.testing.assert_close(wide @ wide.T, torch.eye(8, dtype=torch.float64), rtol=0, atol=1e-6)
    torch.testing.assert_close(tall.T @ tall, torch.eye(8, dtype=torch.float64), rtol=0, atol=1e-6)
    assert lecun_normal_(torch.empty(4, 4), gen).abs().max() > 0
