"""tpu_sage_torch preps against the JAX package's: the same ids and gathered
rows, the same flax parameters; outputs and parameter gradients of
``sum(out * g)``.

Tolerances: ``rtol=atol=1e-5`` on outputs and ``1e-4`` on gradients. Both
preps compute in f32 even for bf16 rows (flax's ``Dense(dtype=None)`` and
``jnp.concatenate`` promote a bf16 ``x`` against the f32 parameters), so
the bf16 cases keep the f32 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sage.nn import preps as jpreps
from tpu_sage_torch.nn import preps as tpreps
from tpu_sage_torch.nn.params import flax_key, flax_params, load_flax_params

N_NODES, D, EMB, Q = 30, 12, 8, 40


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,with_feats", [("linear", True), ("node_embedding", True),
                                             ("node_embedding", False)],
                         ids=["linear", "node_embedding", "node_embedding_no_feats"])
def test_prep_matches_flax(name, with_feats, dtype):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, N_NODES, size=Q).astype(np.int32)
    x = rng.normal(size=(Q, D)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                          torch.float32)
    jx = jnp.asarray(x, jdt) if with_feats else None
    jmod = jpreps.prep_lookup[name](n_nodes=N_NODES, embedding_dim=EMB)
    params = jmod.init(jax.random.key(2), jnp.asarray(ids), jx)
    jout = jmod.apply(params, jnp.asarray(ids), jx)
    g = rng.normal(size=jout.shape).astype(np.float32)
    jgrads = _flat(jax.grad(lambda p: jnp.sum(jmod.apply(p, jnp.asarray(ids), jx) * g))(params))

    tmod = tpreps.prep_lookup[name](D if with_feats else 0, n_nodes=N_NODES, embedding_dim=EMB)
    load_flax_params(tmod, jax.tree_util.tree_map(np.asarray, params))
    tx = torch.from_numpy(x).to(tdt) if with_feats else None
    tout = tmod(torch.from_numpy(ids), tx)
    assert tout.dtype == torch.float32 and jout.dtype == jnp.float32
    assert tuple(tout.shape) == tuple(jout.shape) and tout.shape[1] == tmod.out_dim()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    (tout * torch.from_numpy(g)).sum().backward()
    tgrads = {flax_key(n): p.grad.numpy() for n, p in tmod.named_parameters()}
    assert sorted(tgrads) == sorted(jgrads)
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k], jgrads[k], rtol=1e-4, atol=1e-4, err_msg=k)


def test_embedding_gradient_is_dense_and_repeats_accumulate():
    """Rows no id names get an explicit zero gradient (Adam's moments decay on
    them, as optax's do); a row named twice gets both cotangents."""
    tmod = tpreps.NodeEmbeddingPrep(0, n_nodes=5, embedding_dim=3)
    tmod.embedding.reset_parameters(torch.Generator().manual_seed(0))
    out = tmod(torch.tensor([1, 3, 1], dtype=torch.int32), None)
    out.sum().backward()
    grad = tmod.embedding.embedding.grad
    assert not grad.is_sparse
    torch.testing.assert_close(grad, torch.tensor([[0.0] * 3, [2.0] * 3, [0.0] * 3, [1.0] * 3,
                                                   [0.0] * 3]))


def test_fresh_init_statistics_and_keys():
    """The embedding table is a normal of std ``1/sqrt(dim)`` (0.1251 on a
    flax init for dim 64); the linear prep's kernel is lecun-normal; the keys
    are flax's."""
    from tpu_sage_torch.nn.model import GSSupervised, default_layer_specs

    specs = default_layer_specs(fanouts=(3, 2), output_dims=(16, 16))
    model = GSSupervised(specs, 4, feat_dim=100, prep_class="node_embedding", n_nodes=20_000,
                         embedding_dim=64)
    model.reset_parameters(torch.Generator().manual_seed(0))
    table = model.prep.embedding.embedding.detach().numpy()
    assert table.shape == (20_000, 64)
    assert abs(table.std() - 0.125) < 0.002 and abs(table.mean()) < 0.002
    assert np.abs(table).max() > 4 * 0.125  # untruncated
    assert model.agg_layers[0].fc_self.kernel.shape == (164, 16)
    assert "embedding" in flax_params(model)["params"]["prep"]

    model = GSSupervised(specs, 4, feat_dim=300, prep_class="linear", embedding_dim=64)
    model.reset_parameters(torch.Generator().manual_seed(1))
    k = model.prep.fc.kernel.detach().numpy()
    assert k.shape == (300, 64) and abs(k.var() * 300 - 1.0) < 0.03
    assert model.agg_layers[0].fc_self.kernel.shape == (64, 16)
    assert sorted(flax_params(model)["params"]["prep"]["fc"]) == ["kernel"]


@pytest.mark.parametrize("name", ["identity", "linear"])
def test_feature_preps_refuse_missing_features(name):
    with pytest.raises(ValueError, match="requires node features"):
        tpreps.prep_lookup[name](4, embedding_dim=3)(torch.zeros(2, dtype=torch.int32), None)
