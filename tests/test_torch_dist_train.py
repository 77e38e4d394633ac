"""The port's partitioned trainer (tpu_sage_torch/dist/train.py) at 4 gloo
ranks, and ``GSSupervised.forward_gathered`` against the JAX package's.

One group of ranks per module (tests/torch_dist_workers.py::train_checks)
runs one step on injected levels, ``fit_partitioned`` for mean and gcn, the
evaluations, every flat halo mode, CSR and int8 shards and the measured race;
each test holds one part of it against a single-device computation or the
JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dist_workers as W
from tpu_sage.nn.model import GSSupervised as JGSSupervised
from tpu_sage.nn.model import default_layer_specs as j_specs
from tpu_sage.train.losses import cross_entropy as j_cross_entropy
from tpu_sage_torch.dist.partition import pad_to_shards, shard_fold
from tpu_sage_torch.nn.full_graph import embed_all_nodes
from tpu_sage_torch.nn.model import GSSupervised, default_layer_specs
from tpu_sage_torch.nn.params import flax_key, load_flax_params
from tpu_sage_torch.train.losses import cross_entropy
from tpu_sage_torch.train.trainer import build_model, fold_metric_np

WORLD = 4


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    W.spawn_ranks(W.train_checks, WORLD, str(out))
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


# -- forward_gathered against the JAX package's ------------------------------

N, D, C, B, FANOUTS, DIMS = 40, 16, 7, 6, (5, 3), (24, 24)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("agg", ["mean", "gcn"])
def test_forward_gathered_matches_flax(agg, dtype):
    """Gathered rows with the deepest level pre-reduced to per-root means
    (``last_reduced_fanout``): logits and gradients as the single-device
    model tests hold them (f32 1e-5 / 1e-4; bf16 6e-3 / 1.5e-2 of scale),
    but gcn's bf16 logits within 1e-2 of scale: its summary
    ``(x + F·mean) / (F + 1)`` rounds to bf16 after each operation in
    PyTorch and once in XLA's fused chain (measured 9.0e-3, one logit of 42
    two bf16 steps apart; mean 5.4e-3; gradients 1.1e-2 and 1.2e-2)."""
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(N, D)).astype(np.float32)
    sizes = [B, B * FANOUTS[0], B * FANOUTS[0] * FANOUTS[1]]
    levels = [rng.integers(0, N, size=s).astype(np.int32) for s in sizes]
    targets = rng.integers(0, C, size=B).astype(np.int32)
    jdt = jnp.bfloat16 if dtype else jnp.float32
    rows = [feats[l] for l in levels[:-1]]
    rows.append(feats[levels[-1]].reshape(-1, FANOUTS[-1], D).mean(1))
    jrows = [jnp.asarray(r).astype(jdt) for r in rows]
    jlevels = [jnp.asarray(l) for l in levels]
    jmodel = JGSSupervised(layer_specs=j_specs(fanouts=FANOUTS, output_dims=DIMS), n_classes=C,
                           dtype=dtype, aggregator_class=agg)
    params = jmodel.init(jax.random.key(4), jlevels, jrows, FANOUTS[-1],
                         method=jmodel.forward_gathered)
    fwd = lambda p: jmodel.apply(p, jlevels, jrows, FANOUTS[-1],  # noqa: E731
                                 method=jmodel.forward_gathered)
    jlogits = np.asarray(fwd(params).astype(jnp.float32))
    jgrads = jax.grad(lambda p: j_cross_entropy(fwd(p), jnp.asarray(targets)))(params)
    jgrads = {k: np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]
              and _flat(jgrads).items()}

    tmodel = GSSupervised(default_layer_specs(fanouts=FANOUTS, output_dims=DIMS), C,
                          feat_dim=D, aggregator_class=agg,
                          dtype=None if dtype is None else torch.bfloat16)
    load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    trows = [torch.from_numpy(np.array(r.astype(jnp.float32))).to(
        torch.bfloat16 if dtype else torch.float32) for r in jrows]
    tlogits = tmodel.forward_gathered([torch.from_numpy(l) for l in levels], trows, FANOUTS[-1])
    cross_entropy(tlogits, torch.from_numpy(targets)).backward()
    tgrads = {flax_key(n): p.grad.numpy() for n, p in tmodel.named_parameters()}
    assert sorted(tgrads) == sorted(jgrads)
    ltol, gtol = (1e-5, 1e-4) if dtype is None else (6e-3 if agg == "mean" else 1e-2, 1.5e-2)
    scale = np.abs(jlogits).max() if dtype else 1.0
    np.testing.assert_allclose(tlogits.detach().float().numpy(), jlogits, rtol=0 if dtype else ltol,
                               atol=ltol * scale)
    for k in jgrads:
        g = np.abs(jgrads[k]).max() if dtype else 1.0
        np.testing.assert_allclose(tgrads[k], jgrads[k], rtol=0 if dtype else gtol,
                                   atol=gtol * g, err_msg=k)
    if agg == "gcn":  # gcn's reduce spans self: the flag changes the value
        other = tmodel.forward_gathered([torch.from_numpy(l) for l in levels], trows)
        assert not torch.allclose(other, tlogits)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


# -- one step against the single device ----------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("agg", ["mean", "gcn"])
def test_one_partitioned_step_matches_the_single_device_loss(port, agg, dtype):
    """4 ranks, each with its own injected tree: the summed loss and the
    all-reduced gradients equal Σ_r (w_r / Σw) · loss_r of the single-device
    model on the same trees (features gathered from the whole table, the
    deepest mean by one fused gather), from the same initial parameters;
    f32 within 1e-5 / 1e-4, bf16 within the single-device bf16 tests'
    6e-3 / 1.5e-2 of scale."""
    store = W.train_store()
    cfg = W.step_config(agg, dtype)
    model = build_model(cfg, store.n_nodes, store.n_classes, store.feat_dim)
    model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    m, _ = pad_to_shards(store.n_nodes, WORLD)
    _, fold_w = shard_fold(store.folds["train"], WORLD, m)
    key = f"step/{agg}/{dtype}"
    np.testing.assert_array_equal(port[0][key + "/fold_w"], fold_w)
    feats = torch.from_numpy(store.feats).to(getattr(torch, dtype))
    total = torch.zeros(())
    for r in range(WORLD):
        levels = W.step_levels(store, r, WORLD, m, cfg.batch_size // WORLD)
        logits = model([torch.from_numpy(l) for l in levels], feats)
        tgt = torch.from_numpy(store.targets[levels[0]])
        w = torch.tensor(fold_w[r]) / torch.tensor(fold_w.sum())
        total = total + cross_entropy(logits, tgt) * w.item()
    total.backward()
    ltol, gtol = (1e-5, 1e-4) if dtype == "float32" else (6e-3, 1.5e-2)
    for r in range(WORLD):
        np.testing.assert_allclose(float(port[r][key + "/loss"]), float(total.detach()), rtol=ltol)
        for name, p in model.named_parameters():
            got = port[r][f"{key}/grad/{flax_key(name)}"].numpy()
            want = p.grad.numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=gtol * np.abs(want).max(),
                                       err_msg=name)
            if r:  # the replicas hold the same all-reduced gradient, bitwise
                np.testing.assert_array_equal(got, port[0][f"{key}/grad/{flax_key(name)}"])


# -- training, evaluation, modes ---------------------------------------------

@pytest.mark.parametrize("agg", ["mean", "gcn"])
def test_fit_partitioned_converges_with_equal_replicas(port, agg):
    losses = port[0][f"fit/{agg}/losses"]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, losses
    fps = {port[r][f"fit/{agg}/fingerprint"] for r in range(WORLD)}
    assert len(fps) == 1, fps
    log = port[0][f"fit/{agg}/log"]
    assert log[0] == {"n_shards": WORLD, "halo": "exact"}
    assert all(port[r][f"fit/{agg}/log"] == [] for r in range(1, WORLD))  # rank 0 logs


def test_evaluate_counts_each_fold_node_once_and_exact_matches_single_device(port):
    store = W.train_store()
    stats = port[0]["eval/stats"]
    assert [int(port[r]["eval/stats"][1]) for r in range(WORLD)] == [len(store.folds["val"])] * 4
    assert float(stats[0]) == int(stats[0]) and port[0]["eval/metric"] == float(
        stats[0] / stats[1])
    assert 0.5 < port[0]["eval/metric"] <= 1.0

    cfg = W.step_config("mean", "float32", output_dims=(32, 32), n_train_samples=(5, 3),
                        n_val_samples=(5, 3))
    model = build_model(cfg, store.n_nodes, store.n_classes, store.feat_dim)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(port[0]["eval/state"][name])
    want = embed_all_nodes(model, store.to_device(train=False, device="cpu"), chunk=64,
                           with_head=True).numpy()
    for r in range(WORLD):
        got = port[r]["eval/logits"].numpy()
        assert got.shape[0] == pad_to_shards(store.n_nodes, WORLD)[1]
        np.testing.assert_allclose(got[:store.n_nodes], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        ids = store.folds["val"]
        assert port[r]["eval/exact"] == fold_metric_np(store.task, want[ids],
                                                       store.targets[ids])


@pytest.mark.parametrize("label", ["ring", "pipelined", "bucketed", "csr", "csr_int8_ring",
                                   "measured"])
def test_every_halo_mode_and_storage_trains(port, label):
    log = port[0][f"mode/{label}/log"]
    head, epochs = log[0], [r for r in log if "epoch" in r]
    losses = [r["train_loss"] for r in epochs]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert all(r["val_metric"] > 0.5 for r in epochs[-1:]), epochs
    assert "final_test_metric" in log[-1]
    assert head["n_shards"] == WORLD and head["halo"] == port[0][f"mode/{label}/halo"]
    if label == "bucketed":  # capacity factor 0.3: queries overflow, and the log says so
        assert all(r["halo_overflow"] > 0 for r in epochs)
    if label.startswith("csr"):
        assert head["csr_window"] > 0
    if label == "measured":
        assert sorted(head["halo_measured_ms"]) == ["exact", "pipelined", "ring"]
        assert head["halo"] in ("exact", "ring", "pipelined")
        assert {port[r]["mode/measured/halo"] for r in range(WORLD)} == {head["halo"]}


def test_ranks_draw_their_own_batches(port):
    batches = [port[r]["batches"].numpy() for r in range(WORLD)]
    for r, b in enumerate(batches):
        assert set(b.reshape(-1).tolist()) <= {r * 1000 + i for i in range(5)}
    assert len({tuple((b % 1000).reshape(-1)) for b in batches}) == WORLD
