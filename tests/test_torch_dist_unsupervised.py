"""The port's partitioned NCE (tpu_sage_torch/dist/unsupervised.py) at 4 gloo
ranks, against the single-device NCE step and walk of
tpu_sage_torch/train/unsupervised.py (which tests/test_torch_unsupervised.py
holds against the JAX package) and against the contracts of the JAX
package's tests/test_dist_unsupervised.py. One group of ranks
(tests/torch_dist_workers.py::nce_checks).

Tolerances: one step on injected trees, f32 loss rtol 1e-5 and gradients
1e-4 of scale, bf16 6e-3 / 1.5e-2 of scale (the supervised partitioned
step's, whose deepest level's means are summed over the owners in another
order); walks bitwise; χ² tests at p > 1e-3.
"""

import numpy as np
import pytest
import scipy.stats
import torch

from tests import torch_dist_workers as W
from tpu_sage.data.synthetic import sbm_store as j_sbm_store
from tpu_sage.dist.mesh import make_mesh
from tpu_sage.dist.unsupervised import PartitionedUnsupervisedTrainer as JTrainer
from tpu_sage.train.trainer import TrainConfig as JTrainConfig
from tpu_sage.train.unsupervised import UnsupConfig as JUnsupConfig
from tpu_sage_torch.data.synthetic import sbm_problem
from tpu_sage_torch.dist import mesh as tmesh
from tpu_sage_torch.dist.partition import pad_to_shards, shard_fold
from tpu_sage_torch.dist.unsupervised import draw_global_negatives, neg_logits
from tpu_sage_torch.nn.params import flax_key
from tpu_sage_torch.train.trainer import build_model, fit
from tpu_sage_torch.train.unsupervised import nce_loss, random_walk

WORLD = 4


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("nce")
    tmesh.spawn(W.nce_checks, WORLD, "cpu", (str(out),), store_dir=str(out))
    return out, [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_partitioned_nce_step_matches_the_single_device_step(port, dtype):
    """Each rank's injected tree over its anchors ‖ positives ‖ negatives:
    the summed loss and all-reduced gradients equal Σ_r (w_r / Σw) · the
    single-device NCE loss of the same trees and initial parameters."""
    _, ranks = port
    store = W.nce_store()
    cfg = W.nce_config(compute_dtype=dtype)
    model = build_model(cfg, store.n_nodes, max(store.n_classes, 2), store.feat_dim)
    model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    m, _ = pad_to_shards(store.n_nodes, WORLD)
    _, fold_w = shard_fold(store.folds["train"], WORLD, m)
    key = f"step/{dtype}"
    np.testing.assert_array_equal(ranks[0][key + "/fold_w"], fold_w)
    feats = torch.from_numpy(store.feats).to(getattr(torch, dtype))
    b, q = cfg.batch_size // WORLD, W.NCE_Q
    total = torch.zeros(())
    for r in range(WORLD):
        levels = [torch.from_numpy(lv) for lv in W.nce_levels(store, r, m, b)]
        z = model.encode(levels, feats)
        w = torch.tensor(fold_w[r]) / torch.tensor(fold_w.sum())
        total = total + nce_loss(z[:b], z[b:2 * b], z[2 * b:].reshape(b, q, -1)) * w.item()
    total.backward()
    ltol, gtol = (1e-5, 1e-4) if dtype == "float32" else (6e-3, 1.5e-2)
    for r in range(WORLD):
        np.testing.assert_allclose(float(ranks[r][key + "/loss"]), float(total.detach()),
                                   rtol=ltol)
        for name, p in model.named_parameters():
            got = ranks[r][f"{key}/grad/{flax_key(name)}"].numpy()
            want = p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape), np.float32)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=gtol * max(np.abs(want).max(), 1e-30), err_msg=name)


def test_walks_cross_shards_bitwise_the_single_device_walk(port):
    _, ranks = port
    store = W.nce_store()
    starts, us = W.walk_inputs(WORLD)
    adj, deg = torch.from_numpy(store.train_adj), torch.from_numpy(store.train_degrees)
    m, _ = pad_to_shards(store.n_nodes, WORLD)
    crossed = 0
    for r in range(WORLD):
        want = random_walk(adj, deg, torch.from_numpy(starts[r]), W.NCE_WALK,
                           us=[torch.from_numpy(u) for u in us[r]])
        got = ranks[r]["walk"]
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        crossed += int(((got.numpy() // m) != (starts[r] // m)).sum())
    assert crossed > 0


def test_negatives_stay_in_the_real_range_and_pass_chi2():
    """Uniform over [0, n_real) — never a partition padding id — and ∝
    max(deg, 1)^0.75 through the replicated logits, which are the JAX
    package's ``neg_logits``."""
    store = W.nce_store()
    m, padded = pad_to_shards(store.n_nodes, WORLD)
    assert padded > store.n_nodes
    gen = torch.Generator().manual_seed(0)
    draws = draw_global_negatives(200_000, store.n_nodes, None, gen, "cpu").numpy()
    assert draws.min() >= 0 and draws.max() < store.n_nodes
    counts = np.bincount(draws, minlength=store.n_nodes)
    assert scipy.stats.chisquare(counts).pvalue > 1e-3

    logits = neg_logits(store, 0.75, "cpu")
    jstore = j_sbm_store(n_nodes=W.NCE_NODES, n_classes=4, feat_dim=16, avg_degree=6, seed=6)
    jtr = JTrainer.from_store(jstore, JTrainConfig(batch_size=64, n_train_samples=(3, 2),
                                                   n_val_samples=(3, 2), output_dims=(8, 8)),
                              JUnsupConfig(neg_power=0.75), make_mesh(n_devices=WORLD))[0]
    np.testing.assert_array_equal(logits.numpy(), np.asarray(jtr.neg_logits(jstore)))
    draws = draw_global_negatives(200_000, store.n_nodes, logits, gen, "cpu").numpy()
    assert draws.max() < store.n_nodes
    p = np.maximum(store.degrees, 1).astype(np.float64) ** 0.75
    expected = p / p.sum() * len(draws)
    assert scipy.stats.chisquare(np.bincount(draws, minlength=store.n_nodes),
                                 expected).pvalue > 1e-3


def test_the_ranks_negatives_use_the_real_node_count(port):
    _, ranks = port
    for r in range(WORLD):
        assert ranks[r]["n_real"] == W.NCE_NODES
        assert int(ranks[r]["negatives"].max()) < W.NCE_NODES


def test_partitioned_nce_learns_and_its_probe_reaches_0_8_of_supervised(port):
    """The JAX test's gate: the probe on the partitioned embeddings reaches
    at least 0.8x the supervised val metric on the same SBM problem."""
    _, ranks = port
    hist = ranks[0]["fit/hist"]
    assert hist[-1]["unsup_loss"] < hist[0]["unsup_loss"]
    assert hist[-1]["n_shards"] == WORLD
    problem = sbm_problem(n_nodes=600, n_classes=4, feat_dim=32, avg_degree=8, p_in=0.95,
                          feat_noise=1.0, seed=11)
    cfg = W.step_config("mean", "float32", batch_size=128, epochs=3, n_train_samples=(8, 4),
                        n_val_samples=(8, 4), output_dims=(32, 32), lr_init=0.01)
    _, _, sup = fit(problem, cfg, log=lambda d: None, device="cpu")
    assert hist[-1]["probe_val_accuracy"] >= 0.8 * sup[-1]["val_metric"], (
        hist[-1], sup[-1])
    z = ranks[0]["fit/embed"]
    assert z.shape == (len(problem.folds["train"]), 64)  # concat: 2 x output_dim
    np.testing.assert_array_equal(z.numpy(), ranks[3]["fit/embed"].numpy())


def test_resume_starts_at_the_epoch_after_the_checkpoint(port):
    out, ranks = port
    first, second = ranks[0]["resume/2"], ranks[0]["resume/4"]
    assert any("checkpoint" in r for r in first)
    resumed = next(r for r in second if "resumed_from" in r)
    assert resumed["resumed_from"] == str(out / "u.npz") and resumed["start_epoch"] == 2
    assert [r["epoch"] for r in second if "epoch" in r] == [2, 3]
    assert all(ranks[r]["resume/4"] == [] for r in range(1, WORLD))  # rank 0 logs


@pytest.mark.parametrize("label", ["smoothed", "csr", "int8_csr", "measured", "hier2d"])
def test_every_mode_and_storage_trains(port, label):
    _, ranks = port
    log = ranks[0][f"mode/{label}/log"]
    head, epochs = log[0], [r for r in log if "epoch" in r]
    losses = [r["unsup_loss"] for r in epochs]
    assert np.isfinite(losses).all() and len(losses) == 2
    assert head["n_shards"] == WORLD and head["halo"] == ranks[0][f"mode/{label}/halo"]
    if label != "measured":
        assert losses[-1] < losses[0] * 1.05, losses
        assert np.isfinite(log[-1]["probe_val_accuracy"])
    if label == "smoothed":
        assert ranks[0]["mode/smoothed/neg_logits"].shape == (W.NCE_NODES,)
    if label.endswith("csr"):
        assert head["csr_window"] > 0
    if label == "measured":
        assert set(head["halo_measured_ms"]) == {"exact", "ring", "pipelined"}
        modes = head["halo_measured_ms"]
        # measure_halo_mode abstains to exact only when exact is within noise
        # of the best; a fallback note that keeps the measured best keeps it
        abstained = "using the auto default" in head.get("halo_measured_fallback", "")
        want = "exact" if abstained else min(modes, key=modes.get)
        assert head["halo"] == want
        assert {ranks[r]["mode/measured/halo"] for r in range(WORLD)} == {want}
    if label == "hier2d":  # fit builds the group's own (host, chip) layout
        assert head["halo"] == "hier2d" and head["layout"] == [1, WORLD]
