"""tpu_sage_torch training against the JAX package's: losses, metrics and LR
schedules, Adam steps from identical params on injected levels, fit() on an
SBM store, and the TrainConfig presets."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_sage.data.synthetic import sbm_problem as j_sbm_problem
from tpu_sage.train import losses as jlosses
from tpu_sage.train import metrics as jmetrics
from tpu_sage.train import trainer as jtrainer
from tpu_sage.train.lr import LRSchedule as JLRSchedule
from tpu_sage_torch.data.synthetic import sbm_problem
from tpu_sage_torch.nn.params import load_flax_params
from tpu_sage_torch.train import losses, metrics, trainer
from tpu_sage_torch.train.lr import LRSchedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("task", sorted(losses.loss_lookup))
def test_losses_and_metrics_match_reference(task):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(32, 5)).astype(np.float32)
    if task == "classification":
        targets = rng.integers(0, 5, 32).astype(np.int32)
    elif task == "multilabel_classification":
        targets = (rng.random((32, 5)) < 0.3).astype(np.float32)
    else:
        targets = rng.normal(size=(32, 5)).astype(np.float32)
    tl, tt = torch.from_numpy(logits), torch.from_numpy(targets)
    jl, jt = jnp.asarray(logits), jnp.asarray(targets)
    np.testing.assert_allclose(float(losses.loss_lookup[task](tl, tt)),
                               float(jlosses.loss_lookup[task](jl, jt)), rtol=1e-6)
    np.testing.assert_allclose(float(metrics.metric_lookup[task](tl, tt)),
                               float(jmetrics.metric_lookup[task](jl, jt)), rtol=1e-6)


@pytest.mark.parametrize("name,kwargs", [
    ("constant", {}),
    ("linear", {"epochs": 4.0}),
    ("cyclical", {"lr_min": 0.001, "period": 1.5}),
    ("sgdr", {"lr_min": 0.001, "period": 2.0, "t_mult": 2.0}),
    ("sgdr", {"lr_min": 0.0, "period": 1.0, "t_mult": 1.0}),
])
def test_lr_schedules_match_reference(name, kwargs):
    ours = LRSchedule.lookup[name](lr_init=0.01, **kwargs)
    ref = JLRSchedule.lookup[name](lr_init=0.01, **kwargs)
    for p in np.linspace(0.0, 7.3, 23):
        np.testing.assert_allclose(ours(p), float(ref(p)), rtol=1e-6, atol=1e-9)


def _config(**kw):
    base = dict(batch_size=16, epochs=3, n_train_samples=(5, 3), n_val_samples=(5, 3),
                output_dims=(24, 24), lr_init=0.01, seed=3)
    base.update(kw)
    return base


@pytest.mark.parametrize("kw", [
    dict(),
    dict(weight_decay=1e-3),
    dict(lr_schedule="linear", weight_decay=1e-2),
    dict(optimizer="sgd", lr_init=0.5),
])
def test_steps_from_identical_params_match_reference(kw):
    """Per-step losses of 3 optimizer steps on injected levels, f32."""
    _steps_match_reference(kw)


@pytest.mark.parametrize("kw", [
    dict(aggregator_class="gcn"), dict(aggregator_class="max_pool"),
    dict(aggregator_class="mean_pool"), dict(aggregator_class="attention"),
    dict(aggregator_class="lstm"), dict(prep_class="linear"),
    dict(prep_class="node_embedding", weight_decay=1e-3),
], ids=["gcn", "max_pool", "mean_pool", "attention", "lstm", "linear", "node_embedding"])
def test_steps_of_every_aggregator_and_prep_match_reference(kw):
    """As above with the other modules (agg_hidden_dim 20, embedding_dim 8):
    Adam's moments move on every row of the node-embedding table, whose
    gradient is dense on both sides; the parameters after the steps agree too."""
    _steps_match_reference(dict(kw, agg_hidden_dim=20, embedding_dim=8), check_params=True)


def _steps_match_reference(kw, check_params=False):
    jp = j_sbm_problem(n_nodes=120, n_classes=4, feat_dim=16, seed=2)
    tp = sbm_problem(n_nodes=120, n_classes=4, feat_dim=16, seed=2)
    steps_per_epoch = 2
    jcfg = jtrainer.TrainConfig(**_config(**kw))
    tcfg = trainer.TrainConfig(**_config(**kw))
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(3):
        ids = rng.integers(0, 120, 16).astype(np.int32)
        batches.append([ids, rng.integers(0, 120, 80).astype(np.int32),
                        rng.integers(0, 120, 240).astype(np.int32)])

    jmodel = jtrainer.build_model(jcfg, jp.n_nodes, jp.n_classes)
    feats = jnp.asarray(jp.store.feats)
    params = jmodel.init(jax.random.key(0), [jnp.asarray(l) for l in batches[0]], feats)
    tx = jtrainer.build_optimizer(jcfg, steps_per_epoch)
    opt_state = tx.init(params)
    tree = jax.tree_util.tree_map(np.asarray, params)
    jlosses_ = []
    for lv in batches:
        lv = [jnp.asarray(l) for l in lv]
        targets = jnp.asarray(jp.store.targets[np.asarray(lv[0])], jnp.int32)
        loss, grads = jax.value_and_grad(
            lambda p: jlosses.cross_entropy(jmodel.apply(p, lv, feats), targets))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        jlosses_.append(float(loss))

    tmodel = trainer.build_model(tcfg, tp.n_nodes, tp.n_classes, tp.feats_dim)
    tr = trainer.Trainer(tmodel, tcfg, steps_per_epoch, task=tp.task)
    graph = tp.device_graph(train=True, device="cpu")
    state = tr.init_state(graph)
    load_flax_params(tmodel, tree)
    tlosses = []
    for lv in batches:
        lv = [torch.from_numpy(l) for l in lv]
        state, m = tr.train_step(state, graph, lv[0], graph.targets[lv[0].long()], levels=lv)
        tlosses.append(float(m["loss"]))
    assert state.step == 3
    np.testing.assert_allclose(tlosses, jlosses_, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]
    if check_params:
        from tpu_sage_torch.nn.params import flax_params

        got = jax.tree_util.tree_leaves_with_path(flax_params(tmodel))
        want = dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray,
                                                                                params)))
        assert len(got) == len(want)
        for path, value in got:
            ref = want[path]
            np.testing.assert_allclose(value, ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                       err_msg=jax.tree_util.keystr(path))


def test_fit_on_sbm_matches_reference_accuracy():
    """The SKILL.md CPU recipe: sbm 800 nodes / 5 classes, fanouts (10, 5),
    dims (64, 64), batch 64, 4 epochs."""
    kw = dict(n_train_samples=(10, 5), n_val_samples=(10, 5), output_dims=(64, 64),
              batch_size=64, epochs=4)
    notes = []
    _, state, hist = trainer.fit(sbm_problem(n_nodes=800, n_classes=5),
                                 trainer.TrainConfig(**kw), log=notes.append, device="cpu")
    _, _, jhist = jtrainer.fit(j_sbm_problem(n_nodes=800, n_classes=5),
                               jtrainer.TrainConfig(**kw), log=lambda d: None)
    assert len(hist) == 4 and state.step == 4 * (480 // 64)
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert abs(hist[-1]["val_metric"] - jhist[-1]["val_metric"]) <= 0.05
    assert "final_test_metric" in notes[-1]


def test_fit_bf16_and_patience_stop():
    kw = dict(n_train_samples=(5, 3), n_val_samples=(5, 3), output_dims=(16, 16),
              batch_size=64, epochs=6, compute_dtype="bfloat16", patience=1, lr_init=0.0)
    notes = []
    _, _, hist = trainer.fit(sbm_problem(n_nodes=300, n_classes=3, feat_dim=8),
                             trainer.TrainConfig(**kw), log=notes.append, device="cpu")
    # lr 0 never improves the val metric: the second epoch is stale and stops
    assert len(hist) == 2 and any(n.get("early_stop") for n in notes)
    assert np.isfinite(hist[0]["train_loss"])


def test_fit_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the refusal without one")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        trainer.fit(sbm_problem(n_nodes=100, n_classes=2, feat_dim=4),
                    trainer.TrainConfig(batch_size=8, epochs=1))


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.json"))),
                         ids=os.path.basename)
def test_config_presets_load_like_the_reference(path):
    import dataclasses

    ours = dataclasses.asdict(trainer.TrainConfig.from_json(path))
    ref = dataclasses.asdict(jtrainer.TrainConfig.from_json(path))
    assert ours == ref


def test_config_rejects_unknown_keys(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"aggregator_class": "mean", "batch_sise": 8}))
    with pytest.raises(ValueError, match="batch_sise"):
        trainer.TrainConfig.from_json(str(p))


def test_config_fields_match_reference():
    import dataclasses

    ours = {f.name: f.default for f in dataclasses.fields(trainer.TrainConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jtrainer.TrainConfig)}
    assert ours == ref


def test_fuse_first_layer_is_accepted_and_reaches_fit():
    """Refused until ROADMAP Queue 1 item 13 was ported: ``check_ported``
    accepts ``fuse_first_layer``, ``build_model`` passes it to the model,
    and ``fit`` trains the fused model (bf16) on an SBM store with a falling
    loss and the JAX package's val accuracy within 0.05."""
    kw = dict(fuse_first_layer=True, compute_dtype="bfloat16", batch_size=64, epochs=3,
              n_train_samples=(5, 3), n_val_samples=(5, 3), output_dims=(16, 16))
    config = trainer.TrainConfig(**kw)
    trainer.check_ported(config)
    assert trainer.build_model(config, 50, 3, 8).fuse_first_layer is True
    _, _, hist = trainer.fit(sbm_problem(n_nodes=400, n_classes=4, feat_dim=16, seed=3),
                             config, log=lambda d: None, device="cpu")
    _, _, jhist = jtrainer.fit(j_sbm_problem(n_nodes=400, n_classes=4, feat_dim=16, seed=3),
                               jtrainer.TrainConfig(**kw), log=lambda d: None)
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert abs(hist[-1]["val_metric"] - jhist[-1]["val_metric"]) <= 0.05


def test_feature_int8_is_accepted_and_reaches_fit():
    """Refused until ROADMAP Queue 1 item 10 was ported: ``check_ported``
    accepts ``feature_int8``, ``build_model`` passes ``int8_summean`` to the
    model, and ``fit`` trains on an int8 table (with CSR adjacency, bf16) on
    an SBM store with a falling loss; ``device="cuda"`` without a card still
    raises."""
    from tpu_sage_torch.data.quantize import QuantizedFeats

    config = trainer.TrainConfig(feature_int8=True, int8_summean=False,
                                 compute_dtype="bfloat16", batch_size=64, epochs=3,
                                 n_train_samples=(5, 3), n_val_samples=(5, 3),
                                 output_dims=(16, 16))
    trainer.check_ported(config)
    assert trainer.build_model(config, 50, 3, 8).int8_summean is False
    problem = sbm_problem(n_nodes=400, n_classes=4, feat_dim=16, seed=3)
    _, state, hist = trainer.fit(problem, config, log=lambda d: None, device="cpu", csr=True)
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    graph = problem.device_graph(train=True, dtype=torch.bfloat16, device="cpu", csr=True,
                                 quantize=True)
    assert isinstance(graph.feats, QuantizedFeats) and state.step == 3 * (240 // 64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            trainer.fit(problem, config, log=lambda d: None, device="cuda", csr=True)


@pytest.mark.parametrize("kw", [dict(aggregator_class=a) for a in
                                ("mean", "gcn", "max_pool", "mean_pool", "attention", "lstm")]
                         + [dict(prep_class=p) for p in ("identity", "linear", "node_embedding")],
                         ids=lambda kw: next(iter(kw.values())))
def test_check_ported_accepts_every_aggregator_and_prep(kw):
    config = trainer.TrainConfig(**kw)
    trainer.check_ported(config)
    model = trainer.build_model(config, 50, 3, 8)
    assert model.aggregator_class == config.aggregator_class
    assert model.prep_class == config.prep_class


def test_fit_lstm_exact_val_falls_back_to_sampled():
    """lstm is order-defined: exact validation falls back to the sampled one
    with the JAX package's note; a multilabel task trains through it."""
    kw = dict(aggregator_class="lstm", n_train_samples=(4, 3), n_val_samples=(4, 3),
              output_dims=(8, 8), agg_hidden_dim=8, batch_size=32, epochs=2, exact_val=True)
    notes = []
    _, _, hist = trainer.fit(sbm_problem(n_nodes=150, n_classes=4, feat_dim=8,
                                         task="multilabel_classification"),
                             trainer.TrainConfig(**kw), log=notes.append, device="cpu")
    assert any("falling back to sampled validation" in n.get("note", "") for n in notes)
    assert len(hist) == 2 and 0.0 <= hist[-1]["val_metric"] <= 1.0
    assert all(np.isfinite(h["train_loss"]) for h in hist)


def test_gcn_stays_at_chance_on_bench_store_in_both_packages():
    """On bench_store's uniform random neighbors gcn, which has no self
    branch, sees the root's own row at 1/26^2 weight through (25, 10)
    fanouts, and its loss stays at ln 41 in the JAX package as in the port,
    while mean, with its self branch, learns the same store. A reduced store
    (3,000 nodes, 64 features, 41 classes, max degree 128), batch 64, dims
    (32, 32), 3 epochs: the loss is within 0.02 of ln 41 and the val accuracy
    under 0.1 for gcn in both packages, the two gcn losses within 0.02 of each
    other (their samplers draw different neighbors); mean falls below
    ln 41 - 1 with val accuracy above 0.9 in both."""
    from tpu_sage.data.problem import NodeProblem as JNodeProblem
    from tpu_sage.data.synthetic import bench_store as j_bench_store
    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.data.synthetic import bench_store

    kw = dict(batch_size=64, n_train_samples=(25, 10), n_val_samples=(25, 10),
              output_dims=(32, 32), epochs=3, lr_init=0.01, seed=1)
    store = dict(n_nodes=3000, feat_dim=64, cache_dir="0")
    chance = np.log(41)
    for agg in ("gcn", "mean"):
        _, _, jhist = jtrainer.fit(JNodeProblem(j_bench_store(**store)),
                                   jtrainer.TrainConfig(aggregator_class=agg, **kw),
                                   log=lambda d: None)
        _, _, thist = trainer.fit(NodeProblem(bench_store(**store)),
                                  trainer.TrainConfig(aggregator_class=agg, **kw),
                                  log=lambda d: None, device="cpu")
        for hist in (jhist, thist):
            loss, val = hist[-1]["train_loss"], hist[-1]["val_metric"]
            if agg == "gcn":
                assert abs(loss - chance) < 0.02 and val < 0.1, (loss, val)
            else:
                assert loss < chance - 1 and val > 0.9, (loss, val)
        if agg == "gcn":
            np.testing.assert_allclose([h["train_loss"] for h in thist],
                                       [h["train_loss"] for h in jhist], rtol=0, atol=0.02)


def test_ppi_lstm_stays_at_zero_micro_f1_in_both_packages():
    """``configs/ppi_lstm.json`` (batch 64, 2 epochs) on a small multilabel
    SBM store of PPI's widths (400 nodes, 50 features, 121 labels, about 11 %
    positives): the micro-F1 stays 0 in the JAX package as in the port (every
    logit negative: all-negative is the early BCE optimum), while both
    losses fall and agree within 0.02 (their samplers draw different
    neighbors)."""
    from tpu_sage.data.problem import NodeProblem as JNodeProblem
    from tpu_sage.data.synthetic import sbm_store as j_sbm_store
    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.data.synthetic import sbm_store

    store = dict(n_nodes=400, feat_dim=50, n_classes=121, avg_degree=14, max_degree=64,
                 task="multilabel_classification", seed=6)
    preset = os.path.join(REPO, "configs", "ppi_lstm.json")
    over = dict(batch_size=64, epochs=2)
    _, _, jhist = jtrainer.fit(JNodeProblem(j_sbm_store(**store)),
                               jtrainer.TrainConfig.from_json(preset).replace(**over),
                               log=lambda d: None)
    _, _, thist = trainer.fit(NodeProblem(sbm_store(**store)),
                              trainer.TrainConfig.from_json(preset).replace(**over),
                              log=lambda d: None, device="cpu")
    print({"jax": [(h["train_loss"], h["val_metric"]) for h in jhist],
           "port": [(h["train_loss"], h["val_metric"]) for h in thist]})
    for hist in (jhist, thist):
        assert [h["val_metric"] for h in hist] == [0.0, 0.0]
        assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    np.testing.assert_allclose([h["train_loss"] for h in thist],
                               [h["train_loss"] for h in jhist], rtol=0, atol=0.02)
