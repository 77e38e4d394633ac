"""tpu_sage_torch checkpoints: save/restore roundtrip and resume (mirroring
``tests/test_checkpoint.py``), and files that cross between the port and the
JAX package both ways, for Adam with and without weight decay and for SGD.

Tolerances: a checkpoint restores bitwise; after a crossing, one more
optimizer step on injected levels gives parameters within 1e-5 of the
parameter's scale on the two sides (f32; the steps' gradients differ in f32
rounding only); a resumed run equals a straight one bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_sage.data.synthetic import sbm_problem as j_sbm_problem
from tpu_sage.train import checkpoint as jck
from tpu_sage.train import trainer as jtrainer
from tpu_sage.train.losses import cross_entropy as j_cross_entropy
from tpu_sage_torch.data.synthetic import sbm_problem
from tpu_sage_torch.nn.params import flax_key, load_flax_params
from tpu_sage_torch.train import checkpoint as tck
from tpu_sage_torch.train import trainer


def _setup():
    problem = sbm_problem(n_nodes=300, n_classes=3, feat_dim=16, seed=21)
    cfg = trainer.TrainConfig(batch_size=32, epochs=1, n_train_samples=(5, 3),
                              n_val_samples=(5, 3), output_dims=(32, 32))
    return problem, cfg


def _trainer(problem, cfg, steps_per_epoch=5):
    model = trainer.build_model(cfg, problem.n_nodes, problem.n_classes, problem.feats_dim)
    tr = trainer.Trainer(model, cfg, steps_per_epoch=steps_per_epoch, task=problem.task)
    graph = problem.device_graph(train=True, device="cpu")
    return tr, graph, tr.init_state(graph)


def _params(model):
    return {flax_key(n): p.detach().numpy().copy() for n, p in model.named_parameters()}


def _moments(state):
    return {flax_key(n) + "/" + k: state.optimizer.state[p][k].numpy().copy()
            for n, p in state.model.named_parameters() for k in ("exp_avg", "exp_avg_sq")}


def test_roundtrip_bitexact(tmp_path):
    problem, cfg = _setup()
    tr, graph, state = _trainer(problem, cfg)
    ids = torch.as_tensor(problem.folds["train"][:32], dtype=torch.int32)
    state, _ = tr.train_step(state, graph, ids, graph.targets[ids.long()])

    path = str(tmp_path / "ck.npz")
    tck.save_checkpoint(path, state)
    tr2, _, template = _trainer(problem, cfg)
    restored = tck.load_checkpoint(path, template)

    assert restored.step == state.step == 1
    a, b = _params(state.model), _params(restored.model)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # optimizer state and the sampling generator restored: the next step,
    # sampled from each state's own generator, is identical
    _, m1 = tr.train_step(state, graph, ids, graph.targets[ids.long()])
    _, m2 = tr2.train_step(restored, graph, ids, graph.targets[ids.long()])
    assert float(m1["loss"]) == float(m2["loss"])
    a, b = _params(state.model), _params(restored.model)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_resume_continues_progress(tmp_path):
    problem, cfg = _setup()
    cfg = cfg.replace(epochs=2)
    path = str(tmp_path / "resume.npz")

    _, state1, hist1 = trainer.fit(problem, cfg, log=lambda d: None, eval_every_epoch=False,
                                   device="cpu")
    tck.save_checkpoint(path, state1)
    # the same command resumes at the epoch after the checkpoint: nothing left
    _, state2, hist2 = trainer.fit(problem, cfg, log=lambda d: None, eval_every_epoch=False,
                                   resume_from=path, device="cpu")
    assert state2.step == state1.step and hist2 == []
    # a longer run continues from epoch 2 and keeps improving
    _, state3, hist3 = trainer.fit(problem, cfg.replace(epochs=4), log=lambda d: None,
                                   eval_every_epoch=False, resume_from=path, device="cpu")
    assert state3.step == 2 * state1.step
    assert hist3[0]["epoch"] == 2
    assert hist3[0]["train_loss"] < hist1[0]["train_loss"]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    problem, cfg = _setup()
    _, _, state = _trainer(problem, cfg)
    path = str(tmp_path / "ck.npz")
    tck.save_checkpoint(path, state)
    _, _, template = _trainer(problem, cfg.replace(output_dims=(64, 64)))
    with pytest.raises(ValueError, match="mismatch"):
        tck.load_checkpoint(path, template)


def test_resumed_save_best_does_not_clobber_best(tmp_path):
    """A resumed save_best run compares against the metric the best file
    holds: a worse epoch after resume does not overwrite it."""
    problem = sbm_problem(n_nodes=120, n_classes=3, feat_dim=8, seed=71)
    cfg = trainer.TrainConfig(batch_size=32, epochs=1, n_train_samples=(3, 2),
                              n_val_samples=(3, 2), output_dims=(8, 8), save_best=True)
    _, _, state = _trainer(problem, cfg, steps_per_epoch=1)

    ck = str(tmp_path / "best.npz")
    recs = []
    t1 = tck.BestTracker(cfg, ck, recs.append)
    t1.update(0.95, state)                      # best written at step 0
    assert tck.read_best_metric(ck) == 0.95
    best_step = tck.checkpoint_step(ck)

    t2 = tck.BestTracker(cfg, ck, recs.append)  # "resume": seeded from the file
    assert t2.best == 0.95
    state2 = dataclasses.replace(state, step=state.step + 7)
    t2.update(0.80, state2)                      # worse: must not write
    assert tck.read_best_metric(ck) == 0.95
    assert tck.checkpoint_step(ck) == best_step
    t2.update(0.97, state2)                      # better: must write
    assert tck.read_best_metric(ck) == 0.97
    assert tck.checkpoint_step(ck) == best_step + 7


@pytest.mark.parametrize("kw", [
    dict(),
    dict(val_interval_batches=2, config=dict(exact_val=True, save_best=True)),
], ids=["plain", "val_interval_exact_save_best"])
def test_resume_is_exact(tmp_path, kw):
    """3 epochs straight equal 2 epochs, a checkpoint and a resumed third,
    bitwise in every parameter and Adam moment."""
    problem = sbm_problem(n_nodes=200, n_classes=3, feat_dim=8, seed=5)
    cfg = trainer.TrainConfig(batch_size=16, epochs=3, n_train_samples=(4, 3),
                              n_val_samples=(4, 3), output_dims=(16, 16),
                              **kw.get("config", {}))
    extra = {k: v for k, v in kw.items() if k != "config"}
    quiet = lambda d: None  # noqa: E731
    _, straight, _ = trainer.fit(problem, cfg, log=quiet, device="cpu",
                                 resume_from=str(tmp_path / "a.npz"), **extra)
    path = str(tmp_path / "b.npz")
    trainer.fit(problem, cfg.replace(epochs=2), log=quiet, device="cpu", resume_from=path,
                checkpoint_every=1, **extra)
    notes = []
    _, resumed, hist = trainer.fit(problem, cfg, log=notes.append, device="cpu",
                                   resume_from=path, **extra)
    assert any("resumed_from" in n for n in notes) and hist[0]["epoch"] == 2
    assert resumed.step == straight.step
    for got, want in ((_params(resumed.model), _params(straight.model)),
                      (_moments(resumed), _moments(straight))):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_missing_checkpoint_is_a_clean_error(tmp_path):
    problem, cfg = _setup()
    _, _, template = _trainer(problem, cfg)
    missing = str(tmp_path / "nope.npz")
    for call in (lambda: tck.load_checkpoint(missing, template),
                 lambda: tck.read_checkpoint_config(missing)):
        with pytest.raises(SystemExit, match="checkpoint not found"):
            call()


# -- crossing between the packages -------------------------------------------

N_NODES, B = 120, 16
OPTIMIZERS = [dict(), dict(weight_decay=1e-3), dict(optimizer="sgd", lr_init=0.5)]
OPT_IDS = ["adam", "adam_weight_decay", "sgd"]


def _cfg_kw(kw):
    base = dict(batch_size=B, epochs=3, n_train_samples=(5, 3), n_val_samples=(5, 3),
                output_dims=(24, 24), lr_init=0.01, seed=3)
    base.update(kw)
    return base


def _batches():
    rng = np.random.default_rng(7)
    return [[rng.integers(0, N_NODES, s).astype(np.int32) for s in (B, B * 5, B * 15)]
            for _ in range(3)]


class _Jax:
    """The JAX package's side: params, optax state and injected-level steps."""

    def __init__(self, kw):
        self.problem = j_sbm_problem(n_nodes=N_NODES, n_classes=4, feat_dim=16, seed=2)
        self.cfg = jtrainer.TrainConfig(**_cfg_kw(kw))
        self.model = jtrainer.build_model(self.cfg, N_NODES, self.problem.n_classes)
        self.feats = jnp.asarray(self.problem.store.feats)
        self.tx = jtrainer.build_optimizer(self.cfg, steps_per_epoch=2)
        levels = [jnp.asarray(l) for l in _batches()[0]]
        self.params = self.model.init(jax.random.key(0), levels, self.feats)
        self.opt_state = self.tx.init(self.params)
        self.step = 0

    def state(self):
        return jtrainer.TrainState(params=self.params, opt_state=self.opt_state,
                                   step=jnp.int32(self.step), key=jax.random.key(9))

    def train(self, batch):
        lv = [jnp.asarray(l) for l in batch]
        targets = jnp.asarray(self.problem.store.targets[batch[0]], jnp.int32)
        grads = jax.grad(lambda p: j_cross_entropy(
            self.model.apply(p, lv, self.feats), targets))(self.params)
        updates, self.opt_state = self.tx.update(grads, self.opt_state, self.params)
        self.params = optax.apply_updates(self.params, updates)
        self.step += 1

    def flat_params(self):
        flat = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(self.params)[0]:
            flat["/".join(str(p.key) for p in path)] = np.asarray(leaf)
        return flat


def _torch_side(kw):
    problem = sbm_problem(n_nodes=N_NODES, n_classes=4, feat_dim=16, seed=2)
    cfg = trainer.TrainConfig(**_cfg_kw(kw))
    model = trainer.build_model(cfg, N_NODES, problem.n_classes, problem.feats_dim)
    tr = trainer.Trainer(model, cfg, steps_per_epoch=2, task=problem.task)
    graph = problem.device_graph(train=True, device="cpu")
    return tr, graph, tr.init_state(graph)


def _torch_train(tr, graph, state, batch):
    lv = [torch.from_numpy(l) for l in batch]
    state, _ = tr.train_step(state, graph, lv[0], graph.targets[lv[0].long()], levels=lv)
    return state


def _assert_params_close(port_model, jax_side, rtol=1e-5):
    got, want = _params(port_model), jax_side.flat_params()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=rtol * np.abs(want[k]).max(), err_msg=k)


@pytest.mark.parametrize("kw", OPTIMIZERS, ids=OPT_IDS)
def test_jax_checkpoint_loads_into_the_port(tmp_path, kw):
    batches = _batches()
    j = _Jax(kw)
    for b in batches[:2]:
        j.train(b)
    path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path, j.state(), config=j.cfg)

    tr, graph, template = _torch_side(kw)
    state = tck.load_checkpoint(path, template)
    assert state.step == 2
    _assert_params_close(state.model, j, rtol=0)  # restored bitwise
    # no stored generator state: reseeded from the file's key
    hi, lo = (int(x) for x in jax.random.key_data(jax.random.key(9)))
    assert state.generator.initial_seed() == (hi << 32) | lo
    j.train(batches[2])
    state = _torch_train(tr, graph, state, batches[2])
    _assert_params_close(state.model, j)
    # the other side's __config__ reads back as the same TrainConfig
    stored = tck.read_checkpoint_config(path)
    assert dataclasses.asdict(trainer.TrainConfig.from_dict(stored)) == \
        dataclasses.asdict(trainer.TrainConfig(**_cfg_kw(kw)))


@pytest.mark.parametrize("kw", OPTIMIZERS, ids=OPT_IDS)
def test_port_checkpoint_loads_into_jax(tmp_path, kw):
    batches = _batches()
    j = _Jax(kw)
    tr, graph, state = _torch_side(kw)
    load_flax_params(state.model, jax.tree_util.tree_map(np.asarray, j.params))
    for b in batches[:2]:
        state = _torch_train(tr, graph, state, b)
    path = str(tmp_path / "port.npz")
    tck.save_checkpoint(path, state, config=tr.config)

    restored = jck.load_checkpoint(path, j.state())  # a fresh JAX template
    assert int(restored.step) == 2
    j.params, j.opt_state, j.step = restored.params, restored.opt_state, 2
    _assert_params_close(state.model, j, rtol=0)
    j.train(batches[2])
    state = _torch_train(tr, graph, state, batches[2])
    _assert_params_close(state.model, j)
    stored = jck.read_checkpoint_config(path)
    assert dataclasses.asdict(jtrainer.TrainConfig.from_dict(stored)) == \
        dataclasses.asdict(jtrainer.TrainConfig(**_cfg_kw(kw)))


@pytest.mark.parametrize("kw", OPTIMIZERS, ids=OPT_IDS)
def test_checkpoint_keys_match_the_jax_layout(tmp_path, kw):
    """Every key the JAX package writes, with its shape and dtype kind, and
    one more for the port's generator."""
    j = _Jax(kw)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_checkpoint(jpath, j.state(), config=j.cfg, best_metric=0.5)
    _, _, state = _torch_side(kw)
    tck.save_checkpoint(tpath, state, config=trainer.TrainConfig(**_cfg_kw(kw)),
                        best_metric=0.5)
    with np.load(jpath) as jz, np.load(tpath) as tz:
        want = {k: (jz[k].shape, jz[k].dtype.kind) for k in jz.files}
        got = {k: (tz[k].shape, tz[k].dtype.kind) for k in tz.files
               if not k.startswith("__torch_generator_")}
        assert got == want
        assert "__torch_generator_cpu__" in tz.files


# -- the other aggregators' and preps' trees ----------------------------------

TREES = [dict(aggregator_class="max_pool", agg_hidden_dim=20),
         dict(aggregator_class="lstm", prep_class="linear", agg_hidden_dim=12, embedding_dim=8)]
TREE_IDS = ["max_pool", "lstm_linear"]


@pytest.mark.parametrize("kw", TREES, ids=TREE_IDS)
def test_new_tree_port_checkpoint_loads_into_jax(tmp_path, kw):
    """The port's file of a max_pool tree and of an lstm + linear tree (the
    pool's ``mlp``, the LSTM's ``lstm/xz`` and ``lstm/cell/hz``, the prep's
    ``prep/fc``) loads into the JAX package, Adam moments included: after it,
    one more step on each side gives the same parameters."""
    test_port_checkpoint_loads_into_jax(tmp_path, kw)
    with np.load(str(tmp_path / "port.npz")) as z:
        names = set(z.files)
    want = {"max_pool": ["params/params/agg_layers_0/mlp/bias",
                         "opt_state/0/mu/params/agg_layers_1/mlp/kernel"],
            "lstm": ["params/params/agg_layers_0/lstm/cell/hz/kernel",
                     "opt_state/0/nu/params/agg_layers_1/lstm/xz/kernel",
                     "opt_state/0/mu/params/prep/fc/kernel"]}[kw["aggregator_class"]]
    assert set(want) <= names


@pytest.mark.parametrize("kw", TREES, ids=TREE_IDS)
def test_new_tree_jax_checkpoint_loads_into_the_port(tmp_path, kw):
    """The reverse: the JAX package's file loads into the port, whose Adam
    state then holds the file's moments bitwise."""
    test_jax_checkpoint_loads_into_the_port(tmp_path, kw)
    tr, graph, template = _torch_side(kw)
    state = tck.load_checkpoint(str(tmp_path / "jax.npz"), template)
    with np.load(str(tmp_path / "jax.npz")) as z:
        for key, value in _moments(state).items():
            param, slot = key.rsplit("/", 1)
            stored = z[f"opt_state/0/{'mu' if slot == 'exp_avg' else 'nu'}/{param}"]
            np.testing.assert_array_equal(value, stored, err_msg=key)


@pytest.mark.parametrize("kw", TREES + [dict(prep_class="node_embedding", embedding_dim=8)],
                         ids=TREE_IDS + ["node_embedding"])
def test_new_tree_checkpoint_keys_match_the_jax_layout(tmp_path, kw):
    test_checkpoint_keys_match_the_jax_layout(tmp_path, kw)


def test_node_embedding_export_refuses_another_graph(tmp_path, capsys):
    """The node-embedding table is keyed by training-graph node id: exporting
    a graph of another size exits with the JAX package's message (the npy
    header is read, not the table), and the same graph exports."""
    from tpu_sage_torch.cli import main as port_cli
    from tpu_sage_torch.export import main as port_export

    ck = str(tmp_path / "emb.npz")
    model = ["--n-train-samples", "4,3", "--n-val-samples", "4,3", "--output-dims", "8,8",
             "--prep-class", "node_embedding", "--device", "cpu"]
    assert port_cli(["--synthetic", "sbm", "--synthetic-nodes", "200", "--batch-size", "32",
                     "--epochs", "1", "--checkpoint-path", ck] + model) == 0
    out = str(tmp_path / "e.npy")
    with pytest.raises(SystemExit, match="TRANSDUCTIVE.*covers 200 training-graph nodes but "
                                         "the target graph has 300"):
        port_export(["--synthetic", "sbm", "--synthetic-nodes", "300", "--checkpoint", ck,
                     "--out", out] + model)
    assert port_export(["--synthetic", "sbm", "--synthetic-nodes", "200", "--checkpoint", ck,
                        "--out", out] + model) == 0
    assert np.load(out).shape == (200, 16)
