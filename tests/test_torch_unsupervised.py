"""The unsupervised path (``tpu_sage_torch/train/unsupervised.py``) against
the JAX package's ``tpu_sage/train/unsupervised.py`` on the CPU, mirroring
``tests/test_unsupervised.py``.

``torch.Generator`` and ``jax.random`` draw different numbers, so the
parity tests feed the port the reference's draws: each walk hop's uniforms,
the corpus' walk and position, the step's positives, negatives and tree
uniforms. The port's own draws are held to their distributions by χ²
tests. Tolerances are stated where they are used.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from tpu_sage.data.synthetic import sbm_problem as j_sbm_problem
from tpu_sage.sample import csr as jcsr
from tpu_sage.train import unsupervised as jun
from tpu_sage.train.trainer import TrainConfig as JTrainConfig
from tpu_sage.train.trainer import build_model as j_build_model
from tpu_sage_torch.data.synthetic import sbm_problem
from tpu_sage_torch.graph.graph_data import build_padded_adjacency
from tpu_sage_torch.nn.params import flax_key, load_flax_params
from tpu_sage_torch.train import unsupervised as un
from tpu_sage_torch.train.trainer import TrainConfig, build_model


def _t(a, dtype=torch.int32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _graphs(storage, n_nodes=200, seed=39):
    """The same SBM store's train graph in both packages: dense, CSR with
    the window hop, or CSR with the element hop (window 0)."""
    jp = j_sbm_problem(n_nodes=n_nodes, n_classes=3, feat_dim=8, avg_degree=5, seed=seed)
    tp = sbm_problem(n_nodes=n_nodes, n_classes=3, feat_dim=8, avg_degree=5, seed=seed)
    csr = storage != "dense"
    jg = jp.device_graph(train=True, csr=csr)
    tg = tp.device_graph(train=True, device="cpu", csr=csr)
    if storage == "csr_element":
        jg, tg = jg.replace(window=0), dataclasses.replace(tg, window=0)
    return jg, tg


def _walk_uniforms(key, n, length):
    return [_t(jax.random.uniform(k, (n, 1)), torch.float32)
            for k in jax.random.split(key, length)]


@pytest.mark.parametrize("storage", ["dense", "csr_window", "csr_element"])
def test_walks_take_the_references_steps_for_its_uniforms(storage):
    """Fed the reference's uniforms (one ``(B, 1)`` draw per hop, from the
    walk key's splits), the walk ends where the reference's does, bitwise."""
    jg, tg = _graphs(storage)
    ids = jnp.arange(0, 200, 3, dtype=jnp.int32)
    key = jax.random.key(3)
    want = np.asarray(jun.graph_random_walk(key, jg, ids, 4))
    us = _walk_uniforms(key, ids.shape[0], 4)
    got = un.graph_random_walk(tg, _t(ids), 4, us=us)
    np.testing.assert_array_equal(got.numpy(), want)
    if storage == "dense":
        np.testing.assert_array_equal(
            un.random_walk(tg.adj, tg.degrees, _t(ids), 4, us=us).numpy(),
            np.asarray(jun.random_walk(key, jg.adj, jg.degrees, ids, 4)))


@pytest.mark.parametrize("storage", ["dense", "csr_window"])
def test_random_walk_stays_on_graph(storage):
    """The reference's 4-cycle: an odd-length walk lands on the other
    parity; the isolated node self-loops (``tests/test_unsupervised.py``)."""
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 0]])  # 4-cycle + isolated 4
    adj, deg = build_padded_adjacency(edges, 5, max_degree=4)
    gen = torch.Generator().manual_seed(0)
    ids = torch.arange(5, dtype=torch.int32)
    if storage == "dense":
        out = un.random_walk(_t(adj), _t(deg), ids, 7, generator=gen).numpy()
    else:
        from tpu_sage_torch.graph.graph_data import GraphStore

        store = GraphStore(adj=adj, degrees=deg, train_adj=adj, train_degrees=deg,
                           feats=np.zeros((5, 1), np.float32), targets=np.zeros(5, np.int64),
                           folds={})
        out = un.graph_random_walk(store.to_device_csr(train=True, device="cpu"), ids, 7,
                                   generator=gen).numpy()
    assert out.shape == (5,) and out.dtype == np.int32
    assert all(o in (0, 1, 2, 3) for o in out[:4])
    assert all((o - i) % 2 == 1 for i, o in zip(range(4), out[:4]))
    assert out[4] == 4


def test_nce_loss_and_its_gradient_match_the_reference():
    """Values and gradients within 1e-6 (relative), and the reference's
    worked case: pos logit 1, neg logit −1 gives −2·logσ(1)."""
    rng = np.random.default_rng(0)
    zu, zp, zn = (rng.normal(size=s).astype(np.float32) for s in ((8, 6), (8, 6), (8, 5, 6)))
    want, jgrads = jax.value_and_grad(jun.nce_loss, argnums=(0, 1, 2))(zu, zp, zn)
    ts = [torch.from_numpy(a).requires_grad_() for a in (zu, zp, zn)]
    got = un.nce_loss(*ts)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for t, g in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-6, atol=1e-7)
    one = un.nce_loss(torch.tensor([[1.0, 0.0]]), torch.tensor([[1.0, 0.0]]),
                      torch.tensor([[[-1.0, 0.0]]]))
    np.testing.assert_allclose(float(one), -2 * float(jax.nn.log_sigmoid(1.0)), rtol=1e-6)


@pytest.mark.parametrize("neg_power", [0.0, 0.75])
def test_negatives_follow_their_distribution(neg_power):
    """χ² against uniform, or ∝ max(degree, 1)^0.75 (degree-0 nodes weigh as
    degree 1); 60,000 draws over 30 nodes, p > 1e-3."""
    deg = np.arange(30) % 7  # degrees 0..6
    neg = un.draw_negatives(_t(deg), 60_000, neg_power,
                            generator=torch.Generator().manual_seed(5))
    assert neg.dtype == torch.int32 and neg.shape == (60_000,)
    counts = np.bincount(neg.numpy(), minlength=30)
    w = np.maximum(deg, 1) ** neg_power
    expected = 60_000 * w / w.sum()
    assert scipy.stats.chisquare(counts, expected).pvalue > 1e-3


def _j_trainer(jp, cfg, unsup):
    model = j_build_model(cfg, jp.n_nodes, max(jp.n_classes, 2))
    return jun.UnsupervisedTrainer(model, cfg, unsup, steps_per_epoch=2)


def _t_trainer(tp, cfg, unsup):
    model = build_model(cfg, tp.n_nodes, max(tp.n_classes, 2), tp.feats_dim)
    return un.UnsupervisedTrainer(model, cfg, unsup, steps_per_epoch=2)


def _reference_draws(key, jtrainer, jg, ids):
    """The reference step's positives (a walk), negatives and tree
    uniforms, under ``_nce_loss_and_grads``'s key splits, and its tree."""
    unsup = jtrainer.unsup
    k_walk, k_neg, k_tree = jax.random.split(key, 3)
    b, q = ids.shape[0], unsup.n_negatives
    pos = jun.graph_random_walk(k_walk, jg, ids, unsup.walk_length)
    neg = jax.random.randint(k_neg, (b * q,), 0, jg.n_nodes).astype(jnp.int32)
    roots = jnp.concatenate([ids, pos, neg])
    us, n, key = [], roots.shape[0], k_tree
    for f in jtrainer.model.fanouts(train=True):
        key, sub = jax.random.split(key)
        us.append(_t(jax.random.uniform(sub, (n, f)), torch.float32))
        n *= f
    levels = jcsr.graph_sample_tree(k_tree, jg, roots, jtrainer.model.fanouts(train=True))
    return pos, neg, us, levels


@pytest.mark.parametrize("dtype,storage", [("float32", "dense"), ("float32", "csr_window"),
                                           ("bfloat16", "dense"), ("bfloat16", "int8"),
                                           ("float32", "int8")])
def test_one_nce_step_matches_the_reference(monkeypatch, dtype, storage):
    """The same flax parameters (``load_flax_params``), the reference's
    positives and negatives injected and its tree uniforms fed to the
    port's sampler: the loss and every gradient leaf equal the reference's
    ``_nce_loss_and_grads`` (its head's gradient is zero on both sides),
    on a dense, CSR or int8 (``quantize``: the deepest level through the
    int8 fanout mean) table.
    f32: within 1e-5 of the loss and 1e-5 of each leaf's scale (plus 1e-5
    relative). bf16: the model tests' limits, 6e-3 of the loss and 1.5e-2 of
    each leaf's scale."""
    jp = j_sbm_problem(n_nodes=120, n_classes=3, feat_dim=16, avg_degree=6, seed=2)
    tp = sbm_problem(n_nodes=120, n_classes=3, feat_dim=16, avg_degree=6, seed=2)
    kw = dict(batch_size=8, n_train_samples=(4, 3), n_val_samples=(4, 3), output_dims=(12, 12),
              compute_dtype=dtype)
    unsup = jun.UnsupConfig(walk_length=2, n_negatives=3)
    jtr = _j_trainer(jp, JTrainConfig(**kw), unsup)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    jg = jp.device_graph(train=True, csr=storage == "csr_window", dtype=jdt,
                         quantize=storage == "int8")
    jstate = jtr.init_state(jg)
    ids = jnp.asarray([3, 17, 40, 41, 77, 90, 101, 119], jnp.int32)
    key = jax.random.key(9)
    jloss, jgrads = jax.jit(functools.partial(jtr._nce_loss_and_grads, walks=None))(
        jstate.params, key, jg, ids)
    jgrads = _flat(jax.tree_util.tree_map(np.asarray, jgrads))

    ttr = _t_trainer(tp, TrainConfig(**kw), un.UnsupConfig(walk_length=2, n_negatives=3))
    tg = tp.device_graph(train=True, device="cpu", csr=storage == "csr_window",
                         dtype=getattr(torch, dtype), quantize=storage == "int8")
    state = ttr.init_state(tg)
    load_flax_params(ttr.model, jax.tree_util.tree_map(np.asarray, jstate.params))
    pos, neg, us, levels = _reference_draws(key, jtr, jg, ids)
    real_tree = un.graph_sample_tree

    def tree_with_reference_uniforms(graph, roots, fanouts, generator=None):
        np.testing.assert_array_equal(roots.numpy(), np.concatenate(
            [np.asarray(ids), np.asarray(pos), np.asarray(neg)]))
        out = real_tree(graph, roots, fanouts, us=us)
        for a, b in zip(out, levels):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        return out

    monkeypatch.setattr(un, "graph_sample_tree", tree_with_reference_uniforms)
    loss = ttr.nce_loss_and_grads(state, tg, _t(ids), pos=_t(pos), neg=_t(neg))
    tgrads = {flax_key(n): p.grad.float().numpy() for n, p in ttr.model.named_parameters()}
    assert sorted(tgrads) == sorted(jgrads)
    assert not np.abs(tgrads["params/fc/kernel"]).any()
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-5)
        for k in jgrads:
            np.testing.assert_allclose(tgrads[k], jgrads[k], rtol=1e-5,
                                       atol=1e-5 * max(np.abs(jgrads[k]).max(), 1e-30),
                                       err_msg=k)
    else:
        np.testing.assert_allclose(float(loss), float(jloss), rtol=6e-3)
        for k in jgrads:
            g = np.abs(jgrads[k]).max()
            np.testing.assert_allclose(tgrads[k], jgrads[k], rtol=0, atol=1.5e-2 * g,
                                       err_msg=k)


def test_corpus_mode_matches_the_reference_and_checks_the_corpus():
    """Corpus positives for the reference's walk and position draws equal
    its ``walks[ids][arange(B), wi, pi]`` (the corpus rows through
    ``row_gather``); a corpus that misses nodes raises the reference's
    ``ValueError``."""
    from tpu_sage.data.convert import generate_walks

    jp = j_sbm_problem(n_nodes=150, n_classes=3, feat_dim=8, seed=23)
    walks = generate_walks(jp.store.train_adj, jp.store.train_degrees,
                           np.arange(150), n_walks=4, walk_len=4, seed=1)
    ids = jnp.asarray(np.random.default_rng(2).integers(0, 150, 32), jnp.int32)
    kw1, kw2 = jax.random.split(jax.random.key(5))
    wi = jax.random.randint(kw1, (32,), 0, 4)
    pi = jax.random.randint(kw2, (32,), 1, 5)
    want = np.asarray(jnp.asarray(walks)[ids][jnp.arange(32), wi, pi])
    got = un.corpus_positives(_t(walks), _t(ids), wi=_t(wi), pi=_t(pi))
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = un.corpus_positives(_t(walks), _t(ids), generator=torch.Generator().manual_seed(0))
    rows = walks[np.asarray(ids)]
    assert all(p in rows[i, :, 1:] for i, p in enumerate(drawn.numpy()))

    tp = sbm_problem(n_nodes=150, n_classes=3, feat_dim=8, seed=23)
    cfg = TrainConfig(batch_size=32, epochs=1, n_train_samples=(3, 2), n_val_samples=(3, 2),
                      output_dims=(8, 8))
    with pytest.raises(ValueError, match="walk corpus must cover every node"):
        un.fit_unsupervised(tp, cfg, walks=walks[:100], log=lambda d: None, device="cpu")


def test_walk_corpus_mode_trains_from_an_h5_file(tmp_path):
    """``problem.h5``'s ``walks`` dataset → ``NodeProblem.walks`` → corpus
    positives: the loss falls (``tests/test_unsupervised.py``)."""
    from tpu_sage.data.convert import generate_walks, save_problem_h5
    from tpu_sage.data.synthetic import sbm_store
    from tpu_sage_torch.data.problem import NodeProblem

    store = sbm_store(n_nodes=300, n_classes=3, feat_dim=16, seed=23)
    walks = generate_walks(store.train_adj, store.train_degrees,
                           np.arange(store.n_nodes), n_walks=4, walk_len=4, seed=1)
    path = str(tmp_path / "p.h5")
    save_problem_h5(store, path, walks=walks)
    problem = NodeProblem.from_h5(path)
    np.testing.assert_array_equal(problem.walks, walks)
    assert NodeProblem(problem.store).walks is None
    cfg = TrainConfig(batch_size=64, epochs=2, n_train_samples=(5, 3), n_val_samples=(5, 3),
                      output_dims=(16, 16), lr_init=0.01)
    _, _, hist = un.fit_unsupervised(problem, cfg, log=lambda d: None, device="cpu")
    assert hist[-1]["unsup_loss"] < hist[0]["unsup_loss"]


def test_config_and_gather_defaults_match_the_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(un.UnsupConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jun.UnsupConfig)]
    for kw in (dict(), dict(gather_form="plain"), dict(gather_chunks=4)):
        ours = dataclasses.asdict(un.unsup_gather_defaults(TrainConfig(**kw)))
        ref = dataclasses.asdict(jun.unsup_gather_defaults(JTrainConfig(**kw)))
        assert ours == ref


@pytest.mark.parametrize("n_classes", [2, 7])
def test_logistic_probe_agrees_with_the_references_sklearn_probe(n_classes):
    """On the same embeddings (class means apart, heavy noise) the port's
    L-BFGS probe is within 0.02 of the reference's scikit-learn probe, for
    two classes (one weight vector) and seven (softmax); an empty fold gives
    None in both."""
    rng = np.random.default_rng(n_classes)
    n, d = 900, 16
    y = rng.integers(0, n_classes, n)
    z = (rng.normal(size=(n_classes, d)) * 0.3)[y] + rng.normal(size=(n, d))
    folds = {"train": np.arange(0, 600), "val": np.arange(600, n)}
    embed = lambda ids: z[ids].astype(np.float32)  # noqa: E731
    ref = jun.logistic_probe(embed, y, folds)
    got = un.logistic_probe(lambda ids: torch.from_numpy(embed(ids)), y, folds)
    assert 0.3 < ref < 0.9
    assert abs(got - ref) <= 0.02, (got, ref)
    empty = {"train": folds["train"], "val": np.array([], np.int64)}
    assert un.logistic_probe(embed, y, empty) is None is jun.logistic_probe(embed, y, empty)


def test_unsupervised_embeddings_are_useful():
    """The reference's protocol at its sizes: the loss falls, the probe is in
    the history and reaches 0.8× the supervised val accuracy on the same
    graph, and it equals the probe run by hand on ``embed_all``."""
    from tpu_sage_torch.train.trainer import fit

    problem = sbm_problem(n_nodes=600, n_classes=4, feat_dim=32, avg_degree=8,
                          p_in=0.95, feat_noise=1.0, seed=11)
    cfg = TrainConfig(batch_size=128, epochs=3, n_train_samples=(8, 4),
                      n_val_samples=(8, 4), output_dims=(32, 32), lr_init=0.005)
    trainer, state, hist = un.fit_unsupervised(
        problem, cfg, un.UnsupConfig(walk_length=2, n_negatives=5), log=lambda d: None,
        device="cpu")
    assert hist[-1]["unsup_loss"] < hist[0]["unsup_loss"]
    acc = hist[-1]["probe_val_accuracy"]
    _, _, sup_hist = fit(problem, cfg.replace(lr_init=0.01), log=lambda d: None, device="cpu")
    assert acc >= 0.8 * sup_hist[-1]["val_metric"], (acc, sup_hist[-1]["val_metric"])
    graph = problem.device_graph(train=False, device="cpu")
    manual = un.logistic_probe(lambda ids: trainer.embed_all(state, graph, ids),
                               problem.store.targets, problem.folds)
    assert manual == acc
    z = trainer.embed_all(state, graph, problem.folds["val"][:37], batch_size=16)
    assert z.shape == (37, 64) and z.dtype == torch.float32
    np.testing.assert_allclose(z.norm(dim=1).numpy(), 1.0, rtol=1e-5)


def test_unsupervised_checkpoint_resume(tmp_path):
    problem = sbm_problem(n_nodes=300, n_classes=3, feat_dim=16, seed=29)
    cfg = TrainConfig(batch_size=64, epochs=2, n_train_samples=(5, 3),
                      n_val_samples=(5, 3), output_dims=(16, 16))
    ckpt = str(tmp_path / "u.npz")
    recs = []
    un.fit_unsupervised(problem, cfg, un.UnsupConfig(walk_length=2), log=recs.append,
                        resume_from=ckpt, checkpoint_every=1, device="cpu")
    assert any("checkpoint" in r for r in recs)
    recs2 = []
    un.fit_unsupervised(problem, cfg.replace(epochs=4), un.UnsupConfig(walk_length=2),
                        log=recs2.append, resume_from=ckpt, checkpoint_every=1, device="cpu")
    resumed = next(r for r in recs2 if "resumed_from" in r)
    assert resumed["start_epoch"] == 2
    assert [r["epoch"] for r in recs2 if "epoch" in r] == [2, 3]


def test_unsupervised_small_fold_clamps_batch():
    problem = sbm_problem(n_nodes=60, n_classes=3, feat_dim=8, avg_degree=5, seed=7)
    cfg = TrainConfig(batch_size=512, epochs=2, n_train_samples=(4, 3),
                      n_val_samples=(4, 3), output_dims=(16, 16))
    recs = []
    _, _, hist = un.fit_unsupervised(problem, cfg, un.UnsupConfig(walk_length=2, n_negatives=3),
                                     log=recs.append, device="cpu")
    assert len(hist) == 2
    assert any("clamped" in str(r.get("note", "")) for r in recs)


def test_unsupervised_probe_every_thinning():
    problem = sbm_problem(n_nodes=300, n_classes=3, feat_dim=16, avg_degree=6, seed=17)
    cfg = TrainConfig(batch_size=64, epochs=4, n_train_samples=(5, 3),
                      n_val_samples=(5, 3), output_dims=(16, 16))
    _, _, hist = un.fit_unsupervised(
        problem, cfg, un.UnsupConfig(walk_length=2, n_negatives=3, probe_every=2),
        log=lambda d: None, device="cpu")
    assert ["probe_val_accuracy" in h for h in hist] == [False, True, False, True]


def test_unsupervised_patience_and_save_best(tmp_path):
    problem = sbm_problem(n_nodes=400, n_classes=3, feat_dim=32, avg_degree=8,
                          p_in=0.95, feat_noise=0.3, seed=13)
    ck = str(tmp_path / "u.npz")
    cfg = TrainConfig(batch_size=64, epochs=20, n_train_samples=(5, 3),
                      n_val_samples=(5, 3), output_dims=(32, 32),
                      lr_init=0.005, patience=2, save_best=True)
    recs = []
    _, _, hist = un.fit_unsupervised(problem, cfg, un.UnsupConfig(walk_length=2, n_negatives=5),
                                     log=recs.append, resume_from=ck, device="cpu")
    assert all("probe_val_accuracy" in h for h in hist)
    assert len(hist) < 20
    assert any(r.get("early_stop") for r in recs)
    assert os.path.exists(ck)
    best_writes = [r for r in recs if "checkpoint_best" in r]
    assert best_writes
    assert best_writes[-1]["val_metric"] == max(h["probe_val_accuracy"] for h in hist)


def test_unsupervised_patience_inactive_without_probe():
    problem = sbm_problem(n_nodes=200, n_classes=3, feat_dim=8, avg_degree=5,
                          task="regression", seed=19)
    cfg = TrainConfig(batch_size=64, epochs=2, n_train_samples=(4, 2),
                      n_val_samples=(4, 2), output_dims=(16, 16), patience=2)
    recs = []
    _, _, hist = un.fit_unsupervised(problem, cfg, un.UnsupConfig(walk_length=2, n_negatives=3),
                                     log=recs.append, device="cpu")
    assert len(hist) == 2
    assert any("patience/save_best inactive" in str(r.get("note", "")) for r in recs)


@pytest.mark.parametrize("neg_power", [0.0, 0.75])
def test_unsupervised_with_csr_adjacency(neg_power):
    """Walks, the NCE tree and the probe on CSR storage (window hop), with
    uniform and degree-smoothed negatives."""
    problem = sbm_problem(n_nodes=400, n_classes=3, feat_dim=16, avg_degree=6, p_in=0.9,
                          seed=37)
    cfg = TrainConfig(batch_size=64, epochs=3, n_train_samples=(5, 3),
                      n_val_samples=(5, 3), output_dims=(16, 16), lr_init=0.005)
    _, _, hist = un.fit_unsupervised(
        problem, cfg, un.UnsupConfig(walk_length=2, n_negatives=5, neg_power=neg_power),
        log=lambda d: None, csr=True, device="cpu")
    assert hist[-1]["unsup_loss"] < hist[0]["unsup_loss"]
    assert hist[-1]["probe_val_accuracy"] > 0.5


def test_fit_unsupervised_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the refusal without one")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        un.fit_unsupervised(sbm_problem(n_nodes=100, n_classes=2, feat_dim=4),
                            TrainConfig(batch_size=8, epochs=1))


def _embed_levels(n_nodes, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n_nodes, size=s).astype(np.int32) for s in (10, 50, 150)]


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A JAX ``fit_unsupervised`` checkpoint loads into the port and gives
    the reference's embeddings for injected levels (within 1e-5), and a
    port checkpoint loads into the JAX package with the same result; the
    step count crosses too."""
    from tpu_sage.train.checkpoint import load_checkpoint as j_load
    from tpu_sage_torch.train.checkpoint import load_checkpoint

    kw = dict(batch_size=64, epochs=1, n_train_samples=(5, 3), n_val_samples=(5, 3),
              output_dims=(16, 16))
    jp = j_sbm_problem(n_nodes=300, n_classes=3, feat_dim=16, seed=29)
    tp = sbm_problem(n_nodes=300, n_classes=3, feat_dim=16, seed=29)
    unsup = dict(walk_length=2, n_negatives=3)
    levels = _embed_levels(300)
    jlevels = [jnp.asarray(l) for l in levels]
    feats = jp.store.feats

    def j_embed(state, trainer):
        return np.asarray(trainer.model.apply(state.params, jlevels, jnp.asarray(feats),
                                              method=trainer.model.encode))

    def t_embed(state):
        with torch.no_grad():
            return state.model.encode([torch.from_numpy(l) for l in levels],
                                      torch.from_numpy(feats)).numpy()

    jck, tck = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jtr, jstate, _ = jun.fit_unsupervised(jp, JTrainConfig(**kw), jun.UnsupConfig(**unsup),
                                          log=lambda d: None, resume_from=jck,
                                          checkpoint_every=1, probe=False)
    ttr = _t_trainer(tp, un.unsup_gather_defaults(TrainConfig(**kw)), un.UnsupConfig(**unsup))
    state = load_checkpoint(jck, ttr.init_state(tp.device_graph(train=True, device="cpu")))
    assert state.step == int(jstate.step) > 0
    np.testing.assert_allclose(t_embed(state), j_embed(jstate, jtr), rtol=1e-5, atol=1e-5)

    _, tstate, _ = un.fit_unsupervised(tp, TrainConfig(**kw), un.UnsupConfig(**unsup),
                                       log=lambda d: None, resume_from=tck,
                                       checkpoint_every=1, probe=False, device="cpu")
    j2 = _j_trainer(jp, jun.unsup_gather_defaults(JTrainConfig(**kw)), jun.UnsupConfig(**unsup))
    jstate2 = j_load(tck, j2.init_state(jp.device_graph(train=True)))
    assert int(jstate2.step) == tstate.step
    np.testing.assert_allclose(j_embed(jstate2, j2), t_embed(tstate), rtol=1e-5, atol=1e-5)


def test_unsupervised_cli_checkpoint_exports_embeddings(tmp_path, capsys):
    """``--unsupervised`` through the CLI writes a checkpoint whose
    embeddings ``tpu_sage_torch.export`` and the JAX package's exporter both
    write, agreeing within 1e-5."""
    from tpu_sage.export import main as j_export
    from tpu_sage_torch.cli import main
    from tpu_sage_torch.export import main as export

    ck = str(tmp_path / "u.npz")
    base = ["--synthetic", "sbm", "--synthetic-nodes", "300", "--n-train-samples", "4,3",
            "--n-val-samples", "4,3", "--output-dims", "16,16"]
    assert main(base + ["--batch-size", "64", "--epochs", "2", "--unsupervised",
                        "--walk-length", "2", "--n-negatives", "3", "--checkpoint-path", ck,
                        "--device", "cpu"]) == 0
    recs = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert recs[0]["config"]["fuse_first_layer"] is False
    losses = [r["unsup_loss"] for r in recs if "unsup_loss" in r]
    assert len(losses) == 2 and losses[1] < losses[0]
    assert "probe_val_accuracy" in recs[-2] or any("probe_val_accuracy" in r for r in recs)
    exp = ["--synthetic", "sbm", "--synthetic-nodes", "300", "--checkpoint", ck,
           "--checkpoint-config"]
    assert export(exp + ["--out", str(tmp_path / "t.npy"), "--device", "cpu"]) == 0
    assert j_export(exp + ["--out", str(tmp_path / "j.npy")]) == 0
    got, want = np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy")
    assert got.shape == (300, 32) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
