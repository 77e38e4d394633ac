"""Rank bodies for the port's multi-process tests (``tests/test_torch_dist_*.py``).

Each test module spawns one group of gloo ranks (``tpu_sage_torch.dist.mesh.spawn``,
start method ``spawn``, a ``file://`` store under the test's ``tmp_path``)
that runs one function here: every rank runs all of the module's checks on
the port's side and writes what it got to ``<out>/rank<r>.pt``; the test
process holds those results against the JAX package. The inputs are made
with numpy from fixed seeds (``*_inputs``), in the ranks and in the tests
alike, or handed over in ``<out>/inputs.npz``. This module imports neither
JAX nor pytest, so a rank starts with torch and the port only.
"""

from __future__ import annotations

import os

import numpy as np
import torch

N_ROWS, WIDTH, QUERIES, FANOUT = 64, 16, 40, 5  # halo tables: 64 rows of 16, 40 ids per rank
ONE_THREAD = {"OMP_NUM_THREADS": "1"}  # each rank's environment


def spawn_ranks(fn, world_size: int, out_dir: str) -> None:
    """``tpu_sage_torch.dist.mesh.spawn(fn, world_size, "cpu", (out_dir,))``
    with ``ONE_THREAD`` in the ranks' environment, so that the OpenMP and
    BLAS pools each rank's torch and numpy start at import hold one thread,
    as ``torch.set_num_threads(1)`` at each rank body's start does for
    torch's own ops: 2-4 ranks a file beside several test workers would
    otherwise start a pool of the host's cores each."""
    from tpu_sage_torch.dist import mesh

    saved = {k: os.environ.get(k) for k in ONE_THREAD}
    os.environ.update(ONE_THREAD)
    try:
        mesh.spawn(fn, world_size, "cpu", (out_dir,), store_dir=out_dir)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def halo_inputs(world: int):
    """The halo checks' tables and per-rank ids: ``(tables, ids, ids2)``."""
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(N_ROWS, WIDTH)).astype(np.float32)
    tables = {"f32": f32, "bf16": f32, "int8": rng.integers(-100, 100, size=(N_ROWS, WIDTH))
              .astype(np.int8)}
    ids = rng.integers(0, N_ROWS, size=(world, QUERIES)).astype(np.int32)
    ids2 = rng.integers(0, N_ROWS, size=(world, 12)).astype(np.int32)
    return tables, ids, ids2


def hop_store():
    """A small SBM store with isolated nodes, for the sampling hops."""
    from tpu_sage_torch.data.synthetic import sbm_store

    return sbm_store(n_nodes=100, n_classes=3, feat_dim=8, avg_degree=2, max_degree=12, seed=3)


def _torch_table(name: str, a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if name == "bf16" else t


def _save(out_dir: str, res: dict) -> None:
    from tpu_sage_torch.dist.mesh import rank

    torch.save({k: (v.detach().cpu() if isinstance(v, torch.Tensor) else v)
                for k, v in res.items()}, os.path.join(out_dir, f"rank{rank()}.pt"))


def halo_checks(out_dir: str) -> None:
    """Every halo mode on every table, the CSR views, the owner-select and
    the distributed hops with the uniforms in ``inputs.npz``."""
    from tpu_sage_torch.dist import halo
    from tpu_sage_torch.dist.mesh import rank, world
    from tpu_sage_torch.dist.partition import shard_graph, shard_graph_csr
    from tpu_sage_torch.dist.train import make_gather, sample_level_distributed

    torch.set_num_threads(1)
    r, n = rank(), world()
    tables, ids, ids2 = halo_inputs(n)
    m = N_ROWS // n
    my, my2 = torch.from_numpy(ids[r]), torch.from_numpy(ids2[r])
    res = {}
    for name, table in tables.items():
        lt = _torch_table(name, table[r * m:(r + 1) * m])
        res[f"exact/{name}"] = halo.dist_gather(lt, my)
        res[f"ring/{name}"] = halo.dist_gather_ring(lt, my)
        res[f"pipelined0/{name}"], res[f"pipelined1/{name}"] = halo.dist_gather_ring_pipelined(
            lt, [my2, my], last_fanout=FANOUT)
        res[f"mean/{name}"] = halo.dist_gather_fanout_mean(lt, my, FANOUT)
        res[f"ring_mean/{name}"] = halo.dist_gather_ring_fanout_mean(lt, my, FANOUT)
        for cap in (max(1, int(2.0 * QUERIES / n)), 2):
            rows, ovf = halo.dist_gather_bucketed(lt, my, cap)
            res[f"bucketed{cap}/{name}"], res[f"overflow{cap}/{name}"] = rows, ovf

    inputs = np.load(os.path.join(out_dir, "inputs.npz"))
    store = hop_store()
    dense, hm = shard_graph(store, train=True, device="cpu")
    csr, _ = shard_graph_csr(store, train=True, device="cpu")
    q = inputs["frontier"].shape[0] // n
    frontier = torch.from_numpy(inputs["frontier"][r * q:(r + 1) * q])
    u = torch.from_numpy(inputs["u"][r * q:(r + 1) * q])
    pair = halo.CSRPairRows(csr.indptr, csr.indices, csr.degrees, csr.window)
    res["csr_pair"] = halo.dist_gather(pair, frontier)
    res["csr_adj"] = halo.dist_gather(
        halo.CSRAdjRows(csr.indptr, csr.indices, csr.degrees, csr.window), frontier)
    res["owner_select"] = halo.dist_sample_csr_owner_select(
        csr.indptr, csr.indices, csr.degrees, csr.window, frontier, u)
    adj_deg = torch.cat([dense.adj, dense.degrees[:, None]], dim=1)
    for mode in ("exact", "ring", "bucketed"):
        gather = make_gather(mode, n, 2.0)
        res[f"hop/{mode}"] = sample_level_distributed(adj_deg, frontier, FANOUT, gather, u=u)[0]
        res[f"hop_pair/{mode}"] = sample_level_distributed(
            pair, frontier, FANOUT, gather, pair_window=csr.window, u=u)[0]
    res["hop_owner"] = sample_level_distributed(
        None, frontier, FANOUT, owner_select=lambda i, uu: halo.dist_sample_csr_owner_select(
            csr.indptr, csr.indices, csr.degrees, csr.window, i, uu), u=u)[0]
    res["shard_size"] = hm
    _save(out_dir, res)


# -- training ---------------------------------------------------------------

STEP_FANOUTS, STEP_DIMS, STEP_BATCH = (4, 3), (16, 16), 32


def train_store():
    from tpu_sage_torch.data.synthetic import sbm_store

    return sbm_store(n_nodes=512, n_classes=4, feat_dim=16, avg_degree=6, seed=6)


def step_config(agg: str, dtype: str, **kw):
    from tpu_sage_torch.train.trainer import TrainConfig

    base = dict(batch_size=STEP_BATCH, epochs=1, n_train_samples=STEP_FANOUTS,
                n_val_samples=STEP_FANOUTS, output_dims=STEP_DIMS, lr_init=0.01)
    return TrainConfig(**{**base, **kw}, aggregator_class=agg, compute_dtype=dtype)


def step_levels(store, shard: int, n_shards: int, shard_size: int, batch: int):
    """An injected tree for ``shard``: roots among its own train nodes,
    deeper levels anywhere in the graph."""
    rng = np.random.default_rng(100 + shard)
    train = store.folds["train"]
    own = train[(train // shard_size) == shard]
    sizes = [batch, batch * STEP_FANOUTS[0], batch * STEP_FANOUTS[0] * STEP_FANOUTS[1]]
    levels = [rng.choice(own, size=batch).astype(np.int32)]
    levels += [rng.integers(0, store.n_nodes, size=s).astype(np.int32) for s in sizes[1:]]
    return levels


def _fit_log(store, config, **kw):
    from tpu_sage_torch.dist.train import fit_partitioned

    recs = []
    trainer, state, hist = fit_partitioned(store, config, log=recs.append, device="cpu", **kw)
    return trainer, state, hist, recs


def train_checks(out_dir: str) -> None:
    """One step's loss and gradients on injected levels; fit_partitioned
    for mean and gcn with the replicas' fingerprints; evaluation counts and
    the exact pass; the other halo modes, CSR and int8 shards, the measured
    race; the epoch batches' draws."""
    from tpu_sage_torch.dist.debug import assert_replicas_equal, tree_fingerprint
    from tpu_sage_torch.dist.halo import all_gather_rows
    from tpu_sage_torch.dist.mesh import rank, world
    from tpu_sage_torch.dist.train import PartitionedTrainer, epoch_batch_ids
    from tpu_sage_torch.nn.full_graph import embed_all_nodes_partitioned
    from tpu_sage_torch.nn.params import flax_key

    torch.set_num_threads(1)
    r, n = rank(), world()
    store = train_store()
    res = {}
    for agg in ("mean", "gcn"):
        for dtype in ("float32", "bfloat16"):
            cfg = step_config(agg, dtype)
            tr, graph, fold_ids, fold_w = PartitionedTrainer.from_store(store, cfg, "cpu")
            state = tr.init_state()
            levels = [torch.from_numpy(l) for l in step_levels(store, r, n, tr.shard_size,
                                                               tr.batch_per_shard)]
            state, m = tr.train_step(state, graph, fold_ids, fold_w, levels=levels)
            key = f"step/{agg}/{dtype}"
            res[key + "/loss"] = m["loss"]
            res[key + "/fold_w"] = fold_w
            for name, p in tr.model.named_parameters():
                res[f"{key}/grad/{flax_key(name)}"] = p.grad.clone()

    for agg in ("mean", "gcn"):
        cfg = step_config(agg, "float32", batch_size=64, epochs=8, n_train_samples=(5, 3),
                          n_val_samples=(5, 3), output_dims=(32, 32))
        tr, state, hist, recs = _fit_log(store, cfg, eval_every_epoch=False)
        assert_replicas_equal(state.model, "params")
        assert_replicas_equal(state.optimizer, "optimizer")
        res[f"fit/{agg}/losses"] = [h["train_loss"] for h in hist]
        res[f"fit/{agg}/fingerprint"] = (float(tree_fingerprint(state.model)),
                                         float(tree_fingerprint(state.optimizer)))
        res[f"fit/{agg}/log"] = recs
        if agg == "mean":
            stats = tr.eval_stats(state, store, "val", seed=1)
            res["eval/stats"] = stats
            res["eval/metric"] = tr.evaluate(state, store, "val", seed=1)
            res["eval/exact"] = tr.evaluate_exact(state, store, "val")
            graph, _ = tr._full_graph_shard(store)
            res["eval/logits"] = all_gather_rows(
                embed_all_nodes_partitioned(tr.model, graph, chunk=50, with_head=True))
            res["eval/state"] = {name: p.detach().clone()
                                 for name, p in tr.model.named_parameters()}

    for label, kw, fit_kw in (
            ("ring", dict(halo="ring"), {}),
            ("pipelined", dict(halo="pipelined"), {}),
            ("bucketed", dict(halo="bucketed", halo_capacity_factor=0.3), {}),
            ("csr", dict(), dict(csr=True)),
            ("csr_int8_ring", dict(halo="ring", feature_int8=True, compute_dtype="bfloat16"),
             dict(csr=True)),
            ("measured", dict(halo="measured", halo_measure_steps=2), {})):
        cfg = step_config("mean", kw.pop("compute_dtype", "float32"), batch_size=64, epochs=3,
                          n_train_samples=(5, 3), n_val_samples=(5, 3), output_dims=(32, 32),
                          **kw)
        tr, state, hist, recs = _fit_log(store, cfg, **fit_kw)
        assert_replicas_equal(state.model, label)
        res[f"mode/{label}/log"] = recs
        res[f"mode/{label}/halo"] = tr.halo_mode

    fold = torch.as_tensor([r * 1000 + i for i in range(7)], dtype=torch.int32)
    res["batches"] = torch.stack([epoch_batch_ids(5, s, fold, 5.0, 2, 4, r)
                                  for s in range(12)])
    _save(out_dir, res)


# -- checkpoints ------------------------------------------------------------

def checkpoint_checks(out_dir: str) -> None:
    """Resume the JAX package's checkpoint ``<out>/jax.npz`` (written on
    another shard count), then write ``<out>/port.npz`` for the JAX package
    to resume."""
    torch.set_num_threads(1)
    store = train_store()
    cfg = step_config("mean", "float32", batch_size=64, epochs=4, n_train_samples=(5, 3),
                      n_val_samples=(5, 3), output_dims=(32, 32))
    _, _, hist, recs = _fit_log(store, cfg, resume_from=os.path.join(out_dir, "jax.npz"))
    cfg2 = cfg.replace(epochs=2)
    _, _, hist2, recs2 = _fit_log(store, cfg2, resume_from=os.path.join(out_dir, "port.npz"),
                                  checkpoint_every=1)
    _save(out_dir, {"resumed": recs, "history": hist, "written": recs2, "history2": hist2})


# -- data parallel ----------------------------------------------------------

DP_BATCH = 16


def dp_checks(out_dir: str) -> None:
    """One ``DataParallelTrainer`` step on the whole batch with injected
    levels (each rank its slice), then an epoch."""
    from tpu_sage_torch.data.synthetic import sbm_problem
    from tpu_sage_torch.dist.data_parallel import DataParallelTrainer
    from tpu_sage_torch.dist.debug import assert_replicas_equal
    from tpu_sage_torch.nn.params import flax_key
    from tpu_sage_torch.train.trainer import build_model

    torch.set_num_threads(1)
    inputs = np.load(os.path.join(out_dir, "inputs.npz"))
    problem = sbm_problem(n_nodes=300, n_classes=4, feat_dim=16, seed=2)
    res = {}
    for dtype in ("float32", "bfloat16"):
        cfg = step_config("mean", dtype, batch_size=DP_BATCH)
        model = build_model(cfg, problem.n_nodes, problem.n_classes, problem.feats_dim)
        tr = DataParallelTrainer(model, cfg, steps_per_epoch=4, task=problem.task)
        graph = problem.device_graph(train=True, dtype=getattr(torch, dtype), device="cpu")
        state = tr.init_state(graph)
        levels = [torch.from_numpy(inputs[f"level{i}"]) for i in range(3)]
        state, m = tr.train_step(state, graph, levels[0], graph.targets[levels[0].long()],
                                 levels=levels)
        res[f"{dtype}/loss"] = m["loss"]
        for name, p in model.named_parameters():
            res[f"{dtype}/grad/{flax_key(name)}"] = p.grad.clone()
            res[f"{dtype}/param/{flax_key(name)}"] = p.detach().clone()
        fold = torch.as_tensor(problem.folds["train"], dtype=torch.int32)
        state, m = tr.train_epoch(state, graph, fold, graph.targets[fold.long()])
        assert_replicas_equal(state.model, "params")
        res[f"{dtype}/epoch_loss"] = m["loss"]
    _save(out_dir, res)


# -- the 2-D layouts: hierarchical exchange and tensor parallelism ------------

H2_STEPS = 20
TP_BATCH = 32


def h2_config(**kw):
    """The JAX package's hier2d training test's configuration."""
    from tpu_sage_torch.train.trainer import TrainConfig

    base = dict(batch_size=64, epochs=1, n_train_samples=(5, 3), n_val_samples=(5, 3),
                output_dims=(32, 32), lr_init=0.01)
    return TrainConfig(**{**base, **kw})


def tp_problem():
    from tpu_sage_torch.data.synthetic import sbm_problem

    return sbm_problem(n_nodes=300, n_classes=4, feat_dim=16, seed=2)


def tp_levels(problem):
    rng = np.random.default_rng(4)
    b, (f1, f2) = TP_BATCH, STEP_FANOUTS
    return [rng.choice(problem.folds["train"], b).astype(np.int32),
            rng.integers(0, problem.n_nodes, b * f1).astype(np.int32),
            rng.integers(0, problem.n_nodes, b * f1 * f2).astype(np.int32)]


def hier2d_tp_checks(out_dir: str) -> None:
    """On 4 ranks laid out (2, 2): ``dist_gather_2d`` against the flat
    exchange on every table, with and without ``fanout``; H2_STEPS hier2d
    steps against exact's on the flat layout, the evaluations over the 2-D
    layout; a flat run's checkpoint resumed by a hier2d run; then (data,
    model) = (2, 2): one tensor-parallel step on injected levels, its split
    parameters and moments, a checkpoint of it, and the uneven width."""
    from tpu_sage_torch.dist import halo
    from tpu_sage_torch.dist.data_parallel import DataParallelTrainer, split_kernels
    from tpu_sage_torch.dist.mesh import layout_2d, rank, world
    from tpu_sage_torch.dist.train import PartitionedTrainer, fit_partitioned
    from tpu_sage_torch.nn.full_graph import embed_all_nodes_partitioned
    from tpu_sage_torch.nn.params import flax_key
    from tpu_sage_torch.train.trainer import build_model

    torch.set_num_threads(1)
    r, n = rank(), world()
    layout = layout_2d(2, 2)
    tables, ids, _ = halo_inputs(n)
    m = N_ROWS // n
    my = torch.from_numpy(ids[r])
    res = {"layout": (layout.outer, layout.inner)}
    for name, table in tables.items():
        lt = _torch_table(name, table[r * m:(r + 1) * m])
        res[f"h2/{name}"] = halo.dist_gather_2d(lt, my, layout)
        res[f"h2mean/{name}"] = halo.dist_gather_2d(lt, my, layout, FANOUT)
        res[f"flat/{name}"] = halo.dist_gather(lt, my)

    store = train_store()
    for label, kw in (("hier2d", dict(layout=layout)), ("exact", {})):
        cfg = h2_config(halo=label)
        tr, graph, fold_ids, fold_w = PartitionedTrainer.from_store(store, cfg, "cpu", **kw)
        state = tr.init_state()
        losses = []
        for _ in range(H2_STEPS):
            state, m_ = tr.train_step(state, graph, fold_ids, fold_w)
            losses.append(float(m_["loss"]))
        res[f"train/{label}/losses"] = losses
        res[f"train/{label}/halo"] = tr.halo_mode
        if label == "hier2d":
            res["train/hier2d/val"] = tr.evaluate(state, store, "val", seed=1)
            res["train/hier2d/val_exact"] = tr.evaluate_exact(state, store, "val")
            g_full, _ = tr._full_graph_shard(store)
            res["train/hier2d/logits"] = halo.all_gather_rows(
                embed_all_nodes_partitioned(tr.model, g_full, chunk=50, with_head=True))
            res["train/hier2d/state"] = {k: p.detach().clone()
                                         for k, p in tr.model.named_parameters()}

    ck = os.path.join(out_dir, "topo.npz")
    fit_partitioned(store, h2_config(epochs=2, halo="exact"), log=lambda d: None, device="cpu",
                    resume_from=ck, checkpoint_every=1, eval_every_epoch=False)
    recs = []
    _, _, hist = fit_partitioned(store, h2_config(epochs=4, halo="hier2d"), log=recs.append,
                                 device="cpu", resume_from=ck, layout=layout)
    res["resume/log"], res["resume/hist"] = recs, hist

    problem = tp_problem()
    levels = [torch.from_numpy(lv) for lv in tp_levels(problem)]
    cfg = step_config("mean", "float32", batch_size=TP_BATCH)
    model = build_model(cfg, problem.n_nodes, problem.n_classes, problem.feats_dim)
    tr = DataParallelTrainer(model, cfg, steps_per_epoch=4, task=problem.task,
                             model_axis="model", layout=layout)
    graph = problem.device_graph(train=True, device="cpu")
    state = tr.init_state(graph)
    state, m_ = tr.train_step(state, graph, levels[0], graph.targets[levels[0].long()],
                              levels=levels)
    res["tp/loss"] = m_["loss"]
    for name, p in model.named_parameters():
        k = flax_key(name)
        res[f"tp/param/{k}"] = p.detach().clone()
        res[f"tp/exp_avg/{k}"] = state.optimizer.state[p]["exp_avg"].clone()
    tr.save(os.path.join(out_dir, "tp.npz"), state, cfg, write=r == 0)
    res["tp/step_after_save"] = float(tr.train_step(
        state, graph, levels[0], graph.targets[levels[0].long()], levels=levels)[1]["loss"])
    odd = build_model(cfg, problem.n_nodes, 3, problem.feats_dim)
    try:
        split_kernels(odd, 2)
        res["tp/uneven"] = None
    except ValueError as e:
        res["tp/uneven"] = str(e)
    _save(out_dir, res)


# -- partitioned NCE ------------------------------------------------------------

NCE_NODES = 510  # not a multiple of 4: the last shard holds 2 partition padding ids
NCE_Q, NCE_WALK = 4, 2


def nce_store():
    from tpu_sage_torch.data.synthetic import sbm_store

    return sbm_store(n_nodes=NCE_NODES, n_classes=4, feat_dim=16, avg_degree=6, seed=6)


def nce_config(**kw):
    return step_config("mean", kw.pop("compute_dtype", "float32"), **kw)


def nce_levels(store, shard: int, shard_size: int, batch: int):
    """An injected NCE tree for ``shard``: anchors among its own train
    nodes, positives and negatives anywhere, the deeper levels anywhere."""
    rng = np.random.default_rng(200 + shard)
    train = store.folds["train"]
    own = train[(train // shard_size) == shard]
    roots = np.concatenate([rng.choice(own, size=batch),
                            rng.integers(0, store.n_nodes, size=batch * (1 + NCE_Q))])
    f1, f2 = STEP_FANOUTS
    return [roots.astype(np.int32),
            rng.integers(0, store.n_nodes, size=len(roots) * f1).astype(np.int32),
            rng.integers(0, store.n_nodes, size=len(roots) * f1 * f2).astype(np.int32)]


def walk_inputs(n_ranks: int, q: int = 24):
    """Each rank's walk starts and per-hop uniforms."""
    rng = np.random.default_rng(21)
    starts = rng.integers(0, NCE_NODES, size=(n_ranks, q)).astype(np.int32)
    us = rng.random(size=(n_ranks, NCE_WALK, q, 1)).astype(np.float32)
    return starts, us


def nce_checks(out_dir: str) -> None:
    """One partitioned NCE step on injected levels (f32, bf16); walks with
    injected uniforms; the negatives' range; ``fit_unsupervised_partitioned``
    with the probe, resume, degree-smoothed negatives, CSR and int8 shards,
    the measured race and hier2d over the group's own (host, chip) layout."""
    from tpu_sage_torch.data.synthetic import sbm_problem
    from tpu_sage_torch.dist.debug import assert_replicas_equal
    from tpu_sage_torch.dist.mesh import rank, world
    from tpu_sage_torch.dist.unsupervised import (PartitionedUnsupervisedTrainer,
                                                  draw_global_negatives,
                                                  fit_unsupervised_partitioned)
    from tpu_sage_torch.nn.params import flax_key
    from tpu_sage_torch.train.unsupervised import UnsupConfig

    torch.set_num_threads(1)
    r, n = rank(), world()
    store = nce_store()
    unsup = UnsupConfig(walk_length=NCE_WALK, n_negatives=NCE_Q)
    res = {}
    for dtype in ("float32", "bfloat16"):
        tr, graph, fold_ids, fold_w = PartitionedUnsupervisedTrainer.from_store(
            store, nce_config(compute_dtype=dtype), unsup, "cpu")
        state = tr.init_state()
        levels = [torch.from_numpy(lv) for lv in nce_levels(store, r, tr.shard_size,
                                                              tr.batch_per_shard)]
        state, m = tr.train_step(state, graph, fold_ids, fold_w, levels=levels)
        res[f"step/{dtype}/loss"] = m["loss"]
        res[f"step/{dtype}/fold_w"] = fold_w
        for name, p in tr.model.named_parameters():
            res[f"step/{dtype}/grad/{flax_key(name)}"] = p.grad.clone()
        if dtype == "float32":
            starts, us = walk_inputs(n)
            res["walk"] = tr.walk(graph, torch.from_numpy(starts[r]),
                                  [torch.from_numpy(u) for u in us[r]])[0]
            res["n_real"] = tr.n_real_nodes
            gen = torch.Generator().manual_seed(r)
            res["negatives"] = draw_global_negatives(20_000, tr.n_real_nodes, None, gen, "cpu")

    problem = sbm_problem(n_nodes=600, n_classes=4, feat_dim=32, avg_degree=8, p_in=0.95,
                          feat_noise=1.0, seed=11)
    cfg = step_config("mean", "float32", batch_size=128, epochs=3, n_train_samples=(8, 4),
                      n_val_samples=(8, 4), output_dims=(32, 32), lr_init=0.005)
    tr, state, hist = fit_unsupervised_partitioned(problem.store, cfg,
                                                   UnsupConfig(walk_length=2, n_negatives=5),
                                                   log=lambda d: None, device="cpu")
    assert_replicas_equal(state.model, "params")
    res["fit/hist"] = hist
    res["fit/embed"] = tr.embed_fold(state, problem.store, problem.folds["train"])

    small = step_config("mean", "float32", batch_size=64, epochs=2, n_train_samples=(5, 3),
                        n_val_samples=(5, 3), output_dims=(16, 16), lr_init=0.01)
    ck = os.path.join(out_dir, "u.npz")
    for epochs in (2, 4):
        recs = []
        fit_unsupervised_partitioned(store, small.replace(epochs=epochs),
                                     UnsupConfig(walk_length=2), log=recs.append,
                                     resume_from=ck, checkpoint_every=1, device="cpu")
        res[f"resume/{epochs}"] = recs
    for label, kw, fit_kw in (
            ("smoothed", {}, dict(unsup=UnsupConfig(walk_length=2, n_negatives=4,
                                                    neg_power=0.75))),
            ("csr", {}, dict(csr=True)),
            ("int8_csr", dict(feature_int8=True, compute_dtype="bfloat16"), dict(csr=True)),
            ("measured", dict(halo="measured", halo_measure_steps=2), dict(probe=False)),
            ("hier2d", dict(halo="hier2d", lr_init=0.005), {})):
        recs = []
        fit_kw.setdefault("unsup", UnsupConfig(walk_length=2, n_negatives=4))
        cfg_l = nce_config(**{**dict(batch_size=64, epochs=2, n_train_samples=(5, 3),
                                     n_val_samples=(5, 3), output_dims=(16, 16)), **kw})
        tr, state, hist = fit_unsupervised_partitioned(store, cfg_l, log=recs.append,
                                                       device="cpu", **fit_kw)
        assert_replicas_equal(state.model, label)
        res[f"mode/{label}/log"] = recs
        res[f"mode/{label}/halo"] = tr.halo_mode
        if label == "smoothed":
            res["mode/smoothed/neg_logits"] = tr.neg_logits
    _save(out_dir, res)
