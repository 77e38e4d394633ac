"""The port's 2-D layouts at 4 gloo ranks laid out (2, 2): the hierarchical
``hier2d`` exchange (tpu_sage_torch/dist/halo.py::dist_gather_2d) against
the JAX package's ``dist_gather_2d`` on a (2, 2) ``(host, chip)`` mesh of 4
of the 8 CPU devices and against the port's flat exchange; hier2d training
against exact's (the JAX test's 2e-3), its evaluations and a checkpoint
across layouts; tensor parallelism (tpu_sage_torch/dist/data_parallel.py,
``model_axis``) over ``(data, model)`` = (2, 2) against the single-device
step within the JAX test's tolerances (loss rtol 1e-5, parameters rtol 1e-4
and atol 1e-6), its split rule against JAX's ``param_shardings``, the
split Adam moments and its checkpoint. One group of ranks
(tests/torch_dist_workers.py::hier2d_tp_checks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tests import torch_dist_workers as W
from tpu_sage.dist import halo as jhalo
from tpu_sage.dist.data_parallel import param_shardings as j_param_shardings
from tpu_sage.dist.mesh import make_mesh
from tpu_sage_torch.dist.data_parallel import param_shardings, split_kernels
from tpu_sage_torch.dist.partition import pad_to_shards
from tpu_sage_torch.dist.train import PartitionedTrainer, halo_candidates
from tpu_sage_torch.nn.full_graph import embed_all_nodes
from tpu_sage_torch.nn.params import flax_key, flax_params
from tpu_sage_torch.train.checkpoint import load_checkpoint
from tpu_sage_torch.train.trainer import Trainer, build_model, fold_metric_np

WORLD = 4
TABLES = ["f32", "bf16", "int8"]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("hier2d")
    W.spawn_ranks(W.hier2d_tp_checks, WORLD, str(out))
    return out, [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def mesh2d(eight_devices):
    return make_mesh(n_devices=WORLD, axis_names=("host", "chip"), shape=(2, 2))


def _per_rank(ranks, key):
    return np.concatenate([ranks[r][key].float().numpy() for r in range(WORLD)])


def _jax_2d(mesh, table_name, fanout=None):
    tables, ids, _ = W.halo_inputs(WORLD)
    t = jnp.asarray(tables[table_name])
    t = t.astype(jnp.bfloat16) if table_name == "bf16" else t
    ax = ("host", "chip")
    fn = shard_map(lambda tt, ii: jhalo.dist_gather_2d(tt, ii, "host", "chip", fanout=fanout),
                   mesh=mesh, in_specs=(P(ax), P(ax)), out_specs=P(ax), check_vma=False)
    return np.asarray(jax.jit(fn)(t, jnp.asarray(ids.reshape(-1))).astype(jnp.float32))


def test_the_layout_is_row_major(port):
    _, ranks = port
    assert [ranks[r]["layout"] for r in range(WORLD)] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("name", TABLES)
def test_dist_gather_2d_is_bitwise_jax_and_the_flat_exchange(port, mesh2d, name):
    _, ranks = port
    tables, ids, _ = W.halo_inputs(WORLD)
    got = _per_rank(ranks, f"h2/{name}")
    np.testing.assert_array_equal(got, _jax_2d(mesh2d, name))
    np.testing.assert_array_equal(got, _per_rank(ranks, f"flat/{name}"))
    want = tables[name][ids.reshape(-1)].astype(np.float32)
    if name == "bf16":
        want = torch.from_numpy(want).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert ranks[0][f"h2/{name}"].dtype == ranks[0][f"flat/{name}"].dtype


@pytest.mark.parametrize("name", TABLES)
def test_dist_gather_2d_fanout_is_jax_within_1e6_of_scale(port, mesh2d, name):
    """Each owner's f32 partial means are bitwise JAX's (the flat exchange's
    test holds them per shard); the two-stage sum, within the host then
    across hosts, adds them in another order than JAX's two psum_scatters."""
    _, ranks = port
    want = _jax_2d(mesh2d, name, fanout=W.FANOUT)
    got = _per_rank(ranks, f"h2mean/{name}")
    assert ranks[0][f"h2mean/{name}"].dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_hier2d_training_matches_exact_and_learns(port):
    """The same batches on the same shards (the shard of rank host·2 + chip
    is the flat layout's): per-step losses within the JAX test's rtol 2e-3
    of exact's, falling, sampled val above 0.5."""
    _, ranks = port
    h, e = ranks[0]["train/hier2d/losses"], ranks[0]["train/exact/losses"]
    assert ranks[0]["train/hier2d/halo"] == "hier2d" and len(h) == W.H2_STEPS
    assert np.isfinite(h).all() and h[-1] < h[0] * 0.8, h
    np.testing.assert_allclose(h, e, rtol=2e-3)
    assert ranks[0]["train/hier2d/val"] > 0.5


def test_exact_evaluation_over_the_2d_layout_is_the_single_device_pass(port):
    _, ranks = port
    store = W.train_store()
    model = build_model(W.h2_config(), store.n_nodes, store.n_classes, store.feat_dim)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(ranks[0]["train/hier2d/state"][name])
    want = embed_all_nodes(model, store.to_device(train=False, device="cpu"), chunk=64,
                           with_head=True).numpy()
    ids = store.folds["val"]
    for r in range(WORLD):
        got = ranks[r]["train/hier2d/logits"].numpy()
        assert got.shape[0] == pad_to_shards(store.n_nodes, WORLD)[1]
        np.testing.assert_allclose(got[:store.n_nodes], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        assert ranks[r]["train/hier2d/val_exact"] == fold_metric_np(store.task, want[ids],
                                                                    store.targets[ids])


def test_halo_candidates():
    """The measured race: exact and hier2d on a 2-D layout, the flat modes
    on a flat one, exact alone at one shard (tpu_sage/dist/train.py:90-107)."""
    assert halo_candidates(4, two_d=True) == ["exact", "hier2d"]
    assert halo_candidates(4) == ["exact", "ring", "pipelined"]
    assert halo_candidates(1, two_d=True) == halo_candidates(1) == ["exact"]


def test_hier2d_on_a_flat_layout_raises():
    store = W.hop_store()
    cfg = W.h2_config(halo="hier2d", batch_size=32, n_train_samples=(3, 2),
                      n_val_samples=(3, 2), output_dims=(16, 16))
    with pytest.raises(ValueError, match="hier2d"):
        PartitionedTrainer.from_store(store, cfg, "cpu")


def test_checkpoint_resumes_across_the_flat_and_2d_layouts(port):
    """A flat exact run's checkpoint resumes on the (2, 2) hier2d layout at
    the epoch after its step."""
    out, ranks = port
    recs, hist = ranks[0]["resume/log"], ranks[0]["resume/hist"]
    assert {"n_shards": WORLD, "halo": "hier2d", "layout": [2, 2]} in recs
    resumed = next(r for r in recs if "resumed_from" in r)
    assert resumed["resumed_from"] == str(out / "topo.npz") and resumed["start_epoch"] == 2
    assert [h["epoch"] for h in hist] == [2, 3]
    assert hist[-1]["val_metric"] > 0.5


# -- tensor parallelism ----------------------------------------------------------

def _tp_single_device():
    problem = W.tp_problem()
    cfg = W.step_config("mean", "float32", batch_size=W.TP_BATCH)
    model = build_model(cfg, problem.n_nodes, problem.n_classes, problem.feats_dim)
    tr = Trainer(model, cfg, steps_per_epoch=4, task=problem.task)
    graph = problem.device_graph(train=True, device="cpu")
    state = tr.init_state(graph)
    levels = [torch.from_numpy(lv) for lv in W.tp_levels(problem)]
    state, m = tr.train_step(state, graph, levels[0], graph.targets[levels[0].long()],
                             levels=levels)
    return problem, cfg, model, state, float(m["loss"])


def test_tp_split_rule_is_the_jax_packages(eight_devices):
    """Every 2-D leaf named kernel split along its output dimension over the
    model axis, everything else replicated, as JAX's ``param_shardings``
    places the same tree on a (data, model) = (2, 2) mesh."""
    problem, cfg, model, _, _ = _tp_single_device()
    mesh = make_mesh(n_devices=WORLD, axis_names=("data", "model"), shape=(2, 2))
    specs = j_param_shardings(flax_params(model), mesh, "model")
    want = {"/".join(str(getattr(k, "key", k)) for k in path): s.spec
            for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]}
    got = param_shardings(model, "model")
    assert sorted(got) == sorted(want)
    for k, spec in got.items():
        assert P(*spec) == want[k], k
    assert any(spec for spec in got.values()) and not all(got.values())
    assert set(param_shardings(model, None).values()) == {()}


def test_tp_step_matches_the_single_device_step(port):
    _, ranks = port
    problem, cfg, model, state, loss = _tp_single_device()
    for r in range(WORLD):
        data, part = divmod(r, 2)
        np.testing.assert_allclose(float(ranks[r]["tp/loss"]), loss, rtol=1e-5)
        for name, p in model.named_parameters():
            k = flax_key(name)
            want = p.detach().numpy()
            if param_shardings(model, "model")[k]:
                w = want.shape[1] // 2
                want = want[:, part * w:(part + 1) * w]
            np.testing.assert_allclose(ranks[r][f"tp/param/{k}"].numpy(), want, rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        assert np.isfinite(ranks[r]["tp/step_after_save"])


def test_tp_adam_moments_are_split_with_their_kernels(port):
    _, ranks = port
    problem, cfg, model, state, _ = _tp_single_device()
    for r in range(WORLD):
        for name, p in model.named_parameters():
            k = flax_key(name)
            got, par = ranks[r][f"tp/exp_avg/{k}"], ranks[r][f"tp/param/{k}"]
            assert got.shape == par.shape, k
            if param_shardings(model, "model")[k]:
                assert par.shape[1] * 2 == p.shape[1], k


def test_tp_checkpoint_loads_into_the_single_device_model(port):
    out, _ = port
    problem, cfg, model, state, _ = _tp_single_device()
    m2 = build_model(cfg, problem.n_nodes, problem.n_classes, problem.feats_dim)
    tr = Trainer(m2, cfg, steps_per_epoch=4, task=problem.task)
    st = load_checkpoint(str(out / "tp.npz"), tr.init_state(
        problem.device_graph(train=True, device="cpu")))
    assert st.step == 1
    for (name, a), b in zip(model.named_parameters(), m2.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(st.optimizer.state[b]["exp_avg"].numpy(),
                                   state.optimizer.state[a]["exp_avg"].numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=name)


def test_tp_uneven_width_raises(port):
    """A head of 3 classes over 2 model shards: JAX's ``device_put`` refuses
    it, and so does the port, naming the leaf and the sizes."""
    _, ranks = port
    problem = W.tp_problem()
    model = build_model(W.step_config("mean", "float32"), problem.n_nodes, 3, problem.feats_dim)
    with pytest.raises(ValueError, match=r"params/fc/kernel: output width 3 .* 2 shards"):
        split_kernels(model, 2)
    assert "params/fc/kernel" in ranks[0]["tp/uneven"]
