"""The redesigned f32-W ``mean_project`` and owner-masked fanout mean, on the
CPU: the f32 kernel's launch plan (a pure function the card's launch
takes), the owned mean's plain version skipping rows it does not own
bitwise as it adds them as +0.0, and the f32 main path's training steps
against the JAX package at a few thousand nodes.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_sage.data.synthetic import sbm_problem as j_sbm_problem
from tpu_sage.train import losses as jlosses
from tpu_sage.train import trainer as jtrainer
from tpu_sage_torch.data.synthetic import sbm_problem
from tpu_sage_torch.kernels import mean_project as mp
from tpu_sage_torch.kernels.gather_mean import (gather_fanout_mean_owned,
                                                gather_fanout_mean_owned_reference, reciprocal)
from tpu_sage_torch.nn.params import load_flax_params
from tpu_sage_torch.train import trainer

SMEM = 232_448
# the f32 kernel's warps (csrc/mean_project.cu): 4 product warps, 11 reducers
PRODUCT_WARPS, REDUCER_WARPS = 4, 11


def _shares(b, grid):
    """Each block's roots as the kernel splits them (an even share)."""
    per, extra = divmod(b, grid)
    return [per + (i < extra) for i in range(grid)]


def _check_f32_plan(b, f, d, o, x_ptr, n_sm=132):
    plan = mp.f32_plan(b, f, d, o, x_ptr, n_sm)
    shares = _shares(b, plan["grid"])
    assert plan["grid"] == min(b, n_sm) and sum(shares) == b
    assert max(shares) - min(shares) <= 1
    assert plan["smem"] <= SMEM
    assert plan["v"] == (2 if d % 2 == 0 and x_ptr % 8 == 0 else 1)
    assert plan["kc"] == 32 * plan["v"] and plan["kc"] % plan["kw"] == 0
    assert plan["o_pad"] % 4 == 0 and o <= plan["o_pad"] < o + 4
    tb = plan["tb"]
    assert tb % 4 == 0 and 4 <= tb <= 16
    # the product's items of (4 roots, 128 columns) fill the product warps,
    # K split among them when there are fewer items than warps
    items = (tb // 4) * -(-plan["o_pad"] // 128)
    assert plan["ks"] == (1 if items >= PRODUCT_WARPS else PRODUCT_WARPS // items)
    assert 1 <= plan["ni"] <= 4 and plan["ni"] * PRODUCT_WARPS >= items * plan["ks"]
    assert plan["ni"] == -(-items * plan["ks"] // PRODUCT_WARPS)
    assert 1 <= plan["fb"] <= min(f, 32)
    # a reducer never waits on a mean slot two uses back
    assert (plan["ms"] - 1) * tb >= REDUCER_WARPS
    assert 16 * (plan["ms"] + plan["nwb"]) <= 512
    assert plan["smem"] == (512 + REDUCER_WARPS * 2 * plan["fb"] * plan["kc"] * 4
                            + plan["ms"] * tb * plan["kc"] * 4
                            + plan["nwb"] * plan["kw"] * plan["o_pad"] * 4
                            + (PRODUCT_WARPS * 32 * 16 * 4 if plan["ks"] > 1 else 0))
    return plan


@pytest.mark.parametrize("b, f, d, o, x_ptr, tb, v, fb, ks, kw, nwb", [
    (512, 25, 602, 128, 1 << 20, 4, 2, 25, 4, 64, 2),    # the main path's layer 0: one tile a block
    (512, 25, 256, 128, 1 << 20, 4, 2, 25, 4, 64, 2),    # layer 1
    (6144, 25, 602, 128, 1 << 20, 16, 2, 25, 1, 32, 3),  # the f32 NCE layer: three 16-root tiles
    (6143, 25, 602, 128, 1 << 20, 16, 2, 25, 1, 32, 3),  # ragged
    (12800, 10, 602, 128, 1 << 20, 16, 2, 10, 1, 64, 4),  # seven tiles a block
    (511, 25, 602, 128, 1 << 20, 4, 2, 25, 4, 64, 2),
    (700, 10, 602, 100, 1 << 20, 8, 2, 10, 2, 64, 4),    # O = 100
    (512, 25, 602, 41, 1 << 20, 4, 2, 25, 4, 64, 4),     # O = 41: W padded to 44 columns
    (512, 25, 601, 128, 1 << 20, 4, 1, 25, 4, 32, 4),    # odd D: float words
    (512, 25, 602, 128, (1 << 20) + 4, 4, 1, 25, 4, 32, 4),  # x 4 bytes off: float words
    (512, 40, 602, 64, 1 << 20, 4, 2, 32, 4, 8, 3),      # F above 32: batches of 32 rows
    (1, 1, 1, 1, 1 << 20, 4, 1, 1, 4, 32, 4),
    (64, 25, 602, 1816, 1 << 20, 4, 2, 25, 1, 4, 2),     # the widest O the old kernel took
    (512, 25, 14520, 1, 1 << 20, 4, 2, 25, 4, 64, 4),    # the widest D the old kernel took
    (512, 25, 602, 2048, 1 << 20, 4, 2, 25, 1, 4, 2),
])
def test_f32_plan_tiles_words_and_w_ring(b, f, d, o, x_ptr, tb, v, fb, ks, kw, nwb):
    plan = _check_f32_plan(b, f, d, o, x_ptr)
    assert (plan["tb"], plan["v"], plan["fb"], plan["ks"], plan["kw"], plan["nwb"]) == \
        (tb, v, fb, ks, kw, nwb)
    # within 196 KB, which leaves the L1 room for x's copies, where x paces
    # the tile; W's ring may take all the room where W does
    assert plan["smem"] <= 196 * 1024 or tb * f < plan["o_pad"]


def test_f32_plan_takes_every_shape_the_earlier_kernel_took():
    """The earlier f32 kernel took every (D, O) whose 4 (4 D + 32 O) bytes of
    shared memory fit a block, at any B and F; the plan takes all of them
    (and more), for x 4- and 8-byte aligned and on fewer SMs."""
    for d in (1, 2, 3, 64, 255, 301, 601, 602, 1024, 4096, 9999, 14520):
        for o in (1, 3, 32, 41, 100, 127, 128, 129, 256, 500, 1000, 1500, 1815):
            if 16 * d + 128 * o > SMEM:
                continue
            for b, f, ptr, n_sm in ((512, 25, 1 << 20, 132), (6144, 10, (1 << 20) + 4, 132),
                                    (37, 3, 1 << 20, 114)):
                _check_f32_plan(b, f, d, o, ptr, n_sm)


def test_f32_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="O <= 2048"):
        mp.f32_plan(512, 25, 602, 2049, 1 << 20)
    with pytest.raises(ValueError, match="4-byte aligned"):
        mp.f32_plan(512, 25, 602, 128, (1 << 20) + 2)
    with pytest.raises(ValueError, match=">= 1"):
        mp.f32_plan(0, 25, 602, 128, 1 << 20)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_owned_mean_skipping_rows_not_owned_equals_adding_zero_bitwise(dtype):
    """The kernel skips an id it does not own; the plain version adds a +0.0
    row for it. Both are the same bits: the sum starts at +0.0, a sum is
    -0.0 only when both terms are, so acc + (+0.0) == acc. Rows holding
    -0.0 (and a root whose owned rows are all -0.0) are among the owned."""
    rng = np.random.default_rng(12)
    n, d, f, lo, m = 300, 37, 10, 100, 120
    vals = rng.normal(size=(n, d)).astype(np.float32)
    vals[100:140] = -0.0
    vals[150:160, ::3] = -0.0
    if dtype == torch.int8:
        table = torch.from_numpy(np.clip(np.round(vals * 40), -127, 127).astype(np.int8))
    else:
        table = torch.from_numpy(vals).to(dtype)
    ids = rng.integers(0, n, (64 * f,)).astype(np.int32)
    ids[:f] = rng.integers(100, 140, f)             # owned rows, all -0.0
    ids[f:2 * f] = 5                                 # nothing owned
    ids[2 * f:3 * f] = [lo, lo + m - 1, lo - 1, lo + m, 150, 151, 152, 153, 0, n - 1]
    ids = torch.from_numpy(ids)
    local = table[lo:lo + m]
    ref = gather_fanout_mean_owned_reference(local, ids, f, lo)
    assert torch.equal(gather_fanout_mean_owned(local, ids, f, lo).view(torch.int32),
                       ref.view(torch.int32))

    # the kernel's order: only the owned rows, in j order, from +0.0
    rows = ids.view(-1, f).long() - lo
    skip = torch.zeros((rows.shape[0], d), dtype=torch.int32 if dtype == torch.int8
                       else torch.float32)
    for j in range(f):
        owned = (rows[:, j] >= 0) & (rows[:, j] < m)
        add = local[rows[owned, j]]
        skip[owned] = skip[owned] + (add.to(torch.int32) if dtype == torch.int8 else add.float())
    skip = skip.float() * reciprocal(f)
    assert torch.equal(skip.view(torch.int32), ref.view(torch.int32))
    assert not torch.signbit(ref[:2]).any() and not ref[:2].any()  # zero sums are +0.0


def _config(**kw):
    base = dict(batch_size=64, epochs=1, n_train_samples=(25, 10), n_val_samples=(25, 10),
                output_dims=(128, 128), lr_init=0.01, seed=5)
    base.update(kw)
    return base


def test_f32_main_path_steps_match_the_reference_at_a_few_thousand_nodes():
    """The f32 main path's configuration (mean, identity, fanouts (25, 10),
    dims (128, 128), Adam at 0.01, ``compute_dtype`` float32, the default)
    at batch 64 on a 3,000-node SBM store: three steps from identical
    parameters on injected levels give the reference's losses (rtol 1e-4)
    and parameters (1e-4 of each leaf's scale)."""
    n, feat = 3000, 64
    jp = j_sbm_problem(n_nodes=n, n_classes=8, feat_dim=feat, avg_degree=10, seed=4)
    tp = sbm_problem(n_nodes=n, n_classes=8, feat_dim=feat, avg_degree=10, seed=4)
    jcfg, tcfg = jtrainer.TrainConfig(**_config()), trainer.TrainConfig(**_config())
    assert tcfg.compute_dtype == jcfg.compute_dtype == "float32"
    rng = np.random.default_rng(9)
    batches = []
    for _ in range(3):
        ids = rng.integers(0, n, 64).astype(np.int32)
        batches.append([ids, rng.integers(0, n, 64 * 25).astype(np.int32),
                        rng.integers(0, n, 64 * 250).astype(np.int32)])

    jmodel = jtrainer.build_model(jcfg, jp.n_nodes, jp.n_classes)
    feats = jnp.asarray(jp.store.feats)
    params = jmodel.init(jax.random.key(0), [jnp.asarray(l) for l in batches[0]], feats)
    tx = jtrainer.build_optimizer(jcfg, 10)
    opt_state = tx.init(params)
    tree = jax.tree_util.tree_map(np.asarray, params)
    jl = []
    for lv in batches:
        lv = [jnp.asarray(l) for l in lv]
        targets = jnp.asarray(jp.store.targets[np.asarray(lv[0])], jnp.int32)
        loss, grads = jax.value_and_grad(
            lambda p: jlosses.cross_entropy(jmodel.apply(p, lv, feats), targets))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        jl.append(float(loss))

    tmodel = trainer.build_model(tcfg, tp.n_nodes, tp.n_classes, tp.feats_dim)
    tr = trainer.Trainer(tmodel, tcfg, 10, task=tp.task)
    graph = tp.device_graph(train=True, device="cpu")
    assert graph.feats.dtype == torch.float32
    state = tr.init_state(graph)
    load_flax_params(tmodel, tree)
    tl = []
    for lv in batches:
        lv = [torch.from_numpy(l) for l in lv]
        state, m = tr.train_step(state, graph, lv[0], graph.targets[lv[0].long()], levels=lv)
        tl.append(float(m["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    from tpu_sage_torch.nn.params import flax_params

    want = dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, params)))
    got = jax.tree_util.tree_leaves_with_path(flax_params(tmodel))
    assert len(got) == len(want)
    for path, value in got:
        ref = want[path]
        np.testing.assert_allclose(value, ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=jax.tree_util.keystr(path))
