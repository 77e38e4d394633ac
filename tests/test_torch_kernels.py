"""tpu_sage_torch kernels' plain versions against the JAX package's kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs its
Pallas kernels in interpret mode, as tests/test_kernels.py does. The CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py.
"""

import ast
import contextlib
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sage import ops as jops
from tpu_sage.kernels.gather import gather_rows as j_gather_rows
from tpu_sage.kernels.gather import gather_rows_bf16 as j_gather_rows_bf16
from tpu_sage.kernels.gather import gather_rows_blockspec as j_gather_rows_blockspec
from tpu_sage.kernels.gather_mean import gather_fanout_mean as j_fanout_mean
from tpu_sage.kernels.mean_project import mean_project as j_mean_project
from tpu_sage.kernels.select import select_columns_pallas
from tpu_sage.sample.sampler import select_columns as j_select_columns
from tpu_sage_torch import kernels, ops
from tpu_sage_torch.kernels import _build
from tpu_sage_torch.kernels import mean_project as mp
from tpu_sage_torch.kernels.gather import gather_plan, gather_rows, gather_rows_into
from tpu_sage_torch.kernels.gather_blockspec import gather_rows_blockspec
from tpu_sage_torch.kernels.gather_mean import gather_fanout_mean, word_elements
from tpu_sage_torch.kernels.mean_project import mean_project
from tpu_sage_torch.kernels.neighbor_max import neighbor_max
from tpu_sage_torch.kernels.neighbor_mean import neighbor_mean
from tpu_sage_torch.kernels.sample_hop import sample_hop
from tpu_sage_torch.kernels.select import select_columns


def _bf16_bits_torch(t):
    return t.contiguous().view(torch.int16).numpy()


def _bf16_bits_jax(a):
    return np.asarray(a).view(np.int16)


def _bf16_ulps(a_bits, b_bits):
    """Distance in bf16 ulps between two arrays of bf16 bit patterns (int16):
    the patterns mapped to a monotone integer line, -0 and +0 both 0."""
    def line(bits):
        bits = bits.astype(np.int32)
        return np.where(bits < 0, -(bits & 0x7FFF), bits)
    return np.abs(line(a_bits) - line(b_bits))


def test_select_columns_matches_pallas_and_xla():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 1000, (100, 32)).astype(np.int32)
    cols = rng.integers(-4, 36, (100, 7)).astype(np.int32)  # includes out-of-range
    pallas = np.asarray(select_columns_pallas(jnp.asarray(rows), jnp.asarray(cols),
                                              tile_b=16, interpret=True))
    xla = np.asarray(j_select_columns(jnp.asarray(rows), jnp.asarray(cols)))
    ours = select_columns(torch.from_numpy(rows), torch.from_numpy(cols))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), pallas)
    np.testing.assert_array_equal(ours.numpy(), xla)
    assert (ours.numpy()[(cols < 0) | (cols >= 32)] == 0).all()


@pytest.mark.parametrize("n,d,q", [(1000, 128, 700), (500, 384, 64), (300, 301, 10), (50, 1, 9)])
def test_gather_rows_int32_matches_pallas(n, d, q):
    rng = np.random.default_rng(2)
    table = rng.integers(0, 2**31 - 1, (n, d)).astype(np.int32)
    ids = rng.integers(0, n, q).astype(np.int32)
    want = np.asarray(j_gather_rows(jnp.asarray(table), jnp.asarray(ids),
                                    block_q=8, interpret=True))
    ours = gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(ours.numpy(), want)


def test_gather_rows_bf16_matches_pallas_bitwise():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((400, 602)).astype(np.float32)
    ids = rng.integers(0, 400, 90).astype(np.int32)
    want = j_gather_rows_bf16(jnp.asarray(table, jnp.bfloat16), jnp.asarray(ids),
                              block_q=32, interpret=True)
    ours = gather_rows(torch.from_numpy(table).to(torch.bfloat16), torch.from_numpy(ids))
    np.testing.assert_array_equal(_bf16_bits_torch(ours), _bf16_bits_jax(want))


@pytest.mark.parametrize("dtype", ["int32", "bfloat16"])
def test_gather_rows_blockspec_matches_pallas_bitwise(dtype):
    """Reference: JAX's gather_rows_blockspec in interpret mode (one row per
    grid step), which runs on the CPU; bitwise for int32 and bf16 tables."""
    rng = np.random.default_rng(8)
    n, d, q = 120, 602 if dtype == "bfloat16" else 40, 37
    ids = rng.integers(0, n, q).astype(np.int32)
    if dtype == "int32":
        table = rng.integers(-2**31, 2**31 - 1, (n, d)).astype(np.int32)
        want = np.asarray(j_gather_rows_blockspec(jnp.asarray(table), jnp.asarray(ids),
                                                  interpret=True))
        ours = gather_rows_blockspec(torch.from_numpy(table), torch.from_numpy(ids))
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), want)
    else:
        table = rng.standard_normal((n, d)).astype(np.float32)
        want = j_gather_rows_blockspec(jnp.asarray(table, jnp.bfloat16), jnp.asarray(ids),
                                       interpret=True)
        ours = gather_rows_blockspec(torch.from_numpy(table).to(torch.bfloat16),
                                     torch.from_numpy(ids))
        np.testing.assert_array_equal(_bf16_bits_torch(ours), _bf16_bits_jax(want))


def test_gather_rows_blockspec_clamps_out_of_range_ids_like_gather_rows():
    table = torch.arange(30, dtype=torch.int32).view(10, 3)
    ids = torch.tensor([-1, -3, -10, -11, -30, 10, 11, 3, 0, 9], dtype=torch.int32)
    np.testing.assert_array_equal(gather_rows_blockspec(table, ids).numpy(),
                                  gather_rows(table, ids, "clamp").numpy())


@pytest.mark.parametrize("form", ["plain", "masked"])
@pytest.mark.parametrize("shape", [(10,), (10, 3)])
def test_row_gather_out_of_bounds_semantics(form, shape):
    """plain: a negative id wraps once by n, then clamps (JAX indexing);
    masked: zero rows. Both exact against tpu_sage.ops.row_gather."""
    table = np.arange(np.prod(shape), dtype=np.int32).reshape(shape) + 1
    ids = np.array([[-1, -3, -10, -11, -30], [10, 11, 3, 0, 9]], dtype=np.int32)
    want = np.asarray(jops.row_gather(jnp.asarray(table), jnp.asarray(ids), form=form))
    ours = ops.row_gather(torch.from_numpy(table), torch.from_numpy(ids), form=form)
    assert tuple(ours.shape) == want.shape
    np.testing.assert_array_equal(ours.numpy(), want)


def test_row_gather_rejects_unknown_form():
    with pytest.raises(ValueError, match="unknown gather form"):
        ops.row_gather(torch.zeros(4, 2), torch.zeros(3, dtype=torch.int32), form="chunked")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_fanout_mean_matches_pallas(dtype):
    rng = np.random.default_rng(5)
    table = rng.normal(size=(300, 8)).astype(np.float32)
    ids = rng.integers(0, 300, size=50 * 4).astype(np.int32)
    jt = jnp.asarray(table, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = np.asarray(j_fanout_mean(jt, jnp.asarray(ids), fanout=4, tile_r=16, interpret=True))
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    ours = gather_fanout_mean(tt, torch.from_numpy(ids), 4)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (50, 8)
    np.testing.assert_allclose(ours.numpy(), want, rtol=1e-6)
    # and the ops-level entry (the model's deepest level) is the same function
    np.testing.assert_array_equal(ops.row_gather_fanout_mean(tt, torch.from_numpy(ids), 4).numpy(),
                                  ours.numpy())


def test_gather_fanout_mean_rejects_ragged_ids():
    with pytest.raises(ValueError, match="multiple of fanout"):
        gather_fanout_mean(torch.zeros(4, 2), torch.zeros(7, dtype=torch.int32), 3)


def test_mean_project_forward_and_grads_match_pallas():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(24, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16, 8)).astype(np.float32)

    want = np.asarray(j_mean_project(jnp.asarray(x), jnp.asarray(w), 8, True))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = mean_project(xt, wt)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5, atol=1e-6)

    def loss(x, w):
        return jnp.sum(jnp.square(j_mean_project(x, w, 8, True)))

    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    torch.sum(torch.square(out)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), rtol=1e-4, atol=1e-5)


def test_mean_project_bf16_keeps_dtype_and_f32_accumulation():
    """bf16 in, bf16 out; the mean is the f32 sum over j = 0, 1, ... divided
    by F and rounded once to bf16, the product accumulates in f32 and rounds
    once: within 1 bf16 ulp of that computed in f64 from the rounded mean."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(6, 25, 40)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32)).to(torch.bfloat16)
    out = mean_project(x, w)
    assert out.dtype == torch.bfloat16
    meanx = (x.float().sum(1) / 25).to(torch.bfloat16)
    exact = (meanx.double() @ w.double()).to(torch.bfloat16)
    assert _bf16_ulps(_bf16_bits_torch(out), _bf16_bits_torch(exact)).max() <= 1
    # the unrounded mean gives a different product: the rounding is the contract
    unrounded = (x.double().mean(1) @ w.double()).to(torch.bfloat16)
    assert not torch.equal(unrounded, out)


@pytest.mark.parametrize("shape", [(24, 5, 16, 8), (37, 25, 602, 16), (9, 10, 256, 24)])
def test_mean_project_bf16_rounds_the_mean_as_jax_does(shape):
    """The port's bf16 mean_project against two JAX references on the same
    inputs, within 1 bf16 ulp of each output: the Pallas kernel in interpret
    mode, and jnp.mean (a bf16 result) followed by the dot with an f32
    accumulator, rounded to bf16."""
    b, f, d, o = shape
    rng = np.random.default_rng(d)
    x = rng.normal(size=(b, f, d)).astype(np.float32)
    w = (rng.normal(size=(d, o)) / np.sqrt(d)).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    pallas = j_mean_project(jx, jw, 8, True)
    xla = jnp.dot(jnp.mean(jx, 1), jw, preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    ours = mean_project(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16))
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (b, o)
    for ref in (pallas, xla):
        assert _bf16_ulps(_bf16_bits_torch(ours), _bf16_bits_jax(ref)).max() <= 1


@pytest.mark.parametrize("shape", [(24, 5, 16, 8), (9, 25, 66, 24), (7, 10, 33, 16)])
def test_mean_project_f32_rows_under_bf16_weights_match_flax_dense(shape):
    """f32 rows (a linear or node-embedding prep's output) with a bf16 W, as
    the JAX package's mean aggregator computes them: ``fc_neigh(jnp.mean(x))``
    under ``Dense(dtype=bf16)``, which rounds the f32 mean to bf16 before the
    product. Out bf16 within 1 bf16 ulp of that (and not the product of the
    unrounded mean); dx (f32) and dW (bf16) within 1.5e-2 of their scale, the
    bf16 gradient tolerance of tests/test_torch_model.py."""
    b, f, d, o = shape
    rng = np.random.default_rng(d)
    x = rng.normal(size=(b, f, d)).astype(np.float32)
    w = (rng.normal(size=(d, o)) / np.sqrt(d)).astype(np.float32)
    g = rng.normal(size=(b, o)).astype(np.float32)
    jw = jnp.asarray(w, jnp.bfloat16)

    def flax_form(x, w):
        return jnp.dot(jnp.mean(x, 1).astype(jnp.bfloat16), w,
                       preferred_element_type=jnp.float32).astype(jnp.bfloat16)

    want, vjp = jax.vjp(flax_form, jnp.asarray(x), jw)
    jdx, jdw = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
    out = mean_project(xt, wt)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (b, o)
    assert _bf16_ulps(_bf16_bits_torch(out.detach()), _bf16_bits_jax(want)).max() <= 1
    unrounded = (xt.detach().double().mean(1) @ wt.detach().double()).to(torch.bfloat16)
    assert not torch.equal(unrounded, out.detach())
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert xt.grad.dtype == torch.float32 and wt.grad.dtype == torch.bfloat16
    for got, ref in ((xt.grad, jdx), (wt.grad, jdw)):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=1.5e-2 * np.abs(ref).max())


def test_mean_project_bf16_plan_for_f32_rows():
    """The bf16 kernel's launch shape for f32 rows: a stage holds rows whose
    bytes 16 divides (12 rows of the node-embedding prep's 666 f32 columns,
    32 KB beside a ring of W chunks; a linear prep's whole 4-root tile of
    64-wide rows beside its resident W), a 4-root unit is a 16-byte
    multiple, so x streams by bulk copies from an aligned base."""
    emb = mp.bf16_plan(512, 25, 666, 128, 1 << 20, x_bytes=4)
    assert emb["word"] == 16 and emb["g_rows"] == 12 and emb["smem"] <= 232_448
    assert not emb["resident"] and emb["n_wbufs"] == 7
    lin = mp.bf16_plan(512, 25, 64, 128, 1 << 20, x_bytes=4)
    assert lin["word"] == 16 and lin["g_rows"] == 100 and lin["resident"]
    for d, o in ((666, 128), (64, 128), (33, 16), (2048, 512)):
        plan = mp.bf16_plan(512, 10, d, o, (1 << 20) + 4, x_bytes=4)
        assert plan["word"] == 4 and (plan["g_rows"] * d * 4) % 16 == 0
        assert plan["smem"] <= 232_448


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("needs", [(True, True), (False, True), (True, False)])
def test_mean_project_backward_computes_only_the_grads_asked_for(dtype, needs):
    """dx only when x requires grad, dW only when W does; the grads that are
    computed are unchanged (the reference's VJP: dW = mean(x)^T g, dx = g W^T / F
    broadcast over the fanout)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(6, 5, 12)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.normal(size=(12, 8)).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32)).to(dtype)
    xa, wa = x.clone().requires_grad_(needs[0]), w.clone().requires_grad_(needs[1])
    mean_project(xa, wa).backward(g)
    if needs[0]:
        want = ((g @ w.t()) / 5).unsqueeze(1).expand_as(x)
        assert torch.equal(xa.grad, want)
    else:
        assert xa.grad is None
    if needs[1]:
        assert torch.equal(wa.grad, x.mean(dim=1).t() @ g)
    else:
        assert wa.grad is None


def test_mean_project_bf16_plan_at_main_path_shapes():
    """The bf16 kernel's launch shape at the main path's B = 512: a block
    owns one tile of 4 roots (128 blocks), 16-byte cp.async words for an
    aligned x (a 4-root tile at D = 602 is 120,400 bytes), 4-byte words for
    an x offset by 4 bytes, every W chunk resident beside the x ring, and
    shared memory within a Hopper block's 232,448 bytes."""
    layer0 = mp.bf16_plan(512, 25, 602, 128, 1 << 20)
    assert layer0["word"] == 16 and layer0["g_rows"] == 16 and layer0["n_wbufs"] == 10
    assert layer0["tb"] == 4 and layer0["grid"] == 128 and layer0["resident"]
    assert layer0["smem"] <= 232_448
    assert mp.bf16_plan(512, 25, 602, 128, (1 << 20) + 4)["word"] == 4
    assert mp.bf16_plan(512, 25, 602, 128, (1 << 20) + 8)["word"] == 8
    layer1 = mp.bf16_plan(512, 25, 256, 128, 1 << 20)
    assert layer1["word"] == 16 and layer1["g_rows"] == 64 and layer1["n_wbufs"] == 4
    for d, o in ((602, 128), (256, 128), (602, 256), (2048, 512), (7, 3)):
        plan = mp.bf16_plan(512, 10, d, o, 1 << 20)
        assert (plan["g_rows"] * d * 2) % 16 == 0 and plan["o_pad"] >= max(o, 16)
        assert plan["o_pad"] & (plan["o_pad"] - 1) == 0
        assert 1 <= plan["n_wbufs"] <= -(-d // 64) and plan["smem"] <= 232_448
    ring = mp.bf16_plan(512, 10, 602, 256, 1 << 20)
    assert ring["n_wbufs"] < 10 and not ring["resident"]  # W chunks form a ring
    with pytest.raises(ValueError, match="4-byte aligned"):
        mp.bf16_plan(512, 25, 602, 128, (1 << 20) + 2)
    with pytest.raises(ValueError, match="D <= 2048"):
        mp.bf16_plan(512, 25, 4096, 128, 1 << 20)
    # the widest W, 2048 x 1024, fits as a ring of one 64-row chunk buffer
    widest = mp.bf16_plan(512, 25, 2048, 1024, 1 << 20)
    assert widest["n_wbufs"] == 1 and widest["ksplit"] == 1 and widest["smem"] <= 232_448


def _smem_of(plan, d, x_bytes=2):
    """The layout csrc/mean_project.cu's Layout computes from a plan."""
    k16 = -(-d // 16) * 16
    ms = -(-(k16 // 2) // 32) * 32 + 4
    n_nt = -(-plan["tb"] // 8)
    xbuf = (plan["o_pad"] // 16) * n_nt * 512 if plan["ksplit"] == 2 else 0
    ring_off = -(-(128 + plan["tb"] * ms * 4 + xbuf) // 128) * 128
    slot = -(-(plan["g_rows"] * d * x_bytes) // 128) * 128
    nc = -(-d // 64)
    w = d * plan["o_pad"] * 2 if plan["n_wbufs"] >= nc else plan["n_wbufs"] * 64 * plan["o_pad"] * 2
    return ring_off + 3 * slot + w


@pytest.mark.parametrize("b, f, d, o, x_bytes, tb, grid, resident", [
    (512, 25, 602, 128, 2, 4, 128, True),      # row 5: the main path's layer 0
    (512, 25, 256, 128, 2, 4, 128, True),      # row 5: layer 1
    (512, 25, 602, 64, 2, 4, 128, True),       # row 5t: a model axis of 2's slice
    (512, 25, 256, 64, 2, 4, 128, True),
    (6144, 25, 602, 128, 2, 16, 132, False),   # row 5u: the NCE step's layers
    (6144, 25, 256, 128, 2, 16, 132, True),
    (512, 25, 64, 128, 4, 4, 128, True),       # row 5x: the preps' f32 rows
    (12800, 10, 64, 128, 4, 16, 132, True),
    (512, 25, 666, 128, 4, 4, 128, False),
    (12800, 10, 666, 128, 4, 16, 132, False),
    (1000, 10, 602, 128, 2, 16, 132, False),   # a ragged B: 250 units over 132 blocks
    (100, 25, 602, 128, 2, 4, 25, True),       # B < 132
    (1, 25, 602, 128, 2, 4, 1, True),          # B = 1
    (6144, 25, 601, 128, 2, 16, 132, False),   # an odd D (single columns, 8-byte words)
    (6144, 10, 602, 256, 2, 16, 132, False),   # O = 256: W in a ring of chunk buffers
])
def test_mean_project_bf16_plan_tiles_grid_and_w(b, f, d, o, x_bytes, tb, grid, resident):
    """The redesigned plan at every shape of rows 5, 5t, 5u and 5x and at
    the edges: roots per tile (4 while B fits one 4-root unit per SM, else
    16), a persistent grid of at most one block per SM over the 4-root
    units, W resident or a ring, and the kernel's shared-memory layout
    within 232,448 bytes."""
    plan = mp.bf16_plan(b, f, d, o, 1 << 20, x_bytes=x_bytes)
    assert (plan["tb"], plan["grid"], plan["resident"]) == (tb, grid, resident)
    assert plan["grid"] == min(-(-b // 4), 132) and plan["smem"] == _smem_of(plan, d, x_bytes)
    assert plan["smem"] <= 232_448 and (plan["g_rows"] * d * x_bytes) % 16 == 0
    assert resident == (plan["n_wbufs"] == -(-d // 64))
    pairs = (plan["o_pad"] // 16) * -(-plan["tb"] // 8)  # (16 columns, 8 roots) pairs
    assert pairs * plan["ksplit"] <= 128 and plan["ksplit"] == (2 if pairs <= 8 else 1)
    slot = plan["g_rows"] * d * x_bytes
    assert plan["g_rows"] <= -(-plan["tb"] * f // 8) * 8  # a slot holds at most a tile
    if resident:  # beside slots of 16 KB (one tile a block) or 32 KB, or a whole tile
        assert slot >= (16384 if b <= 4 * 132 else 32768) or plan["g_rows"] >= plan["tb"] * f
    else:  # the largest slots that leave W the fewest passes
        assert slot <= (32768 if b <= 4 * 132 else 49152)


@pytest.mark.parametrize("table_mod16", [0, 4, 8, 12])
@pytest.mark.parametrize("out_mod16", [0, 4, 8, 12])
def test_gather_plan_at_main_path_widths(table_mod16, out_mod16):
    """The gather's form at each base offset mod 16: 1,204-byte bf16 feature
    rows and 516-byte packed adjacency ‖ degree rows realign (16-byte loads,
    3 and 2 per lane, whatever the offsets); a 512-byte adjacency row moves
    as 16-byte words, one per lane, when both bases are 16-byte aligned and
    realigns otherwise; a 4-byte degree row puts 32 rows in a warp."""
    def plan(row_bytes):
        return gather_plan(row_bytes, table_mod16, out_mod16)

    assert plan(1204) == {"form": "realign", "word": 16, "lanes_per_row": 32,
                          "words_per_lane": 3}
    assert plan(516) == {"form": "realign", "word": 16, "lanes_per_row": 32,
                         "words_per_lane": 2}
    if table_mod16 == out_mod16 == 0:
        assert plan(512) == {"form": "words", "word": 16, "lanes_per_row": 32,
                             "words_per_lane": 0}
    else:
        assert plan(512) == {"form": "realign", "word": 16, "lanes_per_row": 32,
                             "words_per_lane": 2}
    assert plan(4) == {"form": "words", "word": 4, "lanes_per_row": 1, "words_per_lane": 0}


def test_gather_plan_narrow_and_unaligned_rows():
    """Rows of at most 128 bytes share a warp in power-of-two lane groups;
    rows of odd width keep 1-byte words; 2-byte-aligned rows (a 602-byte
    int8 row, a bf16 row at a 2-byte base offset) realign like 4-byte-aligned
    ones; wide rows realign in chunks of at most 4 words per lane."""
    assert gather_plan(8, 4, 0) == {"form": "words", "word": 4, "lanes_per_row": 2,
                                    "words_per_lane": 0}
    assert gather_plan(100, 0, 0)["lanes_per_row"] == 32
    assert gather_plan(64, 0, 0) == {"form": "words", "word": 16, "lanes_per_row": 4,
                                     "words_per_lane": 0}
    assert gather_plan(602, 0, 0) == {"form": "realign", "word": 16, "lanes_per_row": 32,
                                      "words_per_lane": 2}
    assert gather_plan(601, 0, 0)["word"] == 1 and gather_plan(1204, 2, 0)["word"] == 16
    assert gather_plan(1204, 2, 0)["form"] == "realign"
    assert gather_plan(2408, 0, 0)["words_per_lane"] == 4  # f32 602: two chunks
    assert gather_plan(4096, 0, 0)["form"] == "realign"
    for row_bytes in range(1, 3000, 7):
        for t in range(16):
            p = gather_plan(row_bytes, t, (3 * t) % 16)
            if p["form"] == "realign":
                assert row_bytes % 2 == 0 and t % 2 == 0 and 1 <= p["words_per_lane"] <= 4
                assert p["lanes_per_row"] in (8, 16, 32)
            else:
                assert row_bytes % p["word"] == 0 and t % p["word"] == 0
                assert p["lanes_per_row"] in (1, 2, 4, 8, 16, 32)


@pytest.mark.parametrize("row_bytes, mods, plan", [
    # PPI's 200-byte f32 rows: 14 words at most, 16 lanes, two rows a warp
    (200, (0, 0), {"form": "realign", "word": 16, "lanes_per_row": 16, "words_per_lane": 1}),
    (200, (4, 12), {"form": "realign", "word": 16, "lanes_per_row": 16, "words_per_lane": 1}),
    # the narrowest realigned rows: 10 and 9 words, 16 lanes; 8 lanes at most 8 words
    (136, (4, 0), {"form": "realign", "word": 16, "lanes_per_row": 16, "words_per_lane": 1}),
    (130, (2, 0), {"form": "realign", "word": 16, "lanes_per_row": 16, "words_per_lane": 1}),
    # the int8 step's 602-byte rows, 2-byte aligned: 39 words, not 301 2-byte ones
    (602, (0, 0), {"form": "realign", "word": 16, "lanes_per_row": 32, "words_per_lane": 2}),
    (602, (2, 14), {"form": "realign", "word": 16, "lanes_per_row": 32, "words_per_lane": 2}),
    # exact inference's f32 rows 256 and 512 wide, 16-byte aligned: words,
    # 2 and 4 per lane issued before the stores
    (1024, (0, 0), {"form": "words", "word": 16, "lanes_per_row": 32, "words_per_lane": 0}),
    (2048, (0, 0), {"form": "words", "word": 16, "lanes_per_row": 32, "words_per_lane": 0}),
    (1024, (8, 0), {"form": "realign", "word": 16, "lanes_per_row": 32, "words_per_lane": 3}),
    (2064, (0, 0), {"form": "realign", "word": 16, "lanes_per_row": 32, "words_per_lane": 4}),
])
def test_gather_plan_lanes_per_row_and_two_byte_realignment(row_bytes, mods, plan):
    """The realign form's lanes per row follow the row's span of aligned
    16-byte words (the smallest power of two of at least 8 that covers it,
    at most 32); 2-byte-aligned rows realign; 16-byte-aligned rows up to
    2,048 bytes move as 16-byte words; each realign plan's lanes and words
    per lane cover the span in at most 4 chunks."""
    got = gather_plan(row_bytes, *mods)
    assert got == plan
    if got["form"] == "realign":
        unit = 2 if (row_bytes | mods[0] | mods[1]) % 4 else 4
        span = (16 - unit + row_bytes + 15) // 16
        lanes = got["lanes_per_row"]
        assert lanes >= min(32, span) and (lanes == 8 or lanes // 2 < span)
        assert span <= 4 * lanes * got["words_per_lane"]


def test_gather_rows_into_runs_on_cuda_only():
    with pytest.raises(ValueError, match="runs on cuda"):
        gather_rows_into(torch.zeros(3, 2), torch.zeros(1, dtype=torch.int32), torch.zeros(1, 2))


def test_gather_fanout_mean_word_width():
    """bf16 rows move in the widest word dividing the row and the address: a
    602-wide row as bf16x2 words; f32 rows as 8-byte words."""
    assert word_elements(torch.zeros(4, 602, dtype=torch.bfloat16)) == 2
    assert word_elements(torch.zeros(4, 256, dtype=torch.bfloat16)) == 8
    assert word_elements(torch.zeros(4, 602)) == 2
    assert word_elements(torch.zeros(4, 7)) == 1
    assert word_elements(torch.zeros(4 * 602 + 1, dtype=torch.bfloat16)[1:].view(4, 602)) == 1


@pytest.mark.parametrize("call", [
    lambda t: select_columns(t.int(), t[:, :2].int()),
    lambda t: sample_hop(t.int(), t[:, 0].int(), t[:2, 0].int(), t[:2, :3]),
    lambda t: gather_rows(t, torch.zeros(2, dtype=torch.int32, device=t.device)),
    lambda t: gather_rows_blockspec(t, torch.zeros(2, dtype=torch.int32, device=t.device)),
    lambda t: gather_fanout_mean(t, torch.zeros(2, dtype=torch.int32, device=t.device), 2),
    lambda t: mean_project(t.view(2, 2, 4), torch.zeros(4, 3, device=t.device)),
    lambda t: neighbor_max(t.view(2, 2, 4), torch.zeros(2, dtype=torch.int32, device=t.device),
                           t[:2]),
    lambda t: neighbor_mean(t.view(2, 2, 4), torch.zeros(2, dtype=torch.int32, device=t.device),
                            t[:2]),
])
def test_wrappers_refuse_devices_other_than_cuda_and_cpu(call):
    """Plain versions run only for CPU tensors; anything else must reach the
    kernel path, which takes CUDA tensors only."""
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        call(torch.zeros(4, 4, device="meta"))


def test_require_checks_dtype_shape_and_contiguity():
    t = torch.zeros(4, 6)
    _build.require(t, "t", device=t.device, dtypes=(torch.float32,), ndim=2)
    with pytest.raises(TypeError):
        _build.require(t, "t", device=t.device, dtypes=(torch.int32,), ndim=2)
    with pytest.raises(ValueError, match="must be 3-D"):
        _build.require(t, "t", device=t.device, dtypes=(torch.float32,), ndim=3)
    with pytest.raises(ValueError, match="contiguous"):
        _build.require(t.t(), "t", device=t.device, dtypes=(torch.float32,), ndim=2)
    with pytest.raises(RuntimeError, match="cudaError_t 2"):
        _build.check_launch(2, "k")


def test_plain_versions_do_not_count_as_launches():
    kernels.reset_launch_counts()
    select_columns(torch.zeros(2, 3, dtype=torch.int32), torch.zeros(2, 1, dtype=torch.int32))
    sample_hop(torch.zeros(3, 4, dtype=torch.int32), torch.ones(3, dtype=torch.int32),
               torch.zeros(2, dtype=torch.int32), torch.zeros(2, 5))
    gather_rows(torch.zeros(3, 2), torch.zeros(1, dtype=torch.int32))
    gather_rows_blockspec(torch.zeros(3, 2), torch.zeros(1, dtype=torch.int32))
    gather_fanout_mean(torch.zeros(3, 2), torch.zeros(2, dtype=torch.int32), 2)
    mean_project(torch.zeros(2, 2, 4, dtype=torch.bfloat16), torch.zeros(4, 3, dtype=torch.bfloat16))
    assert {"gather_rows_blockspec", "sample_hop"} <= set(kernels.KERNELS)
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_a_launch_counts_under_its_kernel_only_when_it_succeeds(name, monkeypatch):
    """``_build.launch`` counts every kernel's launches: an entry point that
    returns 0 counts one launch under the name given and none under any
    other; one that returns a CUDA error raises and counts nothing."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=9))

    def entry(err):
        def tsg_entry(*args):
            assert args == (1, 2, 9)  # the arguments, then the stream
            return err
        return tsg_entry

    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="tsg_entry failed: cudaError_t 2"):
        _build.launch(entry(2), 1, 2, device="cuda", kernel=name)
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}
    _build.launch(entry(0), 1, 2, device="cuda", kernel=name)
    assert kernels.launch_counts() == {k: int(k == name) for k in kernels.KERNELS}
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}


def test_every_launch_names_a_kernel_of_the_table_and_every_source_is_built():
    """Each ``launch`` call in the kernel modules passes ``kernel=`` a name
    of ``KERNELS``, every name has a launch, and the table's CUDA sources are
    the ones ``_build.build()`` compiles."""
    named = set()
    for mod in {k.module for k in kernels.KERNELS.values()}:
        with open(mod.__file__) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "launch":
                kernel = {k.arg: k.value for k in node.keywords}.get("kernel")
                assert isinstance(kernel, ast.Constant), f"{mod.__name__}:{node.lineno}"
                named.add(kernel.value)
    assert named == set(kernels.KERNELS)
    assert {k.source for k in kernels.KERNELS.values()} == set(_build.SOURCES)
    assert len(_build.SOURCES) == 6


def test_every_kernel_source_notes_what_it_replaces_and_its_bound():
    for name, replaced, entry in [
            ("select", "select_columns_pallas", "tsg_select_columns("),
            ("select", "select_columns_pallas", "tsg_sample_hop("),
            ("gather", "gather_rows", "tsg_gather_rows("),
            ("gather", "gather_rows_blockspec", "tsg_gather_rows_blockspec("),
            ("gather_mean", "gather_fanout_mean", "tsg_gather_fanout_mean("),
            ("mean_project", "mean_project", "tsg_mean_project_bf16(")]:
        src, lib = _build.library_path(name)
        text = open(src).read()
        assert f"tpu_sage/kernels/{name}.py::{replaced}" in text
        assert "Bound on the H100: bytes" in text
        assert f'extern "C" int {entry}' in text and "cudaGetLastError()" in text
        assert lib.startswith(_build.BUILD_DIR) and os.path.basename(lib).startswith(f"lib{name}_")
    assert set(_build.SOURCES) == {"select", "gather", "gather_mean", "mean_project",
                                   "neighbor_max", "neighbor_mean"}


def test_mean_project_source_streams_x_asynchronously_and_uses_tensor_cores():
    text = open(_build.library_path("mean_project")[0]).read()
    for needle in ("cp.async.bulk.shared", "mbarrier.try_wait", "cp.async.cg.shared.global",
                   "cp.async.ca.shared.global [%0], [%1], 4;",
                   "ldmatrix.sync.aligned.m8n8.x4.trans", "mma.sync.aligned.m16n8k16",
                   "c_tile += tb;", "project_tile<IPW>"):
        assert needle in text, needle
