"""tpu_sage_torch kernels' plain versions against the JAX package's kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs its
Pallas kernels in interpret mode, as tests/test_kernels.py does. The CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sage import ops as jops
from tpu_sage.kernels.gather import gather_rows as j_gather_rows
from tpu_sage.kernels.gather import gather_rows_bf16 as j_gather_rows_bf16
from tpu_sage.kernels.gather_mean import gather_fanout_mean as j_fanout_mean
from tpu_sage.kernels.mean_project import mean_project as j_mean_project
from tpu_sage.kernels.select import select_columns_pallas
from tpu_sage.sample.sampler import select_columns as j_select_columns
from tpu_sage_torch import kernels, ops
from tpu_sage_torch.kernels import _build
from tpu_sage_torch.kernels.gather import gather_rows
from tpu_sage_torch.kernels.gather_mean import gather_fanout_mean
from tpu_sage_torch.kernels.mean_project import mean_project
from tpu_sage_torch.kernels.select import select_columns


def _bf16_bits_torch(t):
    return t.contiguous().view(torch.int16).numpy()


def _bf16_bits_jax(a):
    return np.asarray(a).view(np.int16)


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
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(6, 25, 40)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32)).to(torch.bfloat16)
    out = mean_project(x, w)
    assert out.dtype == torch.bfloat16
    exact = (x.double().mean(1) @ w.double()).float()
    torch.testing.assert_close(out.float(), exact, rtol=8e-3, atol=8e-3)


@pytest.mark.parametrize("call", [
    lambda t: select_columns(t.int(), t[:, :2].int()),
    lambda t: gather_rows(t, torch.zeros(2, dtype=torch.int32, device=t.device)),
    lambda t: gather_fanout_mean(t, torch.zeros(2, dtype=torch.int32, device=t.device), 2),
    lambda t: mean_project(t.view(2, 2, 4), torch.zeros(4, 3, device=t.device)),
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
    gather_rows(torch.zeros(3, 2), torch.zeros(1, dtype=torch.int32))
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNEL_MODULES}


def test_every_kernel_source_notes_what_it_replaces_and_its_bound():
    for name, replaced in [("select", "select_columns_pallas"), ("gather", "gather_rows"),
                           ("gather_mean", "gather_fanout_mean"),
                           ("mean_project", "mean_project")]:
        src, lib = _build.library_path(name)
        text = open(src).read()
        assert f"tpu_sage/kernels/{name}.py::{replaced}" in text
        assert "Bound on the H100: bytes" in text
        assert 'extern "C" int tsg_' in text and "cudaGetLastError()" in text
        assert lib.startswith(_build.BUILD_DIR) and os.path.basename(lib).startswith(f"lib{name}_")
