"""tpu_sage_torch.overrides, utils and the kernel probe against the JAX
package's, on the CPU.

Each ``TPU_SAGE_*`` override reads the same variable with the same spellings
as ``tpu_sage/overrides.py``, and moves the port where it moves the JAX
package: ``TPU_SAGE_FUSE_LAST=0`` turns the deepest level's fusion off in
both models (logits then equal each package's ``fuse_last="off"`` logits
bitwise, and each other's within ``tests/test_torch_model.py``'s f32
tolerance), ``TPU_SAGE_GATHER_FORM=masked`` (or ``masked_chunked``)
zero-fills out-of-range ids in both gathers, and ``TPU_SAGE_INT8_SUMMEAN=0`` gives the reference's
dequantize-then-mean, bitwise its jitted form (ROADMAP Queue 3 #11).
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sage import ops as jops
from tpu_sage import overrides as joverrides
from tpu_sage import utils as jutils
from tpu_sage.data import quantize as jq
from tpu_sage_torch import ops, overrides, utils
from tpu_sage_torch.data import quantize as tq
from tests.test_torch_model import _run_both

VARS = ("TPU_SAGE_GATHER_FORM", "TPU_SAGE_GATHER_CHUNKS", "TPU_SAGE_FUSE_LAST",
        "TPU_SAGE_INT8_SUMMEAN")


@pytest.fixture
def clean_env(monkeypatch):
    for v in VARS:
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


@pytest.mark.parametrize("fn,var,values,configured", [
    ("gather_form", "TPU_SAGE_GATHER_FORM", [None, "", "masked", "masked_chunked", "plain"],
     [None, "masked", "masked_chunked"]),
    ("gather_chunks", "TPU_SAGE_GATHER_CHUNKS", [None, "", "1", "8"], [10, 1]),
    ("fuse_last", "TPU_SAGE_FUSE_LAST", [None, "0", "1", "all", "off", "auto"],
     ["auto", "off", "all"]),
    ("int8_summean", "TPU_SAGE_INT8_SUMMEAN", [None, "0", "1", ""], [True, False]),
])
def test_each_override_is_the_jax_packages(clean_env, fn, var, values, configured):
    for value in values:
        if value is None:
            clean_env.delenv(var, raising=False)
        else:
            clean_env.setenv(var, value)
        for c in configured:
            assert getattr(overrides, fn)(c) == getattr(joverrides, fn)(c), (value, c)


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_fuse_last_0_turns_the_fusion_off_in_both_packages(clean_env, dtype):
    off = _run_both("concat", "off", dtype)
    clean_env.setenv("TPU_SAGE_FUSE_LAST", "0")
    forced = _run_both("concat", "auto", dtype)
    for a, b in zip(forced, off):  # JAX logits, port logits, JAX grads, port grads
        if isinstance(a, dict):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_array_equal(a, b)
    jlogits, tlogits = forced[:2]
    tol = 1e-5 if dtype is None else 6e-3 * np.abs(jlogits).max()
    np.testing.assert_allclose(tlogits, jlogits, rtol=0 if dtype else 1e-5, atol=tol)


def test_the_override_switches_the_ports_fusion_policy(clean_env):
    from tpu_sage_torch.nn.model import GSSupervised, default_layer_specs

    model = GSSupervised(default_layer_specs((3, 2), output_dims=(8, 8)), 4, feat_dim=6)
    levels, feats = [torch.zeros(n, dtype=torch.int32) for n in (2, 6, 12)], torch.zeros(5, 6)
    assert model.fuses_last(levels, feats)
    clean_env.setenv("TPU_SAGE_FUSE_LAST", "0")
    assert not model.fuses_last(levels, feats)


@pytest.mark.parametrize("form", ["masked", "masked_chunked"])
def test_gather_form_masked_zero_fills_out_of_range_ids_in_both_packages(clean_env, form):
    table = np.random.default_rng(0).normal(size=(20, 5)).astype(np.float32)
    ids = np.array([3, -1, 19, 20, -21, 7], np.int32)
    plain = ops.row_gather(torch.from_numpy(table), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(plain, np.asarray(jops.row_gather(jnp.asarray(table),
                                                                    jnp.asarray(ids))))
    assert (plain[[1, 3, 4]] != 0).any()  # the plain form wraps and clamps
    clean_env.setenv("TPU_SAGE_GATHER_FORM", form)
    got = ops.row_gather(torch.from_numpy(table), torch.from_numpy(ids)).numpy()
    want = np.asarray(jops.row_gather(jnp.asarray(table), jnp.asarray(ids)))
    np.testing.assert_array_equal(got, want)
    assert (got[[1, 3, 4]] == 0).all() and (got[[0, 2, 5]] == table[[3, 19, 7]]).all()


@pytest.mark.parametrize("jdt,tdt", [("bfloat16", torch.bfloat16), ("float32", torch.float32)],
                         ids=["bf16", "f32"])
def test_int8_summean_0_gives_the_jitted_dequantize_then_mean(clean_env, jdt, tdt):
    rng = np.random.default_rng(1)
    feats = (rng.normal(size=(300, 37)) * rng.uniform(0.05, 4.0, size=37)).astype(np.float32)
    jf = jq.quantize_feats(feats, out_dtype=jdt)
    tf = tq.quantize_feats(feats, out_dtype=tdt, device="cpu")
    ids = rng.integers(0, 300, 64 * 10).astype(np.int32)
    summed = ops.row_gather_fanout_mean(tf, torch.from_numpy(ids), 10)
    clean_env.setenv("TPU_SAGE_INT8_SUMMEAN", "0")
    got = ops.row_gather_fanout_mean(tf, torch.from_numpy(ids), 10)  # config says summean
    want = jax.jit(lambda f, i: jops.row_gather_fanout_mean(f, i, 10))(jf, jnp.asarray(ids))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert torch.equal(
        got, ops.row_gather_fanout_mean(tf, torch.from_numpy(ids), 10, int8_summean=False))
    if tdt == torch.float32:  # the two means round differently
        assert not torch.equal(got, summed)


def test_set_seeds_and_to_numpy():
    g = utils.set_seeds(5, device="cpu")
    assert isinstance(g, torch.Generator) and g.device == torch.device("cpu")
    a, draw = np.random.rand(3), torch.rand(4, generator=g)
    utils.set_seeds(5, device="cpu")
    np.testing.assert_array_equal(a, np.random.rand(3))
    assert torch.equal(draw, torch.rand(4, generator=torch.Generator().manual_seed(5)))
    jutils.set_seeds(5)  # numpy's global stream is seeded the same way in both
    np.testing.assert_array_equal(a, np.random.rand(3))

    x = torch.tensor([1.0, -2.5, 3.140625, 1e30], dtype=torch.bfloat16)
    got = utils.to_numpy(x)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x.float().numpy())
    assert utils.to_numpy([1, 2]).tolist() == [1, 2]
    np.testing.assert_array_equal(utils.to_numpy(torch.arange(3)), np.arange(3))


def test_enable_compilation_cache_moves_the_build_dir(tmp_path):
    from tpu_sage_torch.kernels import _build

    before = _build.BUILD_DIR
    try:
        where = utils.enable_compilation_cache(str(tmp_path / "kcache"))
        assert where == _build.BUILD_DIR == str(tmp_path / "kcache")
        assert os.path.isdir(where)
        assert os.path.dirname(_build.library_path("gather")[1]) == where
        assert utils.enable_compilation_cache() == where  # no argument: where it is
    finally:
        _build.BUILD_DIR = before
    assert _build.library_path("gather")[1].startswith(before)


def test_probe_is_false_here_within_its_timeout(monkeypatch):
    from tpu_sage_torch.kernels import _build, probe

    t0 = time.perf_counter()
    assert probe(timeout=60.0) is False  # no card: nothing is built or run
    # past the card and build checks, the subprocess fails (no card in it)
    # or is cut by its timeout; the build runs before the timed part
    built = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "build", lambda: built.append(1))
    assert probe(timeout=60.0) is False
    assert probe(timeout=0.01) is False
    assert built == [1, 1]

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "build", no_nvcc)
    assert probe(timeout=60.0) is False  # a failed build
    assert time.perf_counter() - t0 < 60.0


def test_the_probe_cases_cover_every_kernel_and_run_their_plain_versions():
    from tpu_sage_torch import kernels
    from tpu_sage_torch.kernels import _probe

    cases = _probe.cases(torch.Generator().manual_seed(0))
    assert set(cases) == set(kernels.KERNEL_MODULES)
    kernels.reset_launch_counts()
    for name, (fn, args) in cases.items():
        assert torch.isfinite(fn(*args).float()).all(), name
    assert sum(kernels.launch_counts().values()) == 0  # CPU tensors launch nothing
