"""tpu_sage_torch.native against tpu_sage.native, on the CPU.

The port keeps its own copy of the C++ source and its own ctypes loader, so
for the same inputs and seed its tables and walks are bitwise the JAX
package's, and its error codes are the same. Its library is built under
``build/tpu_sage_torch/native/`` in the checkout, never beside either
package's sources.
"""

import glob
import os

import numpy as np
import pytest

from tpu_sage import native as jnative
from tpu_sage_torch import native
from tpu_sage_torch.graph.graph_data import build_padded_adjacency

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _edges(n=300, e=4000, seed=0):
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1)
    return edges[edges[:, 0] != edges[:, 1]]


def test_the_cpp_source_is_the_jax_packages():
    with open(os.path.join(REPO, "tpu_sage", "native", "graph_builder.cpp"), "rb") as a, \
            open(os.path.join(REPO, "tpu_sage_torch", "native", "graph_builder.cpp"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("symmetrize", [True, False])
@pytest.mark.parametrize("seed", [0, 7])
def test_padded_adjacency_is_bitwise_the_jax_packages(symmetrize, seed):
    """Overfull rows (max degree 8 below the typical 13–27) are subsampled
    by the same mt19937_64 stream in both libraries."""
    edges = _edges()
    adj, deg = native.build_padded_adjacency(edges, 300, 8, seed=seed, symmetrize=symmetrize)
    jadj, jdeg = jnative.build_padded_adjacency(edges, 300, 8, seed=seed,
                                                symmetrize=symmetrize)
    assert adj.dtype == np.int32 and deg.dtype == np.int32 and adj.shape == (300, 8)
    np.testing.assert_array_equal(adj, jadj)
    np.testing.assert_array_equal(deg, jdeg)
    # the numpy implementation's degrees (dedupe + clip) agree; isolated rows self-pad
    _, np_deg = build_padded_adjacency(edges, 300, 8, symmetrize=symmetrize)
    np.testing.assert_array_equal(deg, np_deg)
    zero = np.nonzero(deg == 0)[0]
    assert (adj[zero] == zero[:, None]).all()


def test_walks_are_bitwise_the_jax_packages():
    adj, deg = build_padded_adjacency(_edges(n=50, e=120, seed=3), 50, 6)
    starts = np.arange(50)
    walks = native.random_walks(adj, deg, starts, n_walks=3, walk_len=5, seed=11)
    assert walks.shape == (50, 3, 6) and walks.dtype == np.int32
    np.testing.assert_array_equal(
        walks, jnative.random_walks(adj, deg, starts, n_walks=3, walk_len=5, seed=11))
    assert (walks[:, :, 0] == starts[:, None]).all()
    isolated = np.nonzero(deg == 0)[0]
    assert (walks[isolated] == isolated[:, None, None]).all()


@pytest.mark.parametrize("call,code", [
    (lambda m: m.build_padded_adjacency(np.array([[0, 99]]), 5, 4), 2),
    (lambda m: m.build_padded_adjacency(np.array([[0, 1]]), 5, 0), 1),
    (lambda m: m.random_walks(np.zeros((5, 2), np.int32), np.zeros(5, np.int32),
                              np.array([7]), 2, 3), 2),
    (lambda m: m.random_walks(np.zeros((5, 2), np.int32), np.zeros(5, np.int32),
                              np.array([0]), 0, 3), 1),
], ids=["edge-out-of-range", "no-columns", "start-out-of-range", "no-walks"])
def test_error_codes_match(call, code):
    for mod in (native, jnative):
        with pytest.raises(ValueError, match=f"code {code}$"):
            call(mod)


def test_the_library_builds_under_build_not_beside_the_sources():
    assert native.available()
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "tpu_sage_torch", "native")
    assert os.path.basename(path).startswith("libtsg_native_") and os.path.exists(path)
    for pkg in ("tpu_sage", "tpu_sage_torch"):
        assert not glob.glob(os.path.join(REPO, pkg, "**", "libtsg_native*"), recursive=True)
    assert not glob.glob(os.path.join(REPO, "tpu_sage_torch", "**", "*.so"), recursive=True)
