"""tpu_sage_torch.data.convert against tpu_sage.data.convert, on the CPU.

Every ingester of the port must give, for the same input and seed, bitwise
the JAX package's GraphStore: below 100,000 edges through the numpy code,
above through each package's native C++ code. Walk corpora match on both the
native and the numpy path, ``problem.h5`` files written by either converter
read identically in both packages, and the port's converter runs as a module
without loading JAX.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tpu_sage.data import convert as jconvert
from tpu_sage.data.problem import NodeProblem as JNodeProblem
from tpu_sage_torch import native
from tpu_sage_torch.data import convert
from tpu_sage_torch.data.problem import NodeProblem
from tests.test_ingesters import _write_planetoid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "toy-graph")


def assert_stores_equal(a, b):
    for k in ("adj", "degrees", "train_adj", "train_degrees", "feats", "targets"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert sorted(a.folds) == sorted(b.folds)
    for k in a.folds:
        np.testing.assert_array_equal(a.folds[k], b.folds[k], err_msg=k)
    assert (a.task, a.n_classes) == (b.task, b.n_classes)


def _edgelist_inputs(n, e, seed=0):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(e, 2)).astype(np.int64)
    feats = rng.normal(size=(n, 12)).astype(np.float32)
    targets = rng.integers(0, 5, size=n).astype(np.int64)
    perm = rng.permutation(n)
    folds = {"train": perm[: n // 2], "val": perm[n // 2: 3 * n // 4],
             "test": perm[3 * n // 4:]}
    return edges, feats, targets, folds


@pytest.mark.parametrize("n,e", [(500, 4_000), (3_000, 120_000)],
                         ids=["numpy", "native"])
def test_from_edgelist_is_bitwise_the_jax_packages(n, e):
    """120,000 edges on 3,000 nodes overfill many rows (about 80 neighbors
    each against max degree 32), so the native code's subsampling runs."""
    assert native.available()
    args = _edgelist_inputs(n, e)
    store = convert.from_edgelist(*args, max_degree=32, seed=3)
    assert_stores_equal(store, jconvert.from_edgelist(*args, max_degree=32, seed=3))
    assert store.degrees.max() == 32 if e > 100_000 else store.degrees.max() <= 32


def test_from_wl_json_is_bitwise_the_jax_packages():
    store = convert.from_wl_json(FIXTURE, max_degree=8, seed=1)
    assert_stores_equal(store, jconvert.from_wl_json(FIXTURE, max_degree=8, seed=1))
    assert store.task == "multilabel_classification" and store.n_nodes == 24


def _write_citeseer(path):
    """Planetoid with Citeseer's quirk (``tests/test_ingesters.py``'s
    fixture): two test ids absent from ``tx``, zero-patched."""
    import pickle

    from scipy import sparse as sp

    rng = np.random.default_rng(9)
    n_allx, n_tx, n_feat, n_classes, span = 10, 4, 6, 3, 6
    n = n_allx + span
    allx = sp.csr_matrix(rng.random((n_allx, n_feat)).astype(np.float32))
    tx = sp.csr_matrix(rng.random((n_tx, n_feat)).astype(np.float32))

    def onehot(k):
        y = np.zeros((k, n_classes), dtype=np.int32)
        y[np.arange(k), rng.integers(0, n_classes, k)] = 1
        return y

    ally, ty = onehot(n_allx), onehot(n_tx)
    present = np.array([n_allx, n_allx + 2, n_allx + 3, n_allx + span - 1])
    graph = {i: [int((i + 1) % n)] for i in range(n)}
    for suffix, obj in (("x", allx[:4]), ("tx", tx), ("allx", allx), ("y", ally[:4]),
                        ("ty", ty), ("ally", ally), ("graph", graph)):
        with open(os.path.join(path, f"ind.toy.{suffix}"), "wb") as f:
            pickle.dump(obj, f)
    with open(os.path.join(path, "ind.toy.test.index"), "w") as f:
        f.write("\n".join(str(i) for i in rng.permutation(present)) + "\n")


def _ogb_npz(tmp_path, regression):
    rng = np.random.default_rng(11 if regression else 3)
    n = 120
    perm = rng.permutation(n)
    labels = (rng.normal(size=n).astype(np.float32) if regression
              else rng.integers(0, 4, size=n).astype(np.int64))
    path = str(tmp_path / "g.npz")
    np.savez(path, edges=rng.integers(0, n, (400, 2)),
             feats=rng.normal(size=(n, 16)).astype(np.float32), labels=labels,
             train_idx=perm[:80], val_idx=perm[80:100], test_idx=perm[100:])
    return path


def _ogb_raw(tmp_path):
    import gzip

    rng = np.random.default_rng(5)
    n, f = 60, 8
    base = tmp_path / "ogbn-toy"
    (base / "raw").mkdir(parents=True)
    (base / "split" / "sales_ranking").mkdir(parents=True)

    def w(path, arr, fmt):
        with gzip.open(path, "wt") as fh:
            np.savetxt(fh, arr, delimiter=",", fmt=fmt)

    w(base / "raw" / "edge.csv.gz", rng.integers(0, n, size=(150, 2)), "%d")
    w(base / "raw" / "node-feat.csv.gz", rng.random((n, f)), "%.6f")
    w(base / "raw" / "node-label.csv.gz", rng.integers(0, 3, (n, 1)), "%d")
    perm = rng.permutation(n)
    w(base / "split" / "sales_ranking" / "train.csv.gz", perm[:40, None], "%d")
    w(base / "split" / "sales_ranking" / "valid.csv.gz", perm[40:50, None], "%d")
    w(base / "split" / "sales_ranking" / "test.csv.gz", perm[50:, None], "%d")
    return str(tmp_path)


@pytest.mark.parametrize("fmt", ["planetoid", "planetoid-citeseer", "ogb-npz",
                                 "ogb-npz-regression", "ogb"])
def test_ingesters_are_bitwise_the_jax_packages(tmp_path, fmt):
    if fmt.startswith("planetoid"):
        if fmt == "planetoid":
            _write_planetoid(str(tmp_path))
        else:
            _write_citeseer(str(tmp_path))
        call = lambda m: m.from_planetoid(str(tmp_path), "toy", max_degree=8, seed=2)  # noqa
    elif fmt.startswith("ogb-npz"):
        path = _ogb_npz(tmp_path, regression=fmt.endswith("regression"))
        task = "regression" if fmt.endswith("regression") else "classification"
        call = lambda m: m.from_ogb_npz(path, max_degree=16, task=task)  # noqa
    else:
        root = _ogb_raw(tmp_path)
        call = lambda m: m.from_ogb(root, "ogbn-toy", max_degree=8)  # noqa
    store = call(convert)
    assert_stores_equal(store, call(jconvert))
    if fmt == "ogb-npz-regression":
        assert store.targets.dtype == np.float32 and store.targets.shape == (120, 1)


@pytest.mark.parametrize("native_path", [True, False], ids=["native", "numpy"])
def test_generate_walks_is_bitwise_the_jax_packages(monkeypatch, native_path):
    store = convert.from_wl_json(FIXTURE, max_degree=8)
    if not native_path:
        from tpu_sage import native as jnative

        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    args = (store.train_adj, store.train_degrees, np.arange(store.n_nodes), 3, 4, 5)
    walks = convert.generate_walks(*args)
    assert walks.shape == (24, 3, 5)
    np.testing.assert_array_equal(walks, jconvert.generate_walks(*args))


def test_files_from_either_converter_read_the_same_in_both_packages(tmp_path):
    store = convert.from_wl_json(FIXTURE, max_degree=8)
    walks = convert.generate_walks(store.train_adj, store.train_degrees,
                                   np.arange(store.n_nodes), 2, 3, 0)
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "theirs.h5")
    convert.save_problem_h5(store, ours, walks=walks)
    jconvert.save_problem_h5(jconvert.from_wl_json(FIXTURE, max_degree=8), theirs, walks=walks)
    loaded = [reader.from_h5(path) for reader in (NodeProblem, JNodeProblem)
              for path in (ours, theirs)]
    for p in loaded:
        assert_stores_equal(p.store, loaded[0].store)
        np.testing.assert_array_equal(p.walks, walks)
    assert_stores_equal(loaded[0].store, store)


def test_the_converter_module_round_trips_without_jax(tmp_path):
    out = str(tmp_path / "p.h5")
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['convert', '--inpath', {FIXTURE!r}, '--outpath', {out!r},\n"
        "            '--max-degree', '8', '--n-walks', '2', '--walk-length', '3']\n"
        "runpy.run_module('tpu_sage_torch.data.convert', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tpu_sage'))\n"
        "print('loaded:' + ','.join(bad))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    meta_line, loaded = r.stdout.strip().splitlines()[-2:]
    assert loaded == "loaded:"
    meta = json.loads(meta_line)
    assert (meta["n_nodes"], meta["task"], meta["n_classes"]) == (
        24, "multilabel_classification", 3)
    ref = str(tmp_path / "ref.h5")
    jconvert.main(["--inpath", FIXTURE, "--outpath", ref, "--max-degree", "8",
                   "--n-walks", "2", "--walk-length", "3"])
    a, b = NodeProblem.from_h5(out), NodeProblem.from_h5(ref)
    assert_stores_equal(a.store, b.store)
    np.testing.assert_array_equal(a.walks, b.walks)
