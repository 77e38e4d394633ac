"""tpu_sage_torch.data.hdf5 against h5py, on the CPU.

The card's machine has no h5py, so the port reads and writes ``problem.h5``
with its own codec. Each direction is held against h5py (the JAX package's
reader and writer): every dtype and rank of the schema, the root
attributes in each form h5py writes (a ``str`` is a variable-length string
in a global heap), the checked-in ``tests/data/golden_problem.h5``, and a
clear error for what the subset leaves out.
"""

import os

import h5py
import numpy as np
import pytest

from tpu_sage_torch.data import hdf5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARRAYS = {
    "int8": np.array([0, 1, 2, -1], np.int8),
    "uint8": np.arange(6, dtype=np.uint8).reshape(2, 3),
    "int32": np.arange(-12, 12, dtype=np.int32).reshape(4, 6),
    "int64": np.array([2**40, -3, 7], np.int64),
    "float32": np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32),
    "float64": np.linspace(-1, 1, 7),
    "walks": np.random.default_rng(1).integers(0, 9, (3, 2, 4)).astype(np.int32),
    "empty": np.zeros((0, 3), np.float32),
}
ATTRS = {"task": "multilabel_classification", "n_classes": 121, "lr": 0.25}


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_h5py_reads_what_the_port_writes(tmp_path, name):
    path = str(tmp_path / "p.h5")
    hdf5.write(path, {name: ARRAYS[name], "other": np.ones(3, np.int32)}, ATTRS)
    with h5py.File(path, "r") as f:
        assert sorted(f) == sorted([name, "other"])
        got = f[name][()]
        assert got.dtype == ARRAYS[name].dtype and got.shape == ARRAYS[name].shape
        np.testing.assert_array_equal(got, ARRAYS[name])
        assert f.attrs["task"].decode() == ATTRS["task"]
        assert f.attrs["n_classes"] == 121 and f.attrs["lr"] == 0.25


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_the_port_reads_what_h5py_writes(tmp_path, name):
    path = str(tmp_path / "p.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset(name, data=ARRAYS[name])
        f.attrs.update(ATTRS)  # a str attribute is a variable-length string here
        f.attrs["fixed"] = np.bytes_(b"classification")
    datasets, attrs = hdf5.read(path)
    got = datasets[name]
    assert got.dtype == ARRAYS[name].dtype and got.shape == ARRAYS[name].shape
    np.testing.assert_array_equal(got, ARRAYS[name])
    assert attrs == {**ATTRS, "fixed": "classification"}


def test_a_full_problem_and_the_golden_file(tmp_path):
    """All eight datasets of the schema (one symbol-table node's worth) both
    ways, and the checked-in golden file as h5py reads it."""
    rng = np.random.default_rng(2)
    full = {k: rng.integers(0, 50, (50, 8)).astype(np.int32) for k in ("adj", "train_adj")}
    full.update(degrees=np.full(50, 8, np.int32), train_degrees=np.full(50, 8, np.int32),
                feats=rng.normal(size=(50, 6)).astype(np.float32),
                targets=rng.integers(0, 5, 50), folds=rng.integers(0, 3, 50).astype(np.int8),
                walks=rng.integers(0, 50, (50, 2, 4)).astype(np.int32))
    path = str(tmp_path / "full.h5")
    hdf5.write(path, full, {"task": "classification", "n_classes": 5})
    datasets, attrs = hdf5.read(path)
    with h5py.File(path, "r") as f:
        for k, v in full.items():
            np.testing.assert_array_equal(f[k][()], v)
            np.testing.assert_array_equal(datasets[k], v)
    golden = os.path.join(REPO, "tests", "data", "golden_problem.h5")
    datasets, attrs = hdf5.read(golden)
    with h5py.File(golden, "r") as f:
        assert sorted(datasets) == sorted(f)
        for k in f:
            np.testing.assert_array_equal(datasets[k], f[k][()])
        assert attrs["task"] == f.attrs["task"] and attrs["n_classes"] == f.attrs["n_classes"]


def test_what_the_subset_leaves_out_is_refused(tmp_path):
    path = str(tmp_path / "z.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(100), compression="gzip")
    with pytest.raises(ValueError, match="hdf5: filtered"):
        hdf5.read(path)
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(3))
    with pytest.raises(ValueError, match="hdf5: superblock version"):
        hdf5.read(path)
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        f.create_dataset("x", data=np.arange(3), dcpl=dcpl)
    with pytest.raises(ValueError, match="only contiguous dataset storage"):
        hdf5.read(path)
    with pytest.raises(ValueError, match="at most 8 datasets"):
        hdf5.write(path, {f"d{i}": np.zeros(1) for i in range(9)}, {})
    with pytest.raises(ValueError, match="unsupported dtype"):
        hdf5.write(path, {"c": np.zeros(2, np.complex64)}, {})
    with open(path, "wb") as f:
        f.write(b"not an hdf5 file at all")
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.read(path)
