"""NodeProblem: the task container (counterpart of ``tpu_sage/data/problem.py``).

Loads a ``problem.h5`` artifact (schema below), exposes the train/full
adjacency split, folds, and the reference's ``iterate(mode, shuffle)`` batch
generator. The training loop bypasses
``iterate``: fold ids live on the device and batching is a device-side
permutation.

problem.h5 schema (shared with the JAX package):
  datasets: adj (n, max_degree) int32, train_adj (n, max_degree) int32,
            degrees (n,) int32, train_degrees (n,) int32,
            feats (n, d) float32, targets (n,) int64 | (n, c) float32,
            folds (n,) int8  [0=train, 1=val, 2=test]
            walks (n, n_walks, L+1) int  [optional: a random-walk corpus,
                                          the unsupervised path's positives]
  attrs:    task (str), n_classes (int)
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from tpu_sage_torch.graph.graph_data import CSRDeviceGraph, DeviceGraph, GraphStore

FOLD_CODES = {"train": 0, "val": 1, "test": 2}


def infer_degrees(adj: np.ndarray) -> np.ndarray:
    """Recover true degrees from a self-id-padded table (for artifacts that
    lack the ``degrees`` dataset): degree = max_degree minus the trailing run
    of self-id entries. A real self-loop in the trailing slot is undercounted."""
    n, max_degree = adj.shape
    is_pad = adj == np.arange(n, dtype=adj.dtype)[:, None]
    not_pad_rev = ~is_pad[:, ::-1]
    first_real = np.where(
        not_pad_rev.any(axis=1), np.argmax(not_pad_rev, axis=1), max_degree
    )
    return (max_degree - first_real).astype(np.int32)


class NodeProblem:
    """Task + graph + folds, mirroring the reference's public surface."""

    def __init__(self, store: GraphStore):
        self.store = store
        self.task = store.task
        self.n_classes = store.n_classes
        self.folds: Dict[str, np.ndarray] = store.folds
        self.walks: Optional[np.ndarray] = None  # (n_nodes, n_walks, L+1) corpus
        self._device_graphs: Dict[tuple, DeviceGraph | CSRDeviceGraph] = {}

    @classmethod
    def from_h5(cls, problem_path: str) -> "NodeProblem":
        """Load a ``problem.h5`` (read without h5py, ``data/hdf5.py``)."""
        from tpu_sage_torch.data import hdf5

        if not os.path.exists(problem_path):
            raise SystemExit(f"error: problem file not found: {problem_path!r}")
        f, attrs = hdf5.read(problem_path)
        adj = f["adj"].astype(np.int32, copy=False)
        train_adj = f["train_adj"].astype(np.int32, copy=False) if "train_adj" in f else adj
        degrees = f["degrees"].astype(np.int32, copy=False) if "degrees" in f else infer_degrees(adj)
        train_degrees = (f["train_degrees"].astype(np.int32, copy=False) if "train_degrees" in f
                         else infer_degrees(train_adj))
        feats = f["feats"].astype(np.float32, copy=False)
        targets = f["targets"]
        fold_codes = f["folds"]
        walks = f.get("walks")
        task = attrs.get("task", "classification")
        n_classes = int(attrs.get("n_classes", 0))
        folds = {
            name: np.nonzero(fold_codes == code)[0].astype(np.int64)
            for name, code in FOLD_CODES.items()
        }
        problem = cls(GraphStore(
            adj=adj, degrees=degrees, train_adj=train_adj,
            train_degrees=train_degrees, feats=feats, targets=targets,
            folds=folds, task=task, n_classes=n_classes,
        ))
        problem.walks = walks
        return problem

    @property
    def n_nodes(self) -> int:
        return self.store.n_nodes

    @property
    def feats_dim(self) -> int:
        return self.store.feat_dim

    @property
    def loss_fn_name(self) -> str:
        return self.task

    @property
    def metric_fn_name(self) -> str:
        return self.task

    def device_graph(
        self, train: bool, dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda", csr: bool = False, quantize: bool = False,
    ) -> DeviceGraph | CSRDeviceGraph:
        """Upload (once, cached) the train-edge or full-edge graph.

        ``dtype`` is the feature dtype on the device (``torch.bfloat16``
        halves the dominant gather traffic). ``csr`` uploads CSR adjacency
        (``nnz`` ids instead of ``n·max_degree``); ``quantize`` stores the
        features int8 with per-column scales, ``dtype`` then being the
        compute dtype (``data/quantize.py``). The cache keeps the graphs of
        one feature storage ``(dtype, device, quantize)``: asking for
        another drops them, as the store drops its table."""
        key = (train, dtype, str(torch.device(device)), csr, quantize)
        if key not in self._device_graphs:
            storage = (key[1], key[2], key[4])
            for k in [k for k in self._device_graphs if (k[1], k[2], k[4]) != storage]:
                del self._device_graphs[k]
            to_dev = self.store.to_device_csr if csr else self.store.to_device
            self._device_graphs[key] = to_dev(
                train=train, dtype=dtype, device=device, quantize=quantize
            )
        return self._device_graphs[key]

    def iterate(
        self,
        mode: str = "train",
        batch_size: int = 512,
        shuffle: bool = False,
        seed: Optional[int] = None,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        """Yield ``(ids, targets, progress)`` host batches; ``progress`` is
        the fraction of the fold consumed after the yielded batch."""
        idx = self.folds[mode]
        if shuffle:
            idx = np.random.default_rng(seed).permutation(idx)
        n = len(idx)
        done = 0
        for chunk in np.array_split(idx, max(1, int(np.ceil(n / batch_size)))):
            done += len(chunk)
            yield chunk, self.store.targets[chunk], done / n
