"""Inputs made from the seed, on the device: the graph, the folds, the
initial weights and the order of the batches.

The Reddit-shaped graph is the distribution of the repo's ``bench_store``
(uniform-random neighbour ids at a fixed degree, features that are a class
centroid plus standard-normal noise, random folds), drawn with a
``torch.Generator`` on the device in a few large calls and written to no
file. Every seed gives the same sizes; only the values differ.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed (any whole number)."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


@dataclasses.dataclass
class Graph:
    adj: torch.Tensor       # (n, degree) int32 neighbour ids
    degrees: torch.Tensor   # (n,) int32
    feats: torch.Tensor     # (n, feat_dim) in the configuration's feature dtype
    labels: torch.Tensor    # (n,) int32
    folds: Dict[str, torch.Tensor]  # int32 node ids of train, val, test


def reddit_shaped(spec: dict, seed: int, device: torch.device, dtype: torch.dtype) -> Graph:
    """The graph of a configuration's ``graph`` block: ``n_nodes``,
    ``feat_dim``, ``n_classes``, ``degree``, ``val_frac``, ``test_frac``."""
    n, d, c, k = (int(spec[key]) for key in ("n_nodes", "feat_dim", "n_classes", "degree"))
    g = generator(seed, "graph", device)
    labels = torch.randint(0, c, (n,), generator=g, device=device, dtype=torch.int32)
    adj = torch.randint(0, n, (n, k), generator=g, device=device, dtype=torch.int32)
    centroids = torch.randn((c, d), generator=g, device=device)
    feats = torch.randn((n, d), generator=g, device=device)
    feats += centroids[labels.long()]
    feats = feats.to(dtype)
    perm = torch.randperm(n, generator=g, device=device).to(torch.int32)
    n_val, n_test = int(n * spec["val_frac"]), int(n * spec["test_frac"])
    folds = {"val": perm[:n_val], "test": perm[n_val:n_val + n_test],
             "train": perm[n_val + n_test:]}
    return Graph(adj=adj, degrees=torch.full((n,), k, dtype=torch.int32, device=device),
                 feats=feats, labels=labels, folds=folds)


def give_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's weights into the program's model, by name; the
    model must hold exactly these parameters."""
    named = dict(model.named_parameters())
    if set(named) != set(weights):
        raise RuntimeError(f"program parameters {sorted(named)} are not {sorted(weights)}")
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(weights[name])


class Batches:
    """Whole batches of ``ids`` and their ``labels``, each epoch a fresh
    permutation drawn on the device from the run's seed (the labels of an
    epoch gathered once, as the port's own epoch loop does)."""

    def __init__(self, ids: torch.Tensor, labels: torch.Tensor, batch_size: int, seed: int):
        if ids.shape[0] < batch_size:
            raise ValueError(f"{ids.shape[0]} ids cannot fill a batch of {batch_size}")
        self.ids = ids
        self.labels = labels
        self.batch_size = batch_size
        self.per_epoch = ids.shape[0] // batch_size
        self._gen = generator(seed, "batches", ids.device)
        self._epoch = None
        self._at = self.per_epoch

    def next(self):
        """``(ids, labels)`` of the next batch."""
        if self._at == self.per_epoch:
            perm = torch.randperm(self.ids.shape[0], generator=self._gen, device=self.ids.device)
            ids = self.ids[perm[:self.per_epoch * self.batch_size]]
            self._epoch = (ids.view(self.per_epoch, self.batch_size),
                           self.labels[ids.long()].view(self.per_epoch, self.batch_size))
            self._at = 0
        batch = (self._epoch[0][self._at], self._epoch[1][self._at])
        self._at += 1
        return batch
