"""Graph storage: padded fixed-max-degree neighbor tables.

Counterpart of ``tpu_sage/graph/graph_data.py``. The graph is a dense
``(n_nodes, max_degree)`` table of neighbor ids, padded at ETL time, so every
minibatch tensor has a static shape.

Padding idiom (same as the reference): rows with ``degree < max_degree`` are
padded with the node's own id (self-loop), and ``degree == 0`` rows are
all-self. The sampler only draws column indices in ``[0, max(degree, 1))``,
so padding values are never selected except for isolated nodes, which
self-loop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class DeviceGraph:
    """The on-device graph: everything the train step touches, on one device."""

    adj: torch.Tensor      # (n_nodes, max_degree) int32, padded with self id
    degrees: torch.Tensor  # (n_nodes,) int32 true degree (0 allowed)
    feats: torch.Tensor    # (n_nodes, feat_dim) float32 or bfloat16
    targets: torch.Tensor  # (n_nodes,) int32 or (n_nodes, n_targets) float

    @property
    def device(self) -> torch.device:
        return self.adj.device


def build_padded_adjacency(
    edges: np.ndarray,
    n_nodes: int,
    max_degree: int,
    rng: Optional[np.random.Generator] = None,
    symmetrize: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Edge list ``(E, 2)`` → padded neighbor table ``(n_nodes, max_degree)``.

    High-degree rows are truncated by uniform random subsampling (without
    replacement); low-degree rows are padded with the row's own node id.
    Returns ``(adj int32, degrees int32)`` with ``degrees`` clipped to
    ``max_degree``. Draws the same random numbers as the reference, so the
    same ``rng`` state gives bit-equal tables.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if symmetrize and len(edges):
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)

    adj = np.broadcast_to(
        np.arange(n_nodes, dtype=np.int32)[:, None], (n_nodes, max_degree)
    ).copy()
    degrees = np.zeros(n_nodes, dtype=np.int32)
    if len(edges) == 0:
        return adj, degrees

    # Drop duplicate directed edges, then bucket by source via sort.
    edges = np.unique(edges, axis=0)
    src, dst = edges[:, 0], edges[:, 1]
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=n_nodes)
    row_starts = np.concatenate([[0], np.cumsum(counts)])

    # Position of each edge within its source's bucket: 0..deg-1.
    pos = np.arange(len(src)) - row_starts[src]

    if (counts > max_degree).any():
        # Random subsample per overfull row: rank random keys per bucket,
        # then keep pos < max_degree.
        keys = rng.random(len(src))
        order2 = np.lexsort((keys, src))
        pos = np.empty(len(src), dtype=np.int64)
        pos[order2] = np.arange(len(src)) - row_starts[src[order2]]
    keep = pos < max_degree
    adj[src[keep], pos[keep]] = dst[keep].astype(np.int32)
    degrees = np.minimum(counts, max_degree).astype(np.int32)
    return adj, degrees


@dataclasses.dataclass
class GraphStore:
    """Host-side graph container (numpy) with the full/train adjacency split.

    ``adj`` is the full graph (used at validation), ``train_adj`` holds
    train-fold edges only (used during training, for inductiveness).
    """

    adj: np.ndarray          # (n, max_degree) int32 — full graph
    degrees: np.ndarray      # (n,) int32
    train_adj: np.ndarray    # (n, max_degree) int32 — train-only edges
    train_degrees: np.ndarray
    feats: np.ndarray        # (n, d) float32
    targets: np.ndarray      # (n,) int64 or (n, c) float32
    folds: Dict[str, np.ndarray]  # mode -> node ids (int64)
    task: str = "classification"
    n_classes: int = 0

    @property
    def n_nodes(self) -> int:
        return self.adj.shape[0]

    @property
    def feat_dim(self) -> int:
        return self.feats.shape[1]

    def to_device(
        self, train: bool, dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
    ) -> DeviceGraph:
        device = torch.device(device)
        adj = self.train_adj if train else self.adj
        deg = self.train_degrees if train else self.degrees
        tdtype = torch.int32 if self.task == "classification" else dtype
        return DeviceGraph(
            adj=torch.as_tensor(adj, dtype=torch.int32).to(device).contiguous(),
            degrees=torch.as_tensor(deg, dtype=torch.int32).to(device).contiguous(),
            feats=self._device_feats(dtype, device),
            targets=torch.as_tensor(self.targets).to(device=device, dtype=tdtype),
        )

    def _device_feats(self, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
        """Feature upload, cached per ``(dtype, device)``: the train-edge and
        full-edge graphs differ only in adjacency and share one table."""
        cache = self.__dict__.setdefault("_device_feats_cache", {})
        key = (dtype, str(device))
        if key not in cache:
            cache[key] = torch.from_numpy(
                np.ascontiguousarray(self.feats, dtype=np.float32)
            ).to(device=device, dtype=dtype).contiguous()
        return cache[key]
