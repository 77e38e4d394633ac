"""Graph storage: padded fixed-max-degree neighbor tables.

Counterpart of ``tpu_sage/graph/graph_data.py``. The graph is a dense
``(n_nodes, max_degree)`` table of neighbor ids, padded at ETL time, so every
minibatch tensor has a static shape.

Padding idiom (same as the reference): rows with ``degree < max_degree`` are
padded with the node's own id (self-loop), and ``degree == 0`` rows are
all-self. The sampler only draws column indices in ``[0, max(degree, 1))``,
so padding values are never selected except for isolated nodes, which
self-loop. ``CSRDeviceGraph`` is the memory-lean storage: ``nnz`` neighbor
ids instead of ``n·max_degree``. Either graph's ``feats`` may be a
``data/quantize.py::QuantizedFeats`` (int8 rows, per-column scales).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from tpu_sage_torch.data.quantize import quantize_feats
from tpu_sage_torch.sample.csr import csr_from_padded, pad_indices_for_window


@dataclasses.dataclass
class DeviceGraph:
    """The on-device graph: everything the train step touches, on one device."""

    adj: torch.Tensor      # (n_nodes, max_degree) int32, padded with self id
    degrees: torch.Tensor  # (n_nodes,) int32 true degree (0 allowed)
    feats: torch.Tensor    # (n_nodes, feat_dim) float32 or bfloat16, or a
    # QuantizedFeats, or raw int8 with feat_scale set
    targets: torch.Tensor  # (n_nodes,) int32 or (n_nodes, n_targets) float
    feat_scale: Optional[torch.Tensor] = None  # (feat_dim,) per-column scales
    # of a raw int8 feats (the partitioned layout); None on the single device

    @property
    def device(self) -> torch.device:
        return self.adj.device


@dataclasses.dataclass
class CSRDeviceGraph:
    """CSR variant of ``DeviceGraph``, with the same non-adjacency fields;
    the sampler dispatches on the presence of ``indptr``
    (``sample/csr.py::graph_sample_tree``)."""

    indptr: torch.Tensor   # (n_nodes + 1,) int32
    indices: torch.Tensor  # (nnz [+ window padding],) int32
    degrees: torch.Tensor  # (n_nodes,) int32
    feats: torch.Tensor    # as DeviceGraph.feats
    targets: torch.Tensor
    window: int = 0  # >= the true max degree, indices padded for the window
    # hop (to_device_csr sets both); 0 selects the element hop

    @property
    def device(self) -> torch.device:
        return self.degrees.device


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

    @property
    def max_degree(self) -> int:
        return self.adj.shape[1]

    def to_device(
        self, train: bool, dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda", quantize: bool = False,
    ) -> DeviceGraph:
        device = torch.device(device)
        adj = self.train_adj if train else self.adj
        deg = self.train_degrees if train else self.degrees
        return DeviceGraph(
            adj=_int32(adj, device),
            degrees=_int32(deg, device),
            feats=self._device_feats(dtype, device, quantize),
            targets=self._device_targets(dtype, device),
        )

    def to_device_csr(
        self, train: bool, dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda", quantize: bool = False,
    ) -> CSRDeviceGraph:
        """CSR upload: ``nnz`` ids on the device instead of ``n·max_degree``,
        padded for the window hop (window = the true max degree)."""
        device = torch.device(device)
        adj = self.train_adj if train else self.adj
        deg = self.train_degrees if train else self.degrees
        indptr, indices = csr_from_padded(adj, deg)
        window = max(1, int(deg.max())) if len(deg) else 1
        return CSRDeviceGraph(
            indptr=_int32(indptr, device),
            indices=_int32(pad_indices_for_window(indices, window), device),
            degrees=_int32(deg, device),
            feats=self._device_feats(dtype, device, quantize),
            targets=self._device_targets(dtype, device),
            window=window,
        )

    def _device_targets(self, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
        tdtype = torch.int32 if self.task == "classification" else dtype
        return torch.as_tensor(self.targets).to(device=device, dtype=tdtype)

    def _device_feats(self, dtype: torch.dtype, device: torch.device, quantize: bool = False):
        """Feature upload, dense in ``dtype`` or int8 with per-column scales
        (``quantize``; ``dtype`` is then the compute dtype), cached per
        ``(dtype, device, quantize)``: the train-edge and full-edge graphs
        differ only in adjacency and share one table."""
        cache = self.__dict__.setdefault("_device_feats_cache", {})
        key = (dtype, str(device), quantize)
        if key not in cache:
            if quantize:
                cache[key] = quantize_feats(self.feats, out_dtype=dtype, device=device)
            else:
                cache[key] = torch.from_numpy(
                    np.ascontiguousarray(self.feats, dtype=np.float32)
                ).to(device=device, dtype=dtype).contiguous()
        return cache[key]


def _int32(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.int32).to(device).contiguous()
