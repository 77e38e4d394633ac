"""Graph partitioning for the node-sharded training path (counterpart of
``tpu_sage/dist/partition.py``).

Contiguous range partition: rank ``s`` owns global node ids
``[s·m, (s+1)·m)`` where ``m = ceil(n/n_shards)``; every per-node array
(adjacency, degrees, features, targets) is padded to ``n_shards·m`` rows.
Padding rows are degree-0 self-loops with zero features, never sampled
because fold ids only name real nodes. Ownership is a function of the id
(``owner = id // m``), so the halo exchange routes with integer arithmetic.

The numpy functions are the JAX package's, bitwise: the reordering passes
(``degree_balanced_permutation``, ``locality_permutation``, applied with
``reorder_store``), ``edge_cut_fraction``, the padded arrays, the per-shard
CSR blocks and the fold tables. ``shard_graph``/``shard_graph_csr`` put only
this rank's rows on this rank's device: dense feature shards in the compute
dtype (bf16 halves the exchanged bytes), or int8 shards with the replicated
per-column ``feat_scale``. Every rank holds the whole host store (each loads
the same problem file or synthesizes the same store) and uploads its slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_sage_torch.data.quantize import column_scales, quantize_rows
from tpu_sage_torch.dist.mesh import rank as _rank, world as _world
from tpu_sage_torch.graph.graph_data import DeviceGraph, GraphStore
from tpu_sage_torch.sample.csr import csr_from_padded, pad_indices_for_window


def pad_to_shards(n_nodes: int, n_shards: int) -> Tuple[int, int]:
    m = -(-n_nodes // n_shards)
    return m, m * n_shards


def degree_balanced_permutation(degrees: np.ndarray, n_shards: int) -> np.ndarray:
    """Node permutation that balances edges (not just nodes) across shards:
    nodes snake-ordered by descending degree into ``n_shards`` contiguous
    blocks whose sizes are the range partition's (``m``, ..., ``m``, the
    remainder, 0, ...), so the blocks line up with the ``m``-ranges. Returns
    ``perm`` with ``perm[new_id] = old_id``; apply with ``reorder_store``."""
    n = len(degrees)
    m = -(-n // n_shards)
    order = np.argsort(-degrees.astype(np.int64), kind="stable")
    q, r0 = divmod(n, m)

    def snake(count, width, start_round):
        i = np.arange(count, dtype=np.int64)
        rnd, pos = np.divmod(i, width)
        rnd = rnd + start_round
        return np.where(rnd % 2 == 0, pos, width - 1 - pos)

    n1 = r0 * (q + 1)
    shard_of_rank = np.concatenate(
        [snake(n1, q + 1, 0), snake(n - n1, max(q, 1), r0)]
    )
    return np.concatenate([order[shard_of_rank == s] for s in range(n_shards)])


def _row_mode(v: np.ndarray, invalid: int = -1) -> np.ndarray:
    """Per-row mode of a row-sorted int matrix, ignoring ``invalid`` entries;
    ties break to the smallest value. All-invalid rows return ``invalid``."""
    n, k = v.shape
    change = np.ones((n, k), dtype=bool)
    change[:, 1:] = v[:, 1:] != v[:, :-1]
    run_id = np.cumsum(change, axis=1) - 1
    counts = np.zeros((n, k), dtype=np.int32)
    np.add.at(counts, (np.repeat(np.arange(n), k), run_id.ravel()), 1)
    run_val = np.full((n, k), invalid, dtype=v.dtype)
    ii, jj = np.nonzero(change)
    run_val[ii, run_id[ii, jj]] = v[ii, jj]
    counts = np.where(run_val == invalid, 0, counts)
    best = np.argmax(counts, axis=1)
    pos = np.argmax(run_id == best[:, None], axis=1)
    return np.where(counts[np.arange(n), best] > 0, v[np.arange(n), pos],
                    invalid)


def locality_permutation(
    adj: np.ndarray, degrees: np.ndarray, sweeps: int = 20
) -> np.ndarray:
    """Label-propagation node ordering for partition locality: each node
    adopts the most common label of its closed neighborhood (labels start as
    node ids, ties to the smallest), synchronously, for up to ``sweeps``
    sweeps; ordering by final label (degree-descending within a label) lays
    communities out contiguously, so fewer edges cross shards
    (``edge_cut_fraction``). Returns ``perm`` with ``perm[new_id] = old_id``."""
    n = len(degrees)
    deg = degrees.astype(np.int64)
    labels = np.arange(n, dtype=np.int64)
    valid = np.arange(adj.shape[1])[None, :] < deg[:, None]
    for _ in range(sweeps):
        votes = np.concatenate(
            [np.where(valid, labels[adj], -1), labels[:, None]], axis=1
        )
        votes.sort(axis=1)
        new = _row_mode(votes)
        if np.array_equal(new, labels):
            break
        labels = new
    return np.lexsort((-deg, labels))


def edge_cut_fraction(store: GraphStore, n_shards: int) -> float:
    """Fraction of real adjacency entries whose neighbor lives on another
    shard under the range partition (remote halo queries per hop)."""
    n = store.n_nodes
    m, _ = pad_to_shards(n, n_shards)
    owner_row = (np.arange(n) // m)[:, None]
    valid = np.arange(store.adj.shape[1])[None, :] < store.degrees[:, None]
    cut = (store.adj // m != owner_row) & valid
    return float(cut.sum()) / max(int(valid.sum()), 1)


def reorder_store(store: GraphStore, perm: np.ndarray) -> GraphStore:
    """Relabel every node ``old → new`` where ``perm[new] = old``: per-node
    arrays permuted, adjacency contents remapped, folds relabeled."""
    n = store.n_nodes
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)

    def remap_adj(adj):
        return inv[adj[perm]].astype(np.int32)

    return GraphStore(
        adj=remap_adj(store.adj),
        degrees=store.degrees[perm],
        train_adj=remap_adj(store.train_adj),
        train_degrees=store.train_degrees[perm],
        feats=store.feats[perm],
        targets=store.targets[perm],
        folds={k: np.sort(inv[v]).astype(np.int64) for k, v in store.folds.items()},
        task=store.task,
        n_classes=store.n_classes,
    )


def partition_arrays(
    store: GraphStore, n_shards: int, train: bool
) -> Tuple[Dict[str, np.ndarray], int]:
    """Pad per-node arrays to ``n_shards·m`` rows; returns ``(arrays, m)``."""
    n = store.n_nodes
    m, n_pad = pad_to_shards(n, n_shards)
    pad = n_pad - n
    adj = store.train_adj if train else store.adj
    deg = store.train_degrees if train else store.degrees
    max_degree = store.adj.shape[1]
    pad_adj = np.broadcast_to(
        np.arange(n, n_pad, dtype=np.int32)[:, None], (pad, max_degree)
    )
    arrays = {
        "adj": np.concatenate([adj, pad_adj], axis=0).astype(np.int32),
        "degrees": np.concatenate([deg, np.zeros(pad, np.int32)]),
        "feats": np.concatenate(
            [store.feats, np.zeros((pad, store.feat_dim), store.feats.dtype)]
        ),
        "targets": np.concatenate(
            [store.targets, np.zeros((pad,) + store.targets.shape[1:], store.targets.dtype)]
        ),
    }
    return arrays, m


def partition_csr_arrays(
    store: GraphStore, n_shards: int, train: bool
) -> Tuple[Dict[str, np.ndarray], int, int]:
    """Per-shard CSR adjacency blocks padded to uniform shapes: each shard's
    ``m`` rows as a local CSR whose ``indices`` stay global ids, viewed as
    ``(r, window)`` rows for the window-pair gather (``halo.CSRPairRows``),
    padded to the heaviest shard's row count. Returns ``(arrays, m, window)``
    with ``indptr`` of shape ``(n_shards·(m+1),)`` and ``indices`` of shape
    ``(n_shards·r, window)``."""
    arrays, m = partition_arrays(store, n_shards, train)
    adj, deg = arrays["adj"], arrays["degrees"]
    window = max(1, int(deg.max())) if len(deg) else 1
    indptrs, blocks = [], []
    for s in range(n_shards):
        ip, ind = csr_from_padded(adj[s * m:(s + 1) * m], deg[s * m:(s + 1) * m])
        blocks.append(pad_indices_for_window(ind, window).reshape(-1, window))
        indptrs.append(ip)
    r_max = max(b.shape[0] for b in blocks)
    blocks = [np.concatenate([b, np.zeros((r_max - b.shape[0], window),
                                          np.int32)]) for b in blocks]
    arrays = dict(arrays)
    del arrays["adj"]
    arrays["indptr"] = np.concatenate(indptrs).astype(np.int32)
    arrays["indices"] = np.concatenate(blocks).astype(np.int32)
    return arrays, m, window


@dataclasses.dataclass
class CSRShardGraph:
    """This rank's CSR shard (``tpu_sage/graph/graph_data.py::CSRShardedGraph``):
    ``indptr (m+1,)`` local offsets, ``indices (r, window)`` global ids in
    window rows, ``degrees (m,)``, and the dense shard's feature, target and
    scale fields."""

    indptr: torch.Tensor
    indices: torch.Tensor
    degrees: torch.Tensor
    feats: torch.Tensor
    targets: torch.Tensor
    feat_scale: Optional[torch.Tensor]
    window: int

    @property
    def device(self) -> torch.device:
        return self.degrees.device


def _local_arrays(store: GraphStore, n_shards: int, s: int, train: bool):
    """Shard ``s``'s rows of ``partition_arrays`` without building the
    padded whole: ``(arrays, m)``."""
    n = store.n_nodes
    m, _ = pad_to_shards(n, n_shards)
    lo, hi = min(s * m, n), min((s + 1) * m, n)
    pad_ids = np.arange(max(s * m, n), (s + 1) * m, dtype=np.int32)
    k = len(pad_ids)
    adj = store.train_adj if train else store.adj
    deg = store.train_degrees if train else store.degrees
    arrays = {
        "adj": np.concatenate([adj[lo:hi], np.broadcast_to(
            pad_ids[:, None], (k, store.adj.shape[1]))]).astype(np.int32),
        "degrees": np.concatenate([deg[lo:hi], np.zeros(k, np.int32)]),
        "feats": np.concatenate([store.feats[lo:hi],
                                 np.zeros((k, store.feat_dim), store.feats.dtype)]),
        "targets": np.concatenate([store.targets[lo:hi], np.zeros(
            (k,) + store.targets.shape[1:], store.targets.dtype)]),
    }
    return arrays, m


def _put_features(store: GraphStore, local: np.ndarray, device: torch.device,
                  quantize: bool, feat_dtype: Optional[torch.dtype]):
    """This rank's feature rows: dense in ``feat_dtype`` (f32 by default),
    or int8 with the per-column scales of the whole table in
    ``feat_dtype`` (the padding rows change no column's maximum). Returns
    ``(feats, feat_scale)``; the scale is None for a dense table (the
    reference's ones, whose product is exact)."""
    dtype = feat_dtype or torch.float32
    if quantize:
        scale = column_scales(store.feats)
        return (torch.from_numpy(quantize_rows(local, scale)).to(device),
                torch.from_numpy(scale).to(device=device, dtype=dtype))
    host = torch.from_numpy(np.ascontiguousarray(local, dtype=np.float32))
    return host.to(device=device, dtype=dtype).contiguous(), None


def _reusable(reuse_feats, shape: Tuple[int, int], quantize: bool,
              feat_dtype: Optional[torch.dtype]):
    """``reuse_feats`` if it is the table the requested storage would
    upload, None when its shape differs (a partition of another size:
    upload fresh); raises on a dtype, or a ``feat_scale`` presence, that
    ``quantize`` and ``feat_dtype`` do not imply (int8 rows with a scale, or
    dense rows in ``feat_dtype`` without one)."""
    if reuse_feats is None or tuple(reuse_feats[0].shape) != shape:
        return None
    feats, scale = reuse_feats
    want = torch.int8 if quantize else (feat_dtype or torch.float32)
    if feats.dtype != want or (scale is not None) != quantize:
        raise ValueError(
            f"reuse_feats holds {feats.dtype} rows {'with' if scale is not None else 'without'}"
            f" a feat_scale; the requested storage (quantize={quantize}, feat_dtype="
            f"{feat_dtype}) uploads {want} rows {'with' if quantize else 'without'} one")
    return reuse_feats


def _targets(store: GraphStore, targets: np.ndarray, device: torch.device) -> torch.Tensor:
    dtype = torch.int32 if store.task == "classification" else torch.float32
    return torch.as_tensor(targets).to(device=device, dtype=dtype)


def _int32(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.int32).to(device).contiguous()


def shard_graph(
    store: GraphStore, train: bool, device: str | torch.device = "cuda",
    feat_dtype: Optional[torch.dtype] = None, quantize: bool = False, reuse_feats=None,
    n_shards: Optional[int] = None, shard: Optional[int] = None,
) -> Tuple[DeviceGraph, int]:
    """This rank's shard of the padded graph as a ``DeviceGraph`` on
    ``device``: ``adj (m, max_degree)`` of global ids, degrees, feature rows
    (``feat_dtype``, or int8 with ``feat_scale`` when ``quantize``), targets
    (shard ``s`` of ``partition_arrays``, built from its rows alone).
    ``reuse_feats``: a ``(feats, feat_scale)`` pair of the same shape to
    adopt instead of uploading (the train and eval graphs differ only in
    adjacency). ``n_shards``/``shard`` default to the group's world and
    rank. Returns ``(graph, m)``."""
    n_shards = _world() if n_shards is None else n_shards
    s = _rank() if shard is None else shard
    device = torch.device(device)
    arrays, m = _local_arrays(store, n_shards, s, train)
    feats, scale = (_reusable(reuse_feats, (m, store.feat_dim), quantize, feat_dtype)
                    or _put_features(store, arrays["feats"], device, quantize, feat_dtype))
    graph = DeviceGraph(
        adj=_int32(arrays["adj"], device),
        degrees=_int32(arrays["degrees"], device),
        feats=feats,
        targets=_targets(store, arrays["targets"], device),
        feat_scale=scale,
    )
    return graph, m


def shard_graph_csr(
    store: GraphStore, train: bool, device: str | torch.device = "cuda",
    feat_dtype: Optional[torch.dtype] = None, quantize: bool = False, reuse_feats=None,
    n_shards: Optional[int] = None, shard: Optional[int] = None,
) -> Tuple[CSRShardGraph, int]:
    """CSR-adjacency variant of ``shard_graph``: shard ``s``'s block of
    ``partition_csr_arrays`` (its row count padded to the heaviest shard's,
    found from the degrees) as a ``CSRShardGraph``. Returns ``(graph, m)``."""
    n_shards = _world() if n_shards is None else n_shards
    s = _rank() if shard is None else shard
    device = torch.device(device)
    arrays, m = _local_arrays(store, n_shards, s, train)
    deg_all = (store.train_degrees if train else store.degrees).astype(np.int64)
    window = max(1, int(deg_all.max())) if len(deg_all) else 1
    nnz = np.add.reduceat(deg_all, np.arange(0, store.n_nodes, m)) if store.n_nodes else []
    nnz = np.concatenate([nnz, np.zeros(n_shards - len(nnz), np.int64)])
    r_max = int(max((z + (-z % window) + 2 * window) // window for z in nnz))
    indptr, ind = csr_from_padded(arrays["adj"], arrays["degrees"])
    block = pad_indices_for_window(ind, window).reshape(-1, window)
    block = np.concatenate([block, np.zeros((r_max - block.shape[0], window), np.int32)])
    feats, scale = (_reusable(reuse_feats, (m, store.feat_dim), quantize, feat_dtype)
                    or _put_features(store, arrays["feats"], device, quantize, feat_dtype))
    graph = CSRShardGraph(
        indptr=_int32(indptr, device),
        indices=_int32(block, device),
        degrees=_int32(arrays["degrees"], device),
        feats=feats,
        targets=_targets(store, arrays["targets"], device),
        feat_scale=scale,
        window=window,
    )
    return graph, m


def shard_fold(
    fold_ids: np.ndarray, n_shards: int, shard_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Fold ids grouped by owner shard into a dense ``(n_shards, L)`` table;
    shards with fewer fold nodes wrap around. Returns ``(ids, count)`` with
    ``count[s]`` the true number of fold nodes on shard ``s`` (f32): the
    loss weight and the sampling bound. Empty shards point at their first
    node with count 0."""
    owners = fold_ids // shard_size
    groups = [fold_ids[owners == s] for s in range(n_shards)]
    L = max(1, max(len(g) for g in groups))
    out = np.zeros((n_shards, L), dtype=np.int64)
    count = np.zeros(n_shards, dtype=np.float32)
    for s, g in enumerate(groups):
        if len(g) == 0:
            out[s] = s * shard_size
        else:
            reps = -(-L // len(g))
            out[s] = np.tile(g, reps)[:L]
            count[s] = len(g)
    return out, count


def shard_fold_masked(
    fold_ids: np.ndarray, n_shards: int, shard_size: int,
    pad_to_multiple: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Evaluation's variant: ``(ids (n_shards, L), mask)``, padding slots
    masked 0, so each fold node counts exactly once."""
    owners = fold_ids // shard_size
    groups = [fold_ids[owners == s] for s in range(n_shards)]
    L = max(1, max(len(g) for g in groups))
    if pad_to_multiple > 1:
        L = -(-L // pad_to_multiple) * pad_to_multiple
    ids = np.full((n_shards, L), 0, dtype=np.int64)
    mask = np.zeros((n_shards, L), dtype=np.float32)
    for s, g in enumerate(groups):
        ids[s] = s * shard_size
        ids[s, : len(g)] = g
        mask[s, : len(g)] = 1.0
    return ids, mask
