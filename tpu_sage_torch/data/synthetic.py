"""Synthetic graph stores for tests and benchmarks (counterpart of
``tpu_sage/data/synthetic.py``).

Both generators draw the same numpy random numbers as the reference, so the
same arguments give bit-equal arrays:

- ``sbm_store``: a stochastic-block-model graph with class-correlated
  features — learnable, used for convergence tests ("Cora-like").
- ``bench_store``: a Reddit-shaped random neighbor table with class-clustered
  features (232,965 nodes, 602 features, 41 classes, max degree 128).
- ``assortative_bench_store``: Reddit-shaped, with the label signal in the
  edges (a feature-only probe reaches about 0.12): quality shows only
  through aggregation.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from tpu_sage_torch.data.problem import NodeProblem
from tpu_sage_torch.graph.graph_data import GraphStore, build_padded_adjacency

_DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "tpu_sage_torch", "bench_cache",
)


def _split_folds(
    n: int, rng: np.random.Generator, val_frac: float = 0.2, test_frac: float = 0.2
) -> Dict[str, np.ndarray]:
    perm = rng.permutation(n)
    n_val = int(n * val_frac)
    n_test = int(n * test_frac)
    return {
        "val": np.sort(perm[:n_val]).astype(np.int64),
        "test": np.sort(perm[n_val : n_val + n_test]).astype(np.int64),
        "train": np.sort(perm[n_val + n_test :]).astype(np.int64),
    }


def sbm_store(
    n_nodes: int = 2708,
    n_classes: int = 7,
    feat_dim: int = 64,
    avg_degree: int = 8,
    p_in: float = 0.9,
    feat_noise: float = 1.0,
    max_degree: int = 32,
    task: str = "classification",
    seed: int = 0,
    centroid_seed: Optional[int] = None,
) -> GraphStore:
    """Stochastic-block-model GraphStore with class-signal features.

    Each node draws ``avg_degree`` endpoints; with prob ``p_in`` the endpoint
    is same-class, else uniform. Features are the class centroid (a random
    vector of norm 3) plus N(0, feat_noise). The train adjacency keeps only
    edges whose both endpoints are train-fold nodes. ``centroid_seed`` draws
    the class→feature mapping from its own generator (None: the single-seed
    draw).
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n_nodes)
    by_class = [np.nonzero(labels == c)[0] for c in range(n_classes)]

    src = np.repeat(np.arange(n_nodes), avg_degree)
    same = rng.random(len(src)) < p_in
    dst = rng.integers(0, n_nodes, size=len(src))
    for c in range(n_classes):
        mask = same & (labels[src] == c)
        if mask.any() and len(by_class[c]):
            dst[mask] = rng.choice(by_class[c], size=mask.sum())
    keep = src != dst
    edges = np.stack([src[keep], dst[keep]], axis=1)

    folds = _split_folds(n_nodes, rng)
    adj, degrees = build_padded_adjacency(edges, n_nodes, max_degree, rng)
    is_train = np.zeros(n_nodes, dtype=bool)
    is_train[folds["train"]] = True
    train_edges = edges[is_train[edges[:, 0]] & is_train[edges[:, 1]]]
    train_adj, train_degrees = build_padded_adjacency(train_edges, n_nodes, max_degree, rng)

    crng = rng if centroid_seed is None else np.random.default_rng(centroid_seed)
    centroids = crng.normal(size=(n_classes, feat_dim)).astype(np.float32)
    centroids *= 3.0 / np.linalg.norm(centroids, axis=1, keepdims=True)
    feats = centroids[labels] + rng.normal(
        scale=feat_noise, size=(n_nodes, feat_dim)
    ).astype(np.float32)

    if task == "classification":
        targets = labels.astype(np.int64)
    elif task == "multilabel_classification":
        targets = np.zeros((n_nodes, n_classes), dtype=np.float32)
        targets[np.arange(n_nodes), labels] = 1.0
        extra = rng.random((n_nodes, n_classes)) < 0.1
        targets = np.maximum(targets, extra.astype(np.float32))
    elif task in ("regression", "regression_mae"):
        w = crng.normal(size=(feat_dim, 1)).astype(np.float32)
        targets = (feats @ w + rng.normal(scale=0.1, size=(n_nodes, 1))).astype(np.float32)
        n_classes = 1  # regression head width = target columns
    else:
        raise ValueError(f"unknown task: {task}")

    return GraphStore(
        adj=adj, degrees=degrees, train_adj=train_adj, train_degrees=train_degrees,
        feats=feats.astype(np.float32), targets=targets, folds=folds,
        task=task, n_classes=n_classes,
    )


def sbm_problem(**kwargs) -> NodeProblem:
    return NodeProblem(sbm_store(**kwargs))


def assortative_bench_store(
    n_nodes: int = 232_965,
    feat_dim: int = 602,
    n_classes: int = 41,
    max_degree: int = 128,
    p_in: float = 0.7,
    feat_signal: float = 0.05,  # calibrated: feature-only probe about 0.12 (41
    feat_noise: float = 1.0,    # classes); 25-neighbor aggregation separates fully
    seed: int = 0,
) -> GraphStore:
    """Reddit-scale graph where the graph carries the label signal.

    Each adjacency slot is same-class with probability ``p_in`` (else a
    uniform random node), and the features carry only a weak class signal,
    so good accuracy needs neighborhood aggregation, not a linear probe of
    the features. Every node has full degree.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n_nodes)
    order = np.argsort(labels, kind="stable")
    sorted_labels = labels[order]
    class_start = np.searchsorted(sorted_labels, np.arange(n_classes))
    class_size = np.bincount(labels, minlength=n_classes)

    same = rng.random((n_nodes, max_degree)) < p_in
    start = class_start[labels][:, None]
    size = np.maximum(class_size[labels][:, None], 1)
    within = (rng.random((n_nodes, max_degree)) * size).astype(np.int64)
    same_ids = order[start + np.minimum(within, size - 1)]
    other_ids = rng.integers(0, n_nodes, size=(n_nodes, max_degree))
    adj = np.where(same, same_ids, other_ids).astype(np.int32)
    degrees = np.full(n_nodes, max_degree, dtype=np.int32)

    centroids = rng.normal(size=(n_classes, feat_dim)).astype(np.float32)
    feats = (
        feat_signal * centroids[labels]
        + rng.normal(scale=feat_noise, size=(n_nodes, feat_dim))
    ).astype(np.float32)
    folds = _split_folds(n_nodes, rng, val_frac=0.1, test_frac=0.1)
    return GraphStore(
        adj=adj, degrees=degrees, train_adj=adj, train_degrees=degrees,
        feats=feats, targets=labels.astype(np.int64), folds=folds,
        task="classification", n_classes=n_classes,
    )


def bench_store(
    n_nodes: int = 232_965,
    feat_dim: int = 602,
    n_classes: int = 41,
    max_degree: int = 128,
    seed: int = 0,
    cache_dir: Optional[str] = None,
) -> GraphStore:
    """Reddit-shaped random graph for throughput runs.

    The neighbor table is uniform-random ids at full degree; features are
    class-clustered so training has signal. The arrays are cached as an
    ``.npz`` in ``cache_dir`` (default ``$TPU_SAGE_TORCH_BENCH_CACHE``, else
    ``build/tpu_sage_torch/bench_cache`` in the checkout; ``"0"`` disables
    the cache). Cached or not, the same arguments give bit-equal arrays.
    """
    cache_dir = cache_dir or os.environ.get("TPU_SAGE_TORCH_BENCH_CACHE", _DEFAULT_CACHE)
    cache_path = None
    if cache_dir and cache_dir != "0":
        cache_path = os.path.join(
            cache_dir,
            f"bench_store_{n_nodes}_{feat_dim}_{n_classes}_{max_degree}_{seed}.npz",
        )
        if os.path.exists(cache_path):
            with np.load(cache_path) as z:
                return _bench_graph_store(
                    z["adj"], z["feats"], z["targets"],
                    {k: z[f"fold_{k}"] for k in ("train", "val", "test")},
                    n_classes,
                )

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n_nodes)
    adj = rng.integers(0, n_nodes, size=(n_nodes, max_degree), dtype=np.int64).astype(
        np.int32
    )
    centroids = rng.normal(size=(n_classes, feat_dim)).astype(np.float32)
    feats = (centroids[labels] + rng.normal(size=(n_nodes, feat_dim))).astype(np.float32)
    folds = _split_folds(n_nodes, rng, val_frac=0.1, test_frac=0.1)
    targets = labels.astype(np.int64)
    if cache_path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        # atomic publish, from a file of this process's own: the ranks of a
        # partitioned run build the same store at once
        tmp_path = f"{cache_path}.{os.getpid()}.tmp.npz"
        with open(tmp_path, "wb") as f:
            np.savez(f, adj=adj, feats=feats, targets=targets,
                     **{f"fold_{k}": v for k, v in folds.items()})
        os.replace(tmp_path, cache_path)
    return _bench_graph_store(adj, feats, targets, folds, n_classes)


def _bench_graph_store(adj, feats, targets, folds, n_classes) -> GraphStore:
    degrees = np.full(adj.shape[0], adj.shape[1], dtype=np.int32)
    return GraphStore(
        adj=adj, degrees=degrees, train_adj=adj, train_degrees=degrees,
        feats=feats, targets=targets, folds=folds,
        task="classification", n_classes=n_classes,
    )


def synthetic_problem(kind: str, n_nodes: int, n_classes: int, feat_dim: int, seed: int,
                      task: str = "classification") -> NodeProblem:
    """The CLI's and the exporter's ``--synthetic`` problem: ``"sbm"`` (an
    ``sbm_store``) or ``"reddit-shaped"`` (a ``bench_store`` of ``n_nodes``;
    its classes, width and degree are Reddit's)."""
    if kind == "sbm":
        return NodeProblem(sbm_store(n_nodes=n_nodes, n_classes=n_classes, feat_dim=feat_dim,
                                     task=task, seed=seed))
    if kind == "reddit-shaped":
        return NodeProblem(bench_store(n_nodes=n_nodes, seed=seed))
    raise ValueError(f"unknown synthetic problem {kind!r}; expected 'sbm' or 'reddit-shaped'")
