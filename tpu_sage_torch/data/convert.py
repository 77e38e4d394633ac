"""ETL: external graph formats → ``problem.h5`` (counterpart of
``tpu_sage/data/convert.py``, with the same functions, flags and output).

Converts the williamleif/GraphSAGE example-data layout (``<prefix>-G.json``
networkx node-link graph, ``<prefix>-id_map.json``,
``<prefix>-class_map.json``, ``<prefix>-feats.npy``), Planetoid's raw
pickles, OGB's raw csv.gz layout, a single OGB-style ``.npz`` or a plain
edge list into one HDF5 artifact with the padded dense adjacency (schema in
``tpu_sage_torch/data/problem.py``, shared with the JAX package).
max_degree defaults to 128.

Graphs of more than 100,000 edges go through the native C++ code
(``tpu_sage_torch/native``) when it builds, smaller ones and every graph
without a toolchain through the numpy code
(``graph/graph_data.py::build_padded_adjacency``): the JAX package's rule, so
for the same input and seed both packages write the same file. This is host
ETL: nothing here touches a device.

    python -m tpu_sage_torch.data.convert --inpath DIR --outpath problem.h5
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from tpu_sage_torch import native
from tpu_sage_torch.data import hdf5
from tpu_sage_torch.data.synthetic import fold_codes_from_folds
from tpu_sage_torch.graph.graph_data import GraphStore, build_padded_adjacency


def generate_walks(
    adj: np.ndarray, degrees: np.ndarray, starts: np.ndarray,
    n_walks: int, walk_len: int, seed: int = 0,
) -> np.ndarray:
    """Random-walk corpus ``(n_starts, n_walks, walk_len+1)``, the
    reference ETL's ``walks.txt``. Uses the native C++ generator when it
    builds, else the vectorized numpy walk (the two draw different
    streams)."""
    if native.available():
        return native.random_walks(adj, degrees, starts, n_walks, walk_len, seed)
    rng = np.random.default_rng(seed)
    cur = np.repeat(starts.astype(np.int32), n_walks).reshape(-1)
    out = np.empty((len(cur), walk_len + 1), dtype=np.int32)
    out[:, 0] = cur
    for t in range(1, walk_len + 1):
        deg = np.maximum(degrees[cur], 1)
        cols = (rng.random(len(cur)) * deg).astype(np.int64)
        cur = adj[cur, np.minimum(cols, deg - 1)].astype(np.int32)
        out[:, t] = cur
    return out.reshape(len(starts), n_walks, walk_len + 1)


def save_problem_h5(store: GraphStore, outpath: str,
                    walks: "np.ndarray | None" = None) -> None:
    """Write a GraphStore to the problem.h5 schema (+ optional walk corpus),
    as the JAX package's converter does, without h5py (``data/hdf5.py``)."""
    os.makedirs(os.path.dirname(os.path.abspath(outpath)), exist_ok=True)
    datasets = {
        "adj": store.adj.astype(np.int32),
        "train_adj": store.train_adj.astype(np.int32),
        "degrees": store.degrees.astype(np.int32),
        "train_degrees": store.train_degrees.astype(np.int32),
        "feats": store.feats.astype(np.float32),
        "targets": store.targets,
        "folds": fold_codes_from_folds(store.n_nodes, store.folds),
    }
    if walks is not None:
        datasets["walks"] = walks.astype(np.int32)
    hdf5.write(outpath, datasets, {"task": store.task, "n_classes": int(store.n_classes)})


def from_edgelist(
    edges: np.ndarray,
    feats: np.ndarray,
    targets: np.ndarray,
    folds: Dict[str, np.ndarray],
    task: str = "classification",
    n_classes: Optional[int] = None,
    max_degree: int = 128,
    seed: int = 0,
) -> GraphStore:
    """Generic ingester: edge list + per-node arrays → GraphStore.

    ``train_adj`` keeps only edges between train-fold nodes (the inductive
    split).
    """
    n_nodes = feats.shape[0]
    rng = np.random.default_rng(seed)
    is_train = np.zeros(n_nodes, dtype=bool)
    is_train[folds["train"]] = True
    train_edges = edges[is_train[edges[:, 0]] & is_train[edges[:, 1]]]

    # big graphs go through the native C++ code when it builds
    if len(edges) > 100_000 and native.available():
        adj, degrees = native.build_padded_adjacency(edges, n_nodes, max_degree, seed)
        train_adj, train_degrees = native.build_padded_adjacency(
            train_edges, n_nodes, max_degree, seed + 1
        )
    else:
        adj, degrees = build_padded_adjacency(edges, n_nodes, max_degree, rng)
        train_adj, train_degrees = build_padded_adjacency(
            train_edges, n_nodes, max_degree, rng
        )
    if n_classes is None:
        if task == "classification":
            n_classes = int(targets.max()) + 1
        elif targets.ndim == 2:
            n_classes = targets.shape[1]
        else:
            n_classes = 0
    return GraphStore(
        adj=adj,
        degrees=degrees,
        train_adj=train_adj,
        train_degrees=train_degrees,
        feats=feats.astype(np.float32),
        targets=targets,
        folds={k: np.asarray(v, dtype=np.int64) for k, v in folds.items()},
        task=task,
        n_classes=n_classes,
    )


def from_wl_json(inpath: str, prefix: Optional[str] = None, max_degree: int = 128,
                 task: Optional[str] = None, seed: int = 0) -> GraphStore:
    """williamleif example-data layout → GraphStore.

    ``inpath`` is the directory; ``prefix`` defaults to the directory name
    (e.g. ``toy-ppi`` for ``toy-ppi-G.json``). Multilabel is auto-detected
    from class_map values being lists.
    """
    if prefix is None:
        prefix = os.path.basename(os.path.normpath(inpath))

    def p(suffix):
        return os.path.join(inpath, f"{prefix}-{suffix}")

    with open(p("G.json")) as f:
        g = json.load(f)
    with open(p("id_map.json")) as f:
        id_map = json.load(f)
    with open(p("class_map.json")) as f:
        class_map = json.load(f)
    feats = np.load(p("feats.npy")).astype(np.float32)

    n_nodes = len(id_map)
    remap = {k: int(v) for k, v in id_map.items()}

    # node-link format: nodes carry 'id', 'val', 'test' attrs
    val_mask = np.zeros(n_nodes, dtype=bool)
    test_mask = np.zeros(n_nodes, dtype=bool)
    for node in g["nodes"]:
        i = remap[str(node["id"])]
        val_mask[i] = bool(node.get("val", False))
        test_mask[i] = bool(node.get("test", False))
    folds = {
        "val": np.nonzero(val_mask)[0].astype(np.int64),
        "test": np.nonzero(test_mask & ~val_mask)[0].astype(np.int64),
        "train": np.nonzero(~val_mask & ~test_mask)[0].astype(np.int64),
    }

    edges = np.array(
        [
            [remap[str(e["source"])], remap[str(e["target"])]]
            for e in g["links"]
        ],
        dtype=np.int64,
    ).reshape(-1, 2)

    sample_val = next(iter(class_map.values()))
    multilabel = isinstance(sample_val, (list, tuple))
    if task is None:
        task = "multilabel_classification" if multilabel else "classification"
    if multilabel:
        n_classes = len(sample_val)
        targets = np.zeros((n_nodes, n_classes), dtype=np.float32)
        for k, v in class_map.items():
            targets[remap[str(k)]] = np.asarray(v, dtype=np.float32)
    else:
        targets = np.zeros(n_nodes, dtype=np.int64)
        for k, v in class_map.items():
            targets[remap[str(k)]] = int(v)
        n_classes = int(targets.max()) + 1

    return from_edgelist(
        edges, feats, targets, folds, task=task, n_classes=n_classes,
        max_degree=max_degree, seed=seed,
    )


def from_planetoid(inpath: str, name: str, max_degree: int = 128,
                   seed: int = 0) -> GraphStore:
    """Planetoid raw pickles (Cora/Citeseer/Pubmed) → GraphStore.

    Drop-in ingester for the standard ``ind.{name}.{x,tx,allx,y,ty,ally,
    graph,test.index}`` layout (Kipf's GCN repo / torch_geometric raw dir) so
    real Planetoid data works the moment it lands on disk. Follows the canonical loading
    protocol: features = vstack(allx, tx) with the test block re-ordered by
    ``test.index``; train fold = the first ``len(y)`` nodes, val = the next
    500, test = the test.index range (Citeseer's isolated test nodes are
    zero-patched, as in the reference implementations).
    """
    import pickle

    from scipy import sparse as sp

    def load(suffix):
        with open(os.path.join(inpath, f"ind.{name}.{suffix}"), "rb") as f:
            return pickle.load(f, encoding="latin1")

    x, tx, allx = load("x"), load("tx"), load("allx")
    y, ty, ally = load("y"), load("ty"), load("ally")
    graph = load("graph")
    with open(os.path.join(inpath, f"ind.{name}.test.index")) as f:
        test_idx = np.array([int(l.strip()) for l in f if l.strip()], np.int64)
    test_range = np.sort(test_idx)

    n_test_span = int(test_range[-1]) - int(test_range[0]) + 1
    if n_test_span > tx.shape[0]:
        # citeseer: isolated test nodes absent from tx — zero-patch the span
        tx_ext = sp.lil_matrix((n_test_span, x.shape[1]), dtype=np.float32)
        tx_ext[test_range - test_range[0]] = tx
        tx = tx_ext.tocsr()
        ty_ext = np.zeros((n_test_span, y.shape[1]), dtype=ty.dtype)
        ty_ext[test_range - test_range[0]] = ty
        ty = ty_ext

    feats = sp.vstack([allx, tx]).toarray().astype(np.float32)
    labels = np.vstack([ally, ty])
    # undo the shuffled test-block ordering
    feats[test_idx] = feats[test_range]
    labels[test_idx] = labels[test_range]
    n_nodes = feats.shape[0]

    targets = np.argmax(labels, axis=1).astype(np.int64)
    # the canonical 500-node val window after the train block, clipped to the
    # graph and disjoint from the test range (always true on real Planetoid;
    # matters for toy fixtures)
    val = np.arange(len(y), min(len(y) + 500, n_nodes), dtype=np.int64)
    val = val[~np.isin(val, test_range)]
    folds = {
        "train": np.arange(len(y), dtype=np.int64),
        "val": val,
        "test": test_range,
    }
    edges = np.array(
        [[u, v] for u, nbrs in graph.items() for v in nbrs if u != v],
        dtype=np.int64,
    ).reshape(-1, 2)
    edges = edges[(edges[:, 0] < n_nodes) & (edges[:, 1] < n_nodes)]
    return from_edgelist(
        edges, feats, targets, folds, task="classification",
        n_classes=labels.shape[1], max_degree=max_degree, seed=seed,
    )


def from_ogb_npz(path: str, max_degree: int = 128, seed: int = 0,
                 task: str = "classification") -> GraphStore:
    """Single-file OGB-style npz → GraphStore.

    Keys: ``edges (E,2)``, ``feats (n,F)``, ``labels (n,) or (n,C)``,
    ``train_idx``, ``val_idx``, ``test_idx``. The drop-in format for
    OGBN-scale data: one ``np.savez(path, edges=…, feats=…, …)`` away from
    any loader.
    """
    z = np.load(path)
    labels = z["labels"]
    single_col = labels.ndim == 1 or labels.shape[1] == 1
    if task.startswith("regression"):
        # regression targets stay float and keep a (n, d) shape
        targets = labels.astype(np.float32)
        if targets.ndim == 1:
            targets = targets[:, None]
    elif single_col:
        targets = labels.reshape(-1).astype(np.int64)
    else:
        targets = labels.astype(np.float32)
        task = "multilabel_classification"
    folds = {
        "train": z["train_idx"].astype(np.int64),
        "val": z["val_idx"].astype(np.int64),
        "test": z["test_idx"].astype(np.int64),
    }
    return from_edgelist(
        z["edges"].astype(np.int64), z["feats"].astype(np.float32), targets,
        folds, task=task, max_degree=max_degree, seed=seed,
    )


def from_ogb(root: str, name: str, max_degree: int = 128,
             seed: int = 0) -> GraphStore:
    """OGB node-property raw csv.gz layout → GraphStore (no ogb package).

    Reads ``<root>/<name>/raw/{edge,node-feat,node-label,num-node-list}.csv.gz``
    and ``<root>/<name>/split/*/{train,valid,test}.csv.gz`` — the on-disk
    layout ``ogb.nodeproppred`` produces, parsed with numpy only so the
    (uninstallable offline) ogb package is not required.
    """
    import glob
    import gzip

    base = os.path.join(root, name)

    def read_csv_gz(path, dtype):
        with gzip.open(path, "rt") as f:
            return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)

    raw = os.path.join(base, "raw")
    edges = read_csv_gz(os.path.join(raw, "edge.csv.gz"), np.int64)
    feats = read_csv_gz(os.path.join(raw, "node-feat.csv.gz"), np.float32)
    labels = read_csv_gz(os.path.join(raw, "node-label.csv.gz"), np.float32)
    split_dirs = sorted(glob.glob(os.path.join(base, "split", "*")))
    if not split_dirs:
        raise FileNotFoundError(f"no split directory under {base}/split")
    split = split_dirs[0]
    folds = {
        k: read_csv_gz(os.path.join(split, f"{f}.csv.gz"), np.int64).reshape(-1)
        for k, f in (("train", "train"), ("val", "valid"), ("test", "test"))
    }
    targets = (
        labels.reshape(-1).astype(np.int64)
        if labels.shape[1] == 1
        else labels.astype(np.float32)
    )
    task = "classification" if targets.ndim == 1 else "multilabel_classification"
    return from_edgelist(
        edges, feats, targets, folds, task=task, max_degree=max_degree,
        seed=seed,
    )


def main(argv=None):
    """``python -m tpu_sage_torch.data.convert --inpath DIR --outpath problem.h5``"""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--inpath", required=True)
    ap.add_argument("--outpath", required=True)
    ap.add_argument("--format", default="wl-json",
                    choices=["wl-json", "planetoid", "ogb", "ogb-npz"])
    ap.add_argument("--name", default=None,
                    help="dataset name for planetoid/ogb (e.g. cora, "
                         "ogbn-products)")
    ap.add_argument("--prefix", default=None)
    ap.add_argument("--max-degree", type=int, default=128)
    ap.add_argument("--task", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-walks", type=int, default=0,
                    help="also store a random-walk corpus (train adjacency)")
    ap.add_argument("--walk-length", type=int, default=5)
    args = ap.parse_args(argv)
    if args.format == "planetoid":
        store = from_planetoid(args.inpath, args.name or "cora",
                               max_degree=args.max_degree, seed=args.seed)
    elif args.format == "ogb":
        store = from_ogb(args.inpath, args.name or "ogbn-products",
                         max_degree=args.max_degree, seed=args.seed)
    elif args.format == "ogb-npz":
        store = from_ogb_npz(args.inpath, max_degree=args.max_degree,
                             seed=args.seed,
                             task=args.task or "classification")
    else:
        store = from_wl_json(
            args.inpath, args.prefix, max_degree=args.max_degree,
            task=args.task, seed=args.seed,
        )
    walks = None
    if args.n_walks > 0:
        walks = generate_walks(
            store.train_adj, store.train_degrees,
            np.arange(store.n_nodes), args.n_walks, args.walk_length, args.seed,
        )
    save_problem_h5(store, args.outpath, walks=walks)
    print(json.dumps({
        "n_nodes": store.n_nodes, "max_degree": store.max_degree,
        "feat_dim": store.feat_dim, "task": store.task,
        "n_classes": store.n_classes, "outpath": args.outpath,
    }))


if __name__ == "__main__":
    main()
