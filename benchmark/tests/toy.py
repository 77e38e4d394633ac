"""Cells cut to a size the CPU runs in seconds, for the benchmark's tests.
The widths, fanouts and batch shrink together; the code paths are the
cell's own. ``cells()`` are the cells of ``BENCHMARK.json`` and the
deferred ones (``deferred/<cell>.json``)."""

from __future__ import annotations

import copy
import os

from benchmark import harness

TOY_GRAPH = dict(n_nodes=3000, feat_dim=32, n_classes=5, degree=16)
TOY_MODEL = dict(n_train_samples=[5, 3], n_val_samples=[5, 3], output_dims=[16, 16],
                 agg_hidden_dim=24)
TRAIN = "reddit-sup.train-b512"
EXACT = "reddit-sup.exact-embed"
POOL = "reddit-maxpool.exact-embed"


def toy(spec: dict) -> dict:
    spec = copy.deepcopy(spec)
    spec["config"]["graph"].update(TOY_GRAPH)
    spec["config"]["model"].update(TOY_MODEL)
    if "batch_size" in spec["traffic"]:
        spec["traffic"]["batch_size"] = 64
    if "chunk" in spec["traffic"]:
        spec["traffic"]["chunk"] = 512
    return spec


def toy_cell(name: str, root: str = harness.ROOT) -> dict:
    return toy(harness.load_cell(name, root))


def cells(root: str = harness.ROOT) -> list:
    listed = [w["name"] for w in harness.load_json(root, "BENCHMARK.json")["workloads"]]
    deferred = sorted(f[:-len(".json")] for f in os.listdir(os.path.join(root, "benchmark",
                                                                          "deferred")))
    return listed + deferred
