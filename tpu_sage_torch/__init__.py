"""tpu_sage_torch — the PyTorch + CUDA port of tpu_sage for NVIDIA Hopper.

A package of its own beside the JAX reference ``tpu_sage``: it imports
``torch`` and numpy only, never JAX and nothing of ``tpu_sage``. The layout
mirrors the reference module for module (``graph/``, ``data/``, ``sample/``,
``nn/``, ``train/``, ``kernels/``, ``ops.py``) so each counterpart is easy to
find.

Ported so far: supervised training with dense padded or CSR adjacency,
dense or int8 feature storage, and every aggregator (``mean``, ``gcn``, ``max_pool``, ``mean_pool``, ``attention``,
``lstm``) and prep (``identity``, ``linear``, ``node_embedding``) — the paths
``fit()`` runs — with the fused first layer (``nn/fused``); unsupervised
training over random walks with its logistic probe
(``train/unsupervised``); the serving path: checkpoints in the JAX package's ``.npz`` layout (``train/checkpoint``),
exact full-graph inference (``nn/full_graph``), the exporter (``export``)
and the CLI (``cli``); and node-sharded supervised training over
``torch.distributed`` with its halo exchange, sharded exact inference and a
data-parallel trainer (``dist/``). The hot functions (sampler hop, dense and
CSR, column select, row gather, gather + fanout mean, dense, int8 and
owner-masked, mean + projection) are hand-written CUDA kernels for
``sm_90a`` (``kernels/csrc``), built with ``nvcc`` on first use;
on CPU tensors each wrapper runs its plain PyTorch version instead.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu`` for the CLI and the exporter).

The reference's public names (``tpu_sage/__init__.py``) are importable from
here too; each is imported on first use, so ``python -m tpu_sage_torch.cli
--help`` loads no more than it needs.
"""

import importlib

__version__ = "0.1.0"

_PUBLIC = {
    "DeviceGraph": "tpu_sage_torch.graph.graph_data",
    "GraphStore": "tpu_sage_torch.graph.graph_data",
    "build_padded_adjacency": "tpu_sage_torch.graph.graph_data",
    "NodeProblem": "tpu_sage_torch.data.problem",
    "UniformNeighborSampler": "tpu_sage_torch.sample.sampler",
    "uniform_neighbor_sample": "tpu_sage_torch.sample.sampler",
    "sample_tree": "tpu_sage_torch.sample.sampler",
    "prep_lookup": "tpu_sage_torch.nn.preps",
    "aggregator_lookup": "tpu_sage_torch.nn.aggregators",
    "GSSupervised": "tpu_sage_torch.nn.model",
    "LayerSpec": "tpu_sage_torch.nn.model",
    "LRSchedule": "tpu_sage_torch.train.lr",
}
__all__ = list(_PUBLIC)


def __getattr__(name):
    if name in _PUBLIC:
        return getattr(importlib.import_module(_PUBLIC[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
