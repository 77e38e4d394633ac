"""tpu_sage_torch — the PyTorch + CUDA port of tpu_sage for NVIDIA Hopper.

A package of its own beside the JAX reference ``tpu_sage``: it imports
``torch`` and numpy only, never JAX and nothing of ``tpu_sage``. The layout
mirrors the reference module for module (``graph/``, ``data/``, ``sample/``,
``nn/``, ``train/``, ``kernels/``, ``ops.py``) so each counterpart is easy to
find.

Ported so far: supervised training with dense padded adjacency and every
aggregator (``mean``, ``gcn``, ``max_pool``, ``mean_pool``, ``attention``,
``lstm``) and prep (``identity``, ``linear``, ``node_embedding``) — the paths
``fit()`` runs — and the serving path: checkpoints in the JAX package's ``.npz`` layout (``train/checkpoint``),
exact full-graph inference (``nn/full_graph``), the exporter (``export``)
and the CLI (``cli``). The hot functions (sampler hop, column select, row
gather, gather + fanout mean, mean + projection) are hand-written CUDA
kernels for ``sm_90a`` (``kernels/csrc``), built with ``nvcc`` on first use;
on CPU tensors each wrapper runs its plain PyTorch version instead.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu`` for the CLI and the exporter).
"""

__version__ = "0.1.0"
