"""Exact full-graph layer-wise inference: embeddings (or logits) for every
node, with no sampling (counterpart of the single-device part of
``tpu_sage/nn/full_graph.py``).

Each layer runs over all nodes at once. A node's summary covers all its true
neighbors; degree-0 nodes self-loop, as on the sampled path. The node axis
goes in chunks of ``chunk`` nodes, and each chunk's ``(chunk, max_degree)``
neighbor rows come from one ``ops.row_gather``: on the card, one
``gather_rows`` launch per chunk per layer and no other kernel.

Where the port differs in form from the JAX package, the values agree:

- Columns past a node's degree gather as zero rows (id -1 in the ``masked``
  form). JAX gathers the padding ids and zeroes them with a ``where``, so the
  sums are the same.
- The last chunk is ragged. JAX pads the node axis to whole chunks (zero
  adjacency, degree 0) for its static shapes and drops the padded rows.
- Dtypes follow JAX's type promotion. The summary stays in the table's
  dtype: for a bf16 table it is summed with f32 accumulation, rounded once
  to bf16 and divided in bf16, as XLA does on the CPU. Each projection is a
  raw ``x @ kernel`` with the f32 kernel (``_dense``), so a bf16 ``x`` gives
  an f32 product and everything after layer 0's summary is f32. The model's
  ``Dense`` casts to the compute dtype instead, so it is not used here.

The partitioned variant (``embed_all_nodes_partitioned``) is ROADMAP Queue 1
item 14; the gcn, pool and attention summaries are item 8.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_sage_torch.graph.graph_data import DeviceGraph
from tpu_sage_torch.nn.model import GSSupervised, _l2_normalize
from tpu_sage_torch.ops import row_gather

EXACT_AGGREGATORS = ("mean", "gcn", "max_pool", "mean_pool", "attention")


def _check_exact_supported(model: GSSupervised) -> None:
    if model.aggregator_class not in EXACT_AGGREGATORS:
        raise ValueError(
            f"full-graph inference needs a permutation-invariant aggregator "
            f"over all neighbors; {model.aggregator_class!r} is sample-defined"
        )


def exact_supported(model: GSSupervised) -> bool:
    """True when the model admits exact layer-wise inference: every
    permutation-invariant aggregator; lstm is order-defined."""
    return model.aggregator_class in EXACT_AGGREGATORS


def _dense(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ kernel (+ bias)`` in the promoted dtype of ``x`` and ``kernel``."""
    dt = torch.promote_types(x.dtype, kernel.dtype)
    out = x.to(dt) @ kernel.to(dt)
    if bias is not None:
        out = out + bias.to(dt)
    return out


def _combine_with_params(agg, h_self: torch.Tensor, summary: torch.Tensor) -> torch.Tensor:
    hs = _dense(h_self, agg.fc_self.kernel)
    hn = _dense(summary, agg.fc_neigh.kernel)
    out = torch.cat([hs, hn], dim=-1) if agg.combine == "concat" else hs + hn
    return out if agg.activation is None else agg.activation(out)


def _chunk_combine(model: GSSupervised, layer_idx: int, neigh: torch.Tensor,
                   d_chunk: torch.Tensor, h_self: torch.Tensor) -> torch.Tensor:
    """One chunk of one layer from its gathered neighbor rows ``neigh
    (chunk, max_degree, d)``, zero past each node's degree ``d_chunk``."""
    agg_name = model.aggregator_class
    if agg_name == "mean":
        dtype = h_self.dtype
        denom = d_chunk.clamp_min(1)[:, None].to(dtype)
        summary = neigh.sum(dim=1, dtype=torch.float32).to(dtype) / denom
        summary = torch.where(d_chunk[:, None] == 0, h_self, summary)
        return _combine_with_params(model.agg_layers[layer_idx], h_self, summary)
    if agg_name in EXACT_AGGREGATORS:
        raise NotImplementedError(
            f"exact inference for {agg_name!r} is not ported yet (ROADMAP Queue 1 item 8)")
    raise ValueError(f"full-graph inference unsupported for {agg_name}")


def _layer_full(model: GSSupervised, layer_idx: int, h: torch.Tensor, graph: DeviceGraph,
                chunk: int) -> torch.Tensor:
    """Aggregation layer ``layer_idx`` applied to every node; ``h (n, d)``."""
    n, max_deg = graph.adj.shape
    cols = torch.arange(max_deg, dtype=torch.int32, device=h.device)
    out = None
    for start in range(0, n, chunk):
        adj = graph.adj[start:start + chunk]
        deg = graph.degrees[start:start + chunk]
        neigh = row_gather(h, torch.where(cols < deg[:, None], adj, -1), form="masked")
        res = _chunk_combine(model, layer_idx, neigh, deg, h[start:start + chunk])
        del neigh
        if out is None:
            out = torch.empty((n, res.shape[1]), dtype=res.dtype, device=res.device)
        out[start:start + chunk] = res
    return out


def embed_all_nodes(model: GSSupervised, graph: DeviceGraph, chunk: int = 4096,
                    with_head: bool = False) -> torch.Tensor:
    """Exact embeddings ``(n, D)`` (or logits with ``with_head``) for all
    nodes of ``graph``, in f32, on the graph's device. The model's prep is
    the identity (the only one ported)."""
    _check_exact_supported(model)
    with torch.inference_mode():
        h = graph.feats
        for layer_idx in range(len(model.layer_specs)):
            h = _layer_full(model, layer_idx, h, graph, chunk)
        if model.normalize:
            h = _l2_normalize(h)
        if with_head:
            h = _dense(h, model.fc.kernel, model.fc.bias)
    return h
