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
  sums (mean, gcn, mean_pool) are the same. Max pool and attention still
  mask those columns with ``finfo.min``, as JAX does.
- The pools' ``relu(mlp(·))`` is applied to the whole ``h`` once per layer
  and the projected rows are gathered, where JAX projects each gathered
  neighbor row; the products are per row, so the values are the same, for
  about ``max_degree`` times less compute. A zero row of the projected table
  stands for a padding column (it is zero, not ``relu(bias)``, and is masked
  like one). Degree-0 nodes take their own projected row.
- Attention's scores ``⟨q, neigh · W_k⟩`` are computed as
  ``⟨q · W_kᵀ, neigh⟩``, the same bilinear form in another order, so the
  keys are never materialised per neighbor.
- The last chunk is ragged. JAX pads the node axis to whole chunks (zero
  adjacency, degree 0) for its static shapes and drops the padded rows.
- Dtypes follow JAX's type promotion. The mean and gcn summaries stay in the
  table's dtype: for a bf16 table the sum has f32 accumulation, is rounded
  once to bf16 and divided in bf16, as XLA does on the CPU. Each projection
  is a raw ``x @ kernel (+ bias)`` with the f32 parameters (``_dense``), so a
  bf16 ``x`` gives an f32 product and everything after layer 0's summary is
  f32. The model's ``Dense`` casts to the compute dtype instead, so it is not
  used here.
- The ``linear`` and ``node_embedding`` preps apply to the whole table first
  (the projection; the table concatenated after the features, which
  promotes a bf16 table to f32).
- An int8 table is dequantized whole first, as JAX does: a
  ``QuantizedFeats`` to its compute dtype; raw int8 feats with
  ``graph.feat_scale`` (the partitioned layout) to the scales' dtype.

``embed_all_nodes_partitioned`` is the same pass over a node-sharded graph
(``dist/partition.py``; ``tpu_sage/nn/full_graph.py:201-310``): the
activations stay sharded, and each layer fetches each chunk's
``chunk·max_degree`` neighbor rows by the exact halo exchange
(``dist/halo.py::dist_gather``; columns past a node's degree ask for id -1,
which no rank owns, and come back as zero rows), then combines them as
above. Every rank walks its ``m`` rows in the same chunks, so the exchanges
line up.

Under ``torch.profiler`` both passes record spans (``tracing.py``): the
pass, the prep, each layer, the pools' projected table, and per chunk the
gather, the neighbour summary and the products.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpu_sage_torch import tracing
from tpu_sage_torch.data.quantize import QuantizedFeats
from tpu_sage_torch.graph.graph_data import DeviceGraph
from tpu_sage_torch.nn.aggregators import GCNAggregator
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
    if isinstance(agg, GCNAggregator):
        out = _dense(summary, agg.fc.kernel, agg.fc.bias)
    else:
        hs = _dense(h_self, agg.fc_self.kernel, agg.fc_self.bias)
        hn = _dense(summary, agg.fc_neigh.kernel, agg.fc_neigh.bias)
        out = torch.cat([hs, hn], dim=-1) if agg.combine == "concat" else hs + hn
    return out if agg.activation is None else agg.activation(out)


def _neighbor_table(model: GSSupervised, layer_idx: int, h: torch.Tensor) -> torch.Tensor:
    """What a layer gathers per neighbor: the pools' ``relu(mlp(h))`` for
    every node, else ``h`` itself."""
    if model.aggregator_class in ("max_pool", "mean_pool"):
        with tracing.span("tsg.exact.table", h.device):
            mlp = model.agg_layers[layer_idx].mlp
            return torch.relu(_dense(h, mlp.kernel, mlp.bias))
    return h


def _chunk_combine(model: GSSupervised, layer_idx: int, neigh: torch.Tensor,
                   d_chunk: torch.Tensor, h_self: torch.Tensor,
                   src_self: torch.Tensor) -> torch.Tensor:
    """One chunk of one layer from its gathered neighbor rows ``neigh
    (chunk, max_degree, w)`` of the layer's neighbor table, zero past each
    node's degree ``d_chunk``; ``src_self`` is the chunk's own rows of that
    table (degree-0 nodes self-loop through them)."""
    agg = model.agg_layers[layer_idx]
    with tracing.span("tsg.exact.reduce", neigh.device):
        summary = _chunk_summary(model, agg, neigh, d_chunk, h_self, src_self)
    with tracing.span("tsg.exact.combine", neigh.device):
        return _combine_with_params(agg, h_self, summary)


def _chunk_summary(model: GSSupervised, agg, neigh: torch.Tensor, d_chunk: torch.Tensor,
                   h_self: torch.Tensor, src_self: torch.Tensor) -> torch.Tensor:
    """The neighbor summary of ``_chunk_combine``, before the products."""
    agg_name = model.aggregator_class
    if agg_name not in EXACT_AGGREGATORS:
        raise ValueError(f"full-graph inference unsupported for {agg_name}")
    mask = torch.arange(neigh.shape[1], device=neigh.device) < d_chunk[:, None]
    isolated = d_chunk[:, None] == 0
    dtype = h_self.dtype
    denom = d_chunk.clamp_min(1)[:, None].to(dtype)
    if agg_name in ("mean", "gcn"):
        summary = neigh.sum(dim=1, dtype=torch.float32).to(dtype) / denom
        summary = torch.where(isolated, h_self, summary)
        if agg_name == "gcn":
            # mean(self ∪ neighbors); isolated nodes keep their own row
            summary = torch.where(isolated, h_self, (summary * denom + h_self) / (denom + 1.0))
    elif agg_name == "max_pool":
        neigh.masked_fill_(~mask[:, :, None], torch.finfo(neigh.dtype).min)
        summary = torch.where(isolated, src_self, neigh.amax(dim=1))
    elif agg_name == "mean_pool":
        summary = torch.where(isolated, src_self, neigh.sum(dim=1) / denom)
    else:  # attention over every true neighbor; padding columns score finfo.min
        q = _dense(h_self, agg.att_q.kernel)                       # (chunk, K)
        qk = q @ agg.att_k.kernel.T                                 # (chunk, d)
        x = neigh.to(torch.promote_types(neigh.dtype, qk.dtype))
        scores = (x @ qk[:, :, None])[..., 0] / math.sqrt(q.shape[-1])
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        alpha = torch.softmax(scores, dim=-1)
        summary = torch.where(isolated, h_self, (alpha[:, None, :] @ x)[:, 0])
    return summary


def _gather_local(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``(rows, max_degree, w)`` rows of ``src`` for ``ids (rows,
    max_degree)``; id -1 gives a zero row."""
    return row_gather(src, ids, form="masked")


def _gather_halo(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``_gather_local`` over a node-sharded ``src``: the exact halo exchange."""
    from tpu_sage_torch.dist.halo import dist_gather

    return dist_gather(src, ids.reshape(-1)).view(ids.shape[0], ids.shape[1], -1)


def _layer_full(model: GSSupervised, layer_idx: int, h: torch.Tensor, graph: DeviceGraph,
                chunk: int, gather=_gather_local) -> torch.Tensor:
    """Aggregation layer ``layer_idx`` applied to every node; ``h (n, d)``;
    each chunk's neighbor rows from ``gather(src, ids)``."""
    n, max_deg = graph.adj.shape
    with tracing.span("tsg.exact.layer", h.device):
        cols = torch.arange(max_deg, dtype=torch.int32, device=h.device)
        src = _neighbor_table(model, layer_idx, h)
        out = None
        for start in range(0, n, chunk):
            adj = graph.adj[start:start + chunk]
            deg = graph.degrees[start:start + chunk]
            with tracing.span("tsg.exact.gather", h.device):
                neigh = gather(src, torch.where(cols < deg[:, None], adj, -1))
            res = _chunk_combine(model, layer_idx, neigh, deg, h[start:start + chunk],
                                 src[start:start + chunk])
            del neigh
            if out is None:
                out = torch.empty((n, res.shape[1]), dtype=res.dtype, device=res.device)
            out[start:start + chunk] = res
    return out


def _prep_table(model: GSSupervised, h: torch.Tensor) -> torch.Tensor:
    """The prep applied to every node's features at once."""
    if model.prep_class == "linear":
        return _dense(h, model.prep.fc.kernel)
    if model.prep_class == "node_embedding":
        table = model.prep.embedding.embedding
        if table.shape[0] != h.shape[0]:
            raise ValueError(
                f"node_embedding is transductive: its table has {table.shape[0]} rows, "
                f"the graph {h.shape[0]} nodes")
        return torch.cat([h, table], dim=-1)
    return h


def _dense_feats(graph: DeviceGraph) -> torch.Tensor:
    """The feature table in a float dtype: an int8 table dequantized (the
    layer-wise products need dense rows)."""
    h = graph.feats
    if isinstance(h, QuantizedFeats):  # not hasattr: torch.Tensor has a dequantize too
        return h.dequantize()
    if graph.feat_scale is not None and not h.is_floating_point():
        return h.to(graph.feat_scale.dtype) * graph.feat_scale
    return h


def embed_all_nodes(model: GSSupervised, graph: DeviceGraph, chunk: int = 4096,
                    with_head: bool = False) -> torch.Tensor:
    """Exact embeddings ``(n, D)`` (or logits with ``with_head``) for all
    nodes of ``graph``, in f32, on the graph's device."""
    _check_exact_supported(model)
    dev = graph.adj.device
    with torch.inference_mode(), tracing.span("tsg.exact.pass", dev):
        with tracing.span("tsg.exact.prep", dev):
            h = _prep_table(model, _dense_feats(graph))
        for layer_idx in range(len(model.layer_specs)):
            h = _layer_full(model, layer_idx, h, graph, chunk)
        if model.normalize:
            h = _l2_normalize(h)
        if with_head:
            h = _dense(h, model.fc.kernel, model.fc.bias)
    return h


def embed_all_nodes_partitioned(model: GSSupervised, graph: DeviceGraph, chunk: int = 2048,
                                with_head: bool = False) -> torch.Tensor:
    """Exact embeddings (or logits) of this rank's ``m`` nodes, ``(m, D)``
    f32, from its shard ``graph`` (``dist/partition.py::shard_graph``,
    ``train=False``), run by every rank of the process group. Rows past the
    store's node count are partition padding."""
    from tpu_sage_torch.dist.mesh import rank, world

    _check_exact_supported(model)
    m = graph.adj.shape[0]
    dev = graph.adj.device
    with torch.inference_mode(), tracing.span("tsg.exact.pass", dev):
        with tracing.span("tsg.exact.prep", dev):
            h = _dense_feats(graph)
            if model.prep_class == "node_embedding":
                table = model.prep.embedding.embedding
                pad = world() * m - table.shape[0]
                if pad > 0:
                    table = torch.cat([table, table.new_zeros((pad, table.shape[1]))])
                h = torch.cat([h, table[rank() * m:(rank() + 1) * m]], dim=-1)
            else:
                h = _prep_table(model, h)
        for layer_idx in range(len(model.layer_specs)):
            h = _layer_full(model, layer_idx, h, graph, chunk, gather=_gather_halo)
        if model.normalize:
            h = _l2_normalize(h)
        if with_head:
            h = _dense(h, model.fc.kernel, model.fc.bias)
    return h
