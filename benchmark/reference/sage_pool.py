"""Plain PyTorch reference of GraphSAGE-pool's exact embeddings (Hamilton et
al. 2017, arXiv:1706.02216, section 3.3, the pooling aggregator), float32,
TF32 off, importing nothing of the program under test.

Layer ``k`` (``concat`` combine, ReLU on every layer but the last)::

    p_u   = relu(h_u^{k-1} @ W_pool^k + b_pool^k)
    h_v^k = act(concat(h_v^{k-1} @ W_self^k + b_self^k,
                       max_{u in N(v)} p_u @ W_neigh^k + b_neigh^k))

over all of ``v``'s neighbours, then every embedding is L2-normalised. A
node of degree 0 takes its own ``p_v`` as its neighbourhood's. Parameter
names are the program's (``agg_layers.{i}.mlp.kernel`` is ``W_pool``).
``precision="tf32"`` rounds every product's inputs to TF32, as
``sage_mean`` does: the control.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.sage_mean import _mm, init_params as _init_kernels, normalize

BIAS_STD = 0.1  # the pool's bias, drawn so that its path is compared


def param_shapes(feat_dim: int, model: dict, n_classes: int) -> Dict[str, tuple]:
    """Every parameter of the configuration's ``model``, by name, with its shape."""
    hidden = int(model["agg_hidden_dim"])
    shapes, d_in = {}, feat_dim
    for i, d_out in enumerate(model["output_dims"]):
        shapes[f"agg_layers.{i}.mlp.kernel"] = (d_in, hidden)
        shapes[f"agg_layers.{i}.mlp.bias"] = (hidden,)
        shapes[f"agg_layers.{i}.fc_self.kernel"] = (d_in, d_out)
        shapes[f"agg_layers.{i}.fc_self.bias"] = (d_out,)
        shapes[f"agg_layers.{i}.fc_neigh.kernel"] = (hidden, d_out)
        shapes[f"agg_layers.{i}.fc_neigh.bias"] = (d_out,)
        d_in = 2 * d_out
    shapes["fc.kernel"] = (d_in, n_classes)
    shapes["fc.bias"] = (n_classes,)
    return shapes


def init_params(shapes: Dict[str, tuple], generator: torch.Generator,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """``sage_mean``'s kernels and zero biases, then the pools' biases
    normal with standard deviation ``BIAS_STD``, in one further draw."""
    params = _init_kernels(shapes, generator, device)
    pools = [k for k in shapes if k.endswith(".mlp.bias")]
    flat = torch.randn(sum(shapes[k][0] for k in pools), generator=generator, device=device)
    at = 0
    for k in pools:
        params[k] = flat[at:at + shapes[k][0]] * BIAS_STD
        at += shapes[k][0]
    return params


def exact_embeddings(params: Dict[str, torch.Tensor], feats: torch.Tensor, adj: torch.Tensor,
                     degrees: torch.Tensor, n_layers: int, chunk: int = 4096,
                     precision: str = "float32") -> torch.Tensor:
    """Embeddings of every node over all its neighbours (``adj[v, :deg(v)]``),
    in blocks of ``chunk`` nodes."""
    n, width = adj.shape
    cols = torch.arange(width, device=adj.device)
    h = feats.float()
    for i in range(n_layers):
        w = {k[len(f"agg_layers.{i}."):]: v for k, v in params.items()
             if k.startswith(f"agg_layers.{i}.")}
        pooled = torch.relu(_mm(h, w["mlp.kernel"], precision) + w["mlp.bias"])
        out = torch.empty((n, 2 * w["fc_self.kernel"].shape[1]), dtype=torch.float32,
                          device=h.device)
        for s in range(0, n, chunk):
            a = adj[s:s + chunk].long()
            deg = degrees[s:s + chunk].long()
            past = cols[None, :] >= deg[:, None]
            neigh = pooled[a].masked_fill(past[:, :, None], float("-inf")).amax(dim=1)
            neigh = torch.where(deg[:, None] == 0, pooled[s:s + chunk], neigh)
            o = torch.cat([_mm(h[s:s + chunk], w["fc_self.kernel"], precision) + w["fc_self.bias"],
                           _mm(neigh, w["fc_neigh.kernel"], precision) + w["fc_neigh.bias"]],
                          dim=-1)
            out[s:s + chunk] = torch.relu(o) if i < n_layers - 1 else o
        h = out
    return normalize(h)
