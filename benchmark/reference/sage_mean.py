"""Plain PyTorch reference of GraphSAGE-mean (Hamilton et al. 2017, arXiv:1706.02216).

Written from the paper's equations, with TF32 off, and imports nothing of
the program under test. The benchmark hands it the same inputs it hands
the program: the feature table and adjacency it made from the seed, the
initial weights it drew, the batches it fed. The sampled trees are the
program's outputs: the harness judges them first (every id a neighbour of
its parent) and then gives them to this reference, as a served model's
tokens are given to its reference.

Layer ``k`` (``concat`` combine, ReLU on every layer but the last)::

    h_v^k = act(concat(h_v^{k-1} @ W_self^k, mean_{u in N(v)} h_u^{k-1} @ W_neigh^k))

then every embedding is L2-normalised, ``z = h * rsqrt(sum(h^2) + 1e-24)``.
The supervised loss is softmax cross-entropy of ``z @ W_fc + b_fc``.
Adam is written out (b1 0.9, b2 0.999, eps 1e-8, bias-corrected), in float32.

``dtype`` is the configuration's compute dtype, with the meaning flax's
``Dense(dtype=...)`` gives it over float32 parameters: every product takes
its input and its kernel (and bias) in ``dtype`` and returns ``dtype``
(float32 accumulation inside the product); a neighbour mean accumulates in
float32 and returns ``dtype``; the activations and the normalisation stay
in ``dtype``; the cross-entropy takes its logits in
float32. With ``dtype=torch.float32`` it is the plain float32 model.

Parameter names are the flax layout the repo's checkpoints use
(``agg_layers_{i}/fc_self/kernel``), written with dots.

``precision="tf32"`` (the exact pass) rounds every product's inputs to TF32
(10 mantissa bits, round to nearest even) and keeps float32 accumulation:
the control of a float32 configuration.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def param_shapes(feat_dim: int, model: dict, n_classes: int) -> Dict[str, tuple]:
    """Every parameter of the configuration's ``model``, by name, with its shape."""
    shapes, d_in = {}, feat_dim
    for i, d_out in enumerate(model["output_dims"]):
        shapes[f"agg_layers.{i}.fc_self.kernel"] = (d_in, d_out)
        shapes[f"agg_layers.{i}.fc_neigh.kernel"] = (d_in, d_out)
        d_in = 2 * d_out
    shapes["fc.kernel"] = (d_in, n_classes)
    shapes["fc.bias"] = (n_classes,)
    return shapes


def init_params(shapes: Dict[str, tuple], generator: torch.Generator,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Kernels normal with variance ``1 / fan_in``, biases zero: one draw
    from ``generator`` for all kernels, split in the order of ``shapes``."""
    kernels = [(k, s) for k, s in shapes.items() if len(s) == 2]
    flat = torch.randn(sum(s[0] * s[1] for _, s in kernels), generator=generator,
                       device=device, dtype=torch.float32)
    params, at = {}, 0
    for k, s in kernels:
        n = s[0] * s[1]
        params[k] = flat[at:at + n].view(s) * (1.0 / s[0]) ** 0.5
        at += n
    for k, s in shapes.items():
        if len(s) == 1:
            params[k] = torch.zeros(s, device=device, dtype=torch.float32)
    return params


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return round_tf32(a) @ round_tf32(b)
    return a @ b


def _layers(params: Dict[str, torch.Tensor], n_layers: int) -> List[tuple]:
    return [(params[f"agg_layers.{i}.fc_self.kernel"], params[f"agg_layers.{i}.fc_neigh.kernel"])
            for i in range(n_layers)]


def _dense(x: torch.Tensor, kernel: torch.Tensor, dtype: torch.dtype,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x.to(dtype) @ kernel.to(dtype)
    return y if bias is None else y + bias.to(dtype)


def _mean(rows: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``(n, fanout, d)`` rows → ``(n, d)`` means, accumulated in float32."""
    return rows.float().mean(dim=1).to(dtype)


def normalize(z: torch.Tensor) -> torch.Tensor:
    return z * torch.rsqrt((z * z).sum(-1, keepdim=True) + 1e-24)


def encode_tree(params: Dict[str, torch.Tensor], feats: torch.Tensor,
                levels: Sequence[torch.Tensor], n_layers: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Embeddings ``(len(levels[0]), 2 * d_out)`` of a sampled tree:
    ``levels[l]`` holds level ``l``'s ids, each node's children contiguous."""
    h = [feats[lv.long()].to(dtype) for lv in levels]
    for i, (w_self, w_neigh) in enumerate(_layers(params, n_layers)):
        nxt = []
        for d in range(len(h) - 1):
            n = h[d].shape[0]
            neigh = _mean(h[d + 1].view(n, -1, h[d + 1].shape[-1]), dtype)
            out = torch.cat([_dense(h[d], w_self, dtype), _dense(neigh, w_neigh, dtype)], dim=-1)
            nxt.append(torch.relu(out) if i < n_layers - 1 else out)
        h = nxt
    return normalize(h[0])


def supervised_loss(params, feats, levels, targets, n_layers: int,
                    dtype: torch.dtype = torch.float32):
    z = encode_tree(params, feats, levels, n_layers, dtype)
    logits = _dense(z, params["fc.kernel"], dtype, params["fc.bias"])
    return F.cross_entropy(logits.float(), targets.long())


def train_steps(params: Dict[str, torch.Tensor], loss_fns: Sequence, lr: float):
    """Adam steps from ``params``, one a loss function of the parameters.
    Returns ``(losses, first gradients, parameters after the last step)``."""
    p = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grads = [], None
    for t, loss_fn in enumerate(loss_fns, start=1):
        leaves = {k: x.requires_grad_(True) for k, x in p.items()}
        loss = loss_fn(leaves)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
        g = {k: torch.zeros_like(p[k]) if gr is None else gr for k, gr in zip(names, grads)}
        if first_grads is None:
            first_grads = {k: x.detach().clone() for k, x in g.items()}
        with torch.no_grad():
            for k in names:
                m[k] = BETA1 * m[k] + (1 - BETA1) * g[k]
                v2[k] = BETA2 * v2[k] + (1 - BETA2) * g[k] * g[k]
                m_hat = m[k] / (1 - BETA1 ** t)
                v_hat = v2[k] / (1 - BETA2 ** t)
                p[k] = p[k].detach() - lr * m_hat / (v_hat.sqrt() + EPS)
        losses.append(float(loss.detach()))
    return losses, first_grads, {k: x.detach() for k, x in p.items()}


def exact_embeddings(params: Dict[str, torch.Tensor], feats: torch.Tensor, adj: torch.Tensor,
                     degrees: torch.Tensor, n_layers: int, chunk: int = 4096,
                     precision: str = "float32") -> torch.Tensor:
    """Embeddings of every node over all its neighbours (``adj[v, :deg(v)]``;
    a node of degree 0 takes its own row as its neighbourhood), in blocks of
    ``chunk`` nodes."""
    n, width = adj.shape
    cols = torch.arange(width, device=adj.device)
    h = feats.float()
    for i, (w_self, w_neigh) in enumerate(_layers(params, n_layers)):
        out = torch.empty((n, 2 * w_self.shape[1]), dtype=torch.float32, device=h.device)
        for s in range(0, n, chunk):
            a = adj[s:s + chunk].long()
            deg = degrees[s:s + chunk].long()
            own = torch.arange(s, s + a.shape[0], device=adj.device)
            a = torch.where(deg[:, None] == 0, own[:, None], a)
            mask = (cols[None, :] < deg.clamp_min(1)[:, None]).float()
            neigh = (h[a] * mask[:, :, None]).sum(1) / mask.sum(1, keepdim=True)
            o = torch.cat([_mm(h[s:s + chunk], w_self, precision),
                           _mm(neigh, w_neigh, precision)], dim=-1)
            out[s:s + chunk] = torch.relu(o) if i < n_layers - 1 else o
        h = out
    return normalize(h)
