"""Prep modules: how gathered node features become layer-0 inputs
(counterpart of ``tpu_sage/nn/preps.py``).

Preps take ``(ids, x)`` where ``x`` is that level's already gathered feature
rows. ``identity`` passes them through; ``linear`` projects them through a
bias-free ``fc`` with no compute dtype, so a bf16 ``x`` promotes to f32 as
flax's ``Dense(dtype=None)`` does; ``node_embedding`` appends a learned
per-node row (transductive: the table is keyed by node id), and the
concatenation promotes a bf16 ``x`` to f32 as ``jnp.concatenate`` does.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_sage_torch.nn.dense import Dense, Embed


class IdentityPrep(torch.nn.Module):
    """Pass gathered raw features through unchanged."""

    def __init__(self, feat_dim: int = 0, n_nodes: int = 0, embedding_dim: int = 0):
        super().__init__()
        self.feat_dim = feat_dim

    def out_dim(self) -> int:
        return self.feat_dim

    def forward(self, ids: torch.Tensor, x: Optional[torch.Tensor]) -> torch.Tensor:
        if x is None:
            raise ValueError("IdentityPrep requires node features")
        return x


class LinearPrep(torch.nn.Module):
    """``out = x @ W``: a bias-free projection to ``embedding_dim``."""

    def __init__(self, feat_dim: int, n_nodes: int = 0, embedding_dim: int = 64):
        super().__init__()
        self.fc = Dense(feat_dim, embedding_dim, use_bias=False)

    def out_dim(self) -> int:
        return self.fc.kernel.shape[1]

    def forward(self, ids: torch.Tensor, x: Optional[torch.Tensor]) -> torch.Tensor:
        if x is None:
            raise ValueError("LinearPrep requires node features")
        return self.fc(x)


class NodeEmbeddingPrep(torch.nn.Module):
    """``concat([x, E[ids]])`` with a learned ``(n_nodes, embedding_dim)``
    table ``E``; just ``E[ids]`` without features."""

    def __init__(self, feat_dim: int, n_nodes: int, embedding_dim: int = 64):
        super().__init__()
        self.feat_dim = feat_dim
        self.embedding = Embed(n_nodes, embedding_dim)

    def out_dim(self) -> int:
        return self.feat_dim + self.embedding.embedding.shape[1]

    def forward(self, ids: torch.Tensor, x: Optional[torch.Tensor]) -> torch.Tensor:
        emb = self.embedding(ids)
        return emb if x is None else torch.cat([x, emb], dim=-1)


prep_lookup = {
    "identity": IdentityPrep,
    "linear": LinearPrep,
    "node_embedding": NodeEmbeddingPrep,
}
