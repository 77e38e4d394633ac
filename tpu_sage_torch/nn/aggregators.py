"""Aggregator modules (counterpart of ``tpu_sage/nn/aggregators.py``).

Every aggregator combines a node's vector with its sampled neighborhood::

    out = activation(concat(W_self · x_self, W_neigh · summarize(x_neigh)))

(``combine="add"`` sums the branches instead). Only ``mean`` is ported; the
others are ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tpu_sage_torch.kernels.mean_project import mean_project
from tpu_sage_torch.nn.dense import Dense

Activation = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _finish_combine(h_self: torch.Tensor, h_neigh: torch.Tensor, combine: str,
                    activation: Activation) -> torch.Tensor:
    """Shared combine tail: concat or add the two projected branches."""
    if combine == "concat":
        out = torch.cat([h_self, h_neigh], dim=-1)
    elif combine == "add":
        out = h_self + h_neigh
    else:
        raise ValueError(f"unknown combine: {combine}")
    return out if activation is None else activation(out)


class MeanAggregator(torch.nn.Module):
    """``concat(W_self·x, W_neigh·mean(neighbors))``, bias-free branches.

    An unreduced neighborhood ``(B, F, D)`` goes through the fused
    ``mean_project`` kernel; a pre-reduced summary (the deepest level's
    ``row_gather_fanout_mean``) goes through ``fc_neigh``.
    """

    def __init__(self, in_dim: int, output_dim: int, activation: Activation = torch.relu,
                 combine: str = "concat", dtype: Optional[torch.dtype] = None):
        super().__init__()
        if combine not in ("concat", "add"):
            raise ValueError(f"unknown combine: {combine}")
        self.combine = combine
        self.activation = activation
        self.fc_self = Dense(in_dim, output_dim, use_bias=False, dtype=dtype)
        self.fc_neigh = Dense(in_dim, output_dim, use_bias=False, dtype=dtype)

    def out_dim(self) -> int:
        width = self.fc_self.kernel.shape[1]
        return 2 * width if self.combine == "concat" else width

    def _finish(self, h_self: torch.Tensor, h_neigh: torch.Tensor) -> torch.Tensor:
        return _finish_combine(h_self, h_neigh, self.combine, self.activation)

    def forward(self, x_self: torch.Tensor, x_neigh: torch.Tensor) -> torch.Tensor:
        dt = self.fc_neigh.compute_dtype(x_neigh)
        h_neigh = mean_project(x_neigh.to(dt).contiguous(), self.fc_neigh.kernel.to(dt))
        return self._finish(self.fc_self(x_self), h_neigh)

    def neigh_summary(self, x_self: torch.Tensor, x_neigh: torch.Tensor) -> torch.Tensor:
        """Per-root neighborhood summary: the fanout mean."""
        del x_self
        return x_neigh.mean(dim=1)

    def combine_from_summary(self, x_self: torch.Tensor, summary: torch.Tensor,
                             fanout: int) -> torch.Tensor:
        """Finish from a pre-computed neighborhood summary; ``fanout`` is only
        needed by reduces that span self too (GCN)."""
        del fanout
        return self._finish(self.fc_self(x_self), self.fc_neigh(summary))


aggregator_lookup = {"mean": MeanAggregator}
