"""Aggregator modules (counterpart of ``tpu_sage/nn/aggregators.py``).

Every aggregator combines a node's vector with its sampled neighborhood::

    out = activation(concat(W_self · x_self, W_neigh · summarize(x_neigh)))

(``combine="add"`` sums the branches instead); ``gcn`` has one branch,
``W · mean(self ∪ neighbors)``, and keeps ``output_dim``. Each splits into
``neigh_summary`` (per root, so the deepest level can be summarised right
after its gather) and ``combine_from_summary``.

``mean`` goes through the fused ``mean_project`` kernel. The other
aggregators' products are ``torch.matmul`` through ``Dense``, as the JAX
package leaves them to XLA; the LSTM's recurrence is a Python loop of
products and elementwise ops with flax's cast points (not ``torch.nn.LSTM``,
whose two biases and casts differ).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from tpu_sage_torch.kernels.mean_project import mean_project
from tpu_sage_torch.nn.dense import Dense, orthogonal_

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


class _TwoBranch(torch.nn.Module):
    """The shared skeleton: ``fc_self`` on the root, ``fc_neigh`` on the
    summary, then the combine. Subclasses build ``fc_neigh``'s input width
    and ``neigh_summary``."""

    use_bias = True

    def __init__(self, in_dim: int, output_dim: int, summary_dim: int,
                 activation: Activation, combine: str, dtype: Optional[torch.dtype]):
        super().__init__()
        if combine not in ("concat", "add"):
            raise ValueError(f"unknown combine: {combine}")
        self.combine = combine
        self.activation = activation
        self.fc_self = Dense(in_dim, output_dim, use_bias=self.use_bias, dtype=dtype)
        self.fc_neigh = Dense(summary_dim, output_dim, use_bias=self.use_bias, dtype=dtype)

    def out_dim(self) -> int:
        width = self.fc_self.kernel.shape[1]
        return 2 * width if self.combine == "concat" else width

    def _finish(self, h_self: torch.Tensor, h_neigh: torch.Tensor) -> torch.Tensor:
        return _finish_combine(h_self, h_neigh, self.combine, self.activation)

    def forward(self, x_self: torch.Tensor, x_neigh: torch.Tensor) -> torch.Tensor:
        return self.combine_from_summary(x_self, self.neigh_summary(x_self, x_neigh),
                                         x_neigh.shape[1])

    def neigh_summary(self, x_self: torch.Tensor, x_neigh: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def combine_from_summary(self, x_self: torch.Tensor, summary: torch.Tensor,
                             fanout: int) -> torch.Tensor:
        """Finish from a pre-computed neighborhood summary; ``fanout`` is only
        needed by reduces that span self too (GCN)."""
        del fanout
        return self._finish(self.fc_self(x_self), self.fc_neigh(summary))


class MeanAggregator(_TwoBranch):
    """``concat(W_self·x, W_neigh·mean(neighbors))``, bias-free branches.

    An unreduced neighborhood ``(B, F, D)`` goes through the fused
    ``mean_project`` kernel; a pre-reduced summary (the deepest level's
    ``row_gather_fanout_mean``) goes through ``fc_neigh``. Rows wider than
    the compute dtype (the f32 output of the linear or node-embedding prep
    under bf16) are averaged in f32 and the mean rounded after, inside the
    kernel, as the JAX package's ``fc_neigh(jnp.mean(x_neigh))`` does.
    """

    use_bias = False

    def __init__(self, in_dim: int, output_dim: int, activation: Activation = torch.relu,
                 combine: str = "concat", hidden_dim: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_dim, output_dim, in_dim, activation, combine, dtype)

    def forward(self, x_self: torch.Tensor, x_neigh: torch.Tensor) -> torch.Tensor:
        h_neigh = self.fc_neigh.columns(lambda x, w: mean_project(x.contiguous(), w), x_neigh)
        return self._finish(self.fc_self(x_self), h_neigh)

    def neigh_summary(self, x_self: torch.Tensor, x_neigh: torch.Tensor) -> torch.Tensor:
        """Per-root neighborhood summary: the fanout mean."""
        del x_self
        return x_neigh.mean(dim=1)

    def combine_projected(self, h_self: torch.Tensor, h_neigh: torch.Tensor) -> torch.Tensor:
        """Finish from pre-projected self rows and the mean of pre-projected
        neighbor rows (projection ∘ mean == mean ∘ projection; the fused
        first layer, ``nn/fused.py``, hands over the mean already taken)."""
        return self._finish(h_self, h_neigh)


class PoolAggregator(_TwoBranch):
    """Per-neighbor ``relu(mlp(x))`` of width ``hidden_dim``, then an
    elementwise max or mean over the fanout axis; biased ``mlp``, ``fc_self``
    and ``fc_neigh``. ``MaxPoolAggregator`` / ``MeanPoolAggregator`` fix
    ``pool``."""

    pool = "max"

    def __init__(self, in_dim: int, output_dim: int, activation: Activation = torch.relu,
                 combine: str = "concat", hidden_dim: int = 512,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_dim, output_dim, hidden_dim, activation, combine, dtype)
        self.mlp = Dense(in_dim, hidden_dim, dtype=dtype)

    def neigh_summary(self, x_self: torch.Tensor, x_neigh: torch.Tensor) -> torch.Tensor:
        del x_self
        h = torch.relu(self.mlp(x_neigh))  # (B, F, H)
        if self.pool == "max":
            return h.amax(dim=1)
        if self.pool == "mean":
            return h.mean(dim=1)
        raise ValueError(f"unknown pool: {self.pool}")


class MaxPoolAggregator(PoolAggregator):
    pool = "max"


class MeanPoolAggregator(PoolAggregator):
    pool = "mean"


class _OrthogonalDense(Dense):
    """A biased ``Dense`` whose kernel starts orthogonal (the LSTM's ``hz``)."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.kernel.copy_(orthogonal_(torch.empty(self.kernel.shape), generator))
            self.bias.zero_()


class _LSTMCell(torch.nn.Module):
    """The recurrent half: one fused ``(H, 4H)`` projection ``hz``, biased,
    orthogonal init."""

    def __init__(self, hidden_dim: int, dtype: Optional[torch.dtype]):
        super().__init__()
        self.hz = _OrthogonalDense(hidden_dim, 4 * hidden_dim, use_bias=True, dtype=dtype)


class _HoistedLSTM(torch.nn.Module):
    """LSTM over the fanout axis, returning the final hidden state. The input
    projections of all four gates are one bias-free ``(B·F, D)×(D, 4H)``
    product over the whole sequence (``xz``); the loop carries only the
    recurrent half. Gate order i, f, g, o; ``h0 = c0 = 0`` in the sequence's
    dtype, and every op promotes as the JAX package's scan does."""

    def __init__(self, in_dim: int, hidden_dim: int, dtype: Optional[torch.dtype]):
        super().__init__()
        self.xz = Dense(in_dim, 4 * hidden_dim, use_bias=False, dtype=dtype)
        self.cell = _LSTMCell(hidden_dim, dtype)

    def forward(self, seq: torch.Tensor) -> torch.Tensor:
        xz = self.xz(seq)  # (B, F, 4H)
        hidden = self.cell.hz.kernel.shape[0]
        h = c = torch.zeros((seq.shape[0], hidden), dtype=seq.dtype, device=seq.device)
        for t in range(seq.shape[1]):
            z = xz[:, t] + self.cell.hz(h)
            i, f, g, o = torch.split(z, hidden, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        return h


class LSTMAggregator(_TwoBranch):
    """LSTM over the sampled-neighbor sequence (already in random order);
    its final hidden state is the summary. Biased ``fc_self``/``fc_neigh``."""

    def __init__(self, in_dim: int, output_dim: int, activation: Activation = torch.relu,
                 combine: str = "concat", hidden_dim: int = 512,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_dim, output_dim, hidden_dim, activation, combine, dtype)
        self.lstm = _HoistedLSTM(in_dim, hidden_dim, dtype)

    def neigh_summary(self, x_self: torch.Tensor, x_neigh: torch.Tensor) -> torch.Tensor:
        del x_self
        return self.lstm(x_neigh)


class AttentionAggregator(_TwoBranch):
    """``α = softmax(⟨q(x_self), k(neighbors)⟩ / sqrt(hidden_dim))`` over the
    fanout axis; summary ``Σ α·x_neigh``. Bias-free ``att_q``, ``att_k``,
    ``fc_self`` and ``fc_neigh``; the key width is the model's
    ``agg_hidden_dim``."""

    use_bias = False

    def __init__(self, in_dim: int, output_dim: int, activation: Activation = torch.relu,
                 combine: str = "concat", hidden_dim: int = 32,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_dim, output_dim, in_dim, activation, combine, dtype)
        self.att_q = Dense(in_dim, hidden_dim, use_bias=False, dtype=dtype)
        self.att_k = Dense(in_dim, hidden_dim, use_bias=False, dtype=dtype)

    def neigh_summary(self, x_self: torch.Tensor, x_neigh: torch.Tensor) -> torch.Tensor:
        # the softmax spans only each root's own fanout group, so the summary
        # stays root-aligned
        q = self.att_q(x_self)                                      # (B, K)
        k = self.att_k(x_neigh)                                     # (B, F, K)
        scores = (k @ q[:, :, None])[..., 0] / math.sqrt(q.shape[-1])
        alpha = torch.softmax(scores, dim=-1)                       # (B, F)
        return (alpha[:, None, :] @ x_neigh.to(alpha.dtype))[:, 0]  # (B, D)


class GCNAggregator(torch.nn.Module):
    """``W · mean(self ∪ neighbors)`` through one biased ``fc``; the output
    keeps ``output_dim`` and ``combine`` is ignored."""

    def __init__(self, in_dim: int, output_dim: int, activation: Activation = torch.relu,
                 combine: str = "concat", hidden_dim: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.combine = combine
        self.activation = activation
        self.fc = Dense(in_dim, output_dim, use_bias=True, dtype=dtype)

    def out_dim(self) -> int:
        return self.fc.kernel.shape[1]

    def forward(self, x_self: torch.Tensor, x_neigh: torch.Tensor) -> torch.Tensor:
        return self.combine_from_summary(x_self, self.neigh_summary(x_self, x_neigh),
                                         x_neigh.shape[1])

    def neigh_summary(self, x_self: torch.Tensor, x_neigh: torch.Tensor) -> torch.Tensor:
        del x_self
        return x_neigh.mean(dim=1)

    def combine_from_summary(self, x_self: torch.Tensor, summary: torch.Tensor,
                             fanout: int) -> torch.Tensor:
        """The neighbor mean re-enters with weight ``fanout``:
        ``mean(self ∪ N) = (x_self + fanout·mean(N)) / (fanout + 1)``."""
        out = self.fc((x_self + fanout * summary) / (fanout + 1))
        return out if self.activation is None else self.activation(out)


aggregator_lookup = {
    "mean": MeanAggregator,
    "max_pool": MaxPoolAggregator,
    "mean_pool": MeanPoolAggregator,
    "lstm": LSTMAggregator,
    "attention": AttentionAggregator,
    "gcn": GCNAggregator,
}
