"""``Dense`` and ``Embed``: flax's ``linen.Dense`` and ``linen.Embed`` layouts,
casts and initialisers.

The kernel is stored ``(in, out)`` in f32, as flax stores it, so parameter
trees carry over key for key (``nn/params.py``). With ``dtype`` set, every
call casts the input, the kernel and the bias to ``dtype`` and returns
``dtype`` — flax's ``Dense(dtype=bf16)`` with f32 params. With ``dtype=None``
the input and params promote to a common type.

Initialisers draw from an explicit CPU ``torch.Generator``, so a seed gives
the same parameters on every device: ``lecun_normal_`` (flax's Dense
default), ``orthogonal_`` (the LSTM's recurrent kernel) and the embedding
table's normal of std ``1/sqrt(features)`` (flax's ``default_embed_init``).
Biases start at zero.

Under tensor parallelism (``dist/data_parallel.py``) a ``Dense`` holds only
its rank's columns of the kernel and a ``tp`` object that makes the product
column-parallel: the input enters through ``tp.enter`` (its gradient
all-reduced over the model group) and the output columns leave through
``tp.gather`` (all-gathered; the gradient sliced back).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# flax's lecun_normal: variance_scaling(1.0, "fan_in", "truncated_normal"),
# a normal truncated to ±2 std, rescaled by the std of that truncation
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(kernel: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill an ``(in, out)`` kernel in place with variance ``1 / in``."""
    std = math.sqrt(1.0 / kernel.shape[0]) / _TRUNC_STD
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(kernel, 0.0, std, -2.0 * std, 2.0 * std,
                                           generator=generator)


def orthogonal_(kernel: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill a 2-D kernel in place with an orthogonal matrix, as
    ``jax.nn.initializers.orthogonal()``: orthonormal rows when it is wide,
    orthonormal columns when it is tall (the QR of a normal matrix, signs
    fixed by ``R``'s diagonal)."""
    rows, cols = kernel.shape
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    with torch.no_grad():
        return kernel.copy_(q.T if rows < cols else q)


class Dense(torch.nn.Module):
    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.tp = None  # the column-parallel hooks when the kernel is split
        self.kernel = torch.nn.Parameter(torch.empty(in_features, out_features))
        self.bias = torch.nn.Parameter(torch.zeros(out_features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw the kernel from a CPU ``generator`` (the same values on every
        device) and zero the bias."""
        with torch.no_grad():
            self.kernel.copy_(lecun_normal_(torch.empty(self.kernel.shape), generator))
            if self.bias is not None:
                self.bias.zero_()

    def compute_dtype(self, x: torch.Tensor) -> torch.dtype:
        return self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)

    def columns(self, fn, x: torch.Tensor) -> torch.Tensor:
        """``fn(x, kernel)`` with the kernel in the compute dtype: all the
        output columns, gathered from the model group's under tensor
        parallelism."""
        w = self.kernel.to(self.compute_dtype(x))
        if self.tp is None:
            return fn(x, w)
        return self.tp.gather(fn(self.tp.enter(x), w))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype(x)
        y = self.columns(lambda a, w: a.to(dt) @ w, x)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class Embed(torch.nn.Module):
    """An ``(num_embeddings, features)`` f32 table indexed by ids, flax's
    ``linen.Embed`` with no compute dtype. The lookup is a plain index, whose
    gradient is dense: every row's optimizer state moves on every step, as
    optax's does."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = torch.nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """A normal of std ``1/sqrt(features)`` (flax's ``default_embed_init``:
        variance scaling 1.0, fan-in over the feature axis, untruncated)."""
        std = 1.0 / math.sqrt(self.embedding.shape[1])
        with torch.no_grad():
            self.embedding.copy_(torch.randn(self.embedding.shape, generator=generator) * std)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids.long()]
