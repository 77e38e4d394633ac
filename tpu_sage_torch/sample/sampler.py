"""Fixed-fanout uniform neighbor sampling on the device (counterpart of
``tpu_sage/sample/sampler.py``).

Sampling is with replacement from the true neighbors (columns
``[0, max(degree, 1))``); padding slots are never selected and degree-0
nodes self-loop. Randomness comes from an explicit ``torch.Generator`` on the
ids' device. ``torch.Generator`` and ``jax.random`` give different numbers
from one seed, so the sampling functions also take the uniforms ``u``
directly: fed the reference's uniforms, they pick the reference's columns bit
for bit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from tpu_sage_torch.kernels.select import select_columns
from tpu_sage_torch.ops import row_gather


def uniform_neighbor_sample(
    adj: torch.Tensor,
    degrees: torch.Tensor,
    ids: torch.Tensor,
    n_samples: int,
    *,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample ``n_samples`` neighbors per node, with replacement.

    ``adj (n_nodes, max_degree)`` int32, ``degrees (n_nodes,)`` int32,
    ``ids (B,)``. ``u`` is an optional ``(B, n_samples)`` f32 tensor of
    uniforms in ``[0, 1)``; without it they are drawn from ``generator``.
    Returns ``(B, n_samples)`` int32 neighbor ids.
    """
    ids = ids.to(torch.int32)
    deg = row_gather(degrees, ids).clamp_min(1)  # degree-0 -> col 0 == self pad
    if u is None:
        u = torch.rand((ids.shape[0], n_samples), generator=generator,
                       device=ids.device, dtype=torch.float32)
    # trunc(u * deg) in [0, deg); the min guards u within an ulp of 1.0
    cols = torch.minimum((u * deg[:, None].to(torch.float32)).to(torch.int32),
                         deg[:, None] - 1)
    rows = row_gather(adj, ids)  # (B, max_degree)
    return select_columns(rows, cols.contiguous())


def sample_tree(
    adj: torch.Tensor,
    degrees: torch.Tensor,
    ids: torch.Tensor,
    fanouts: Sequence[int],
    *,
    generator: Optional[torch.Generator] = None,
    us: Optional[Sequence[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """Build the static-shape neighborhood tree.

    Level 0 is ``ids`` with shape ``(B,)``; level ``l`` has shape
    ``(B * prod(fanouts[:l]),)``. ``us`` optionally gives each hop's
    uniforms. Keeping sampling outside the network is the seam the parity
    tests use: they can inject precomputed levels instead.
    """
    levels = [ids.to(torch.int32)]
    for hop, fanout in enumerate(fanouts):
        nbr = uniform_neighbor_sample(
            adj, degrees, levels[-1], fanout, generator=generator,
            u=None if us is None else us[hop],
        )
        levels.append(nbr.reshape(-1))
    return levels
