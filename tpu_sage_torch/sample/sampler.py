"""Fixed-fanout uniform neighbor sampling on the device (counterpart of
``tpu_sage/sample/sampler.py``).

Sampling is with replacement from the true neighbors (columns
``[0, max(degree, 1))``); padding slots are never selected and degree-0
nodes self-loop. Randomness comes from an explicit ``torch.Generator`` on the
ids' device. ``torch.Generator`` and ``jax.random`` give different numbers
from one seed, so the sampling functions also take the uniforms ``u``
directly: fed the reference's uniforms, they pick the reference's columns bit
for bit.

A hop of ``sample_tree`` is one ``sample_hop`` kernel (gathers, column
arithmetic and select fused). ``sample_tree_packed`` is the reference's
packed alternative: one row gather of ``adjacency ‖ degree`` per hop, then
the column pick with its arithmetic (one ``select_hop`` kernel); it draws
the same tree for the same uniforms.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from tpu_sage_torch.kernels.sample_hop import sample_hop
from tpu_sage_torch.kernels.select import select_hop
from tpu_sage_torch.ops import row_gather


def _uniforms(ids: torch.Tensor, n_samples: int, generator: Optional[torch.Generator],
              u: Optional[torch.Tensor]) -> torch.Tensor:
    if u is not None:
        return u
    return torch.rand((ids.shape[0], n_samples), generator=generator, device=ids.device,
                      dtype=torch.float32)


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
    ids = ids.to(torch.int32).contiguous()
    u = _uniforms(ids, n_samples, generator, u)
    return sample_hop(adj, degrees, ids, u.contiguous())


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


def pack_adjacency(adj: torch.Tensor, degrees: torch.Tensor) -> torch.Tensor:
    """``(n, max_degree + 1)`` int32: the adjacency row ‖ the degree."""
    return torch.cat([adj, degrees[:, None].to(adj.dtype)], dim=1)


def sample_tree_packed(
    adj_deg: torch.Tensor,
    ids: torch.Tensor,
    fanouts: Sequence[int],
    *,
    generator: Optional[torch.Generator] = None,
    us: Optional[Sequence[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """``sample_tree`` against a ``pack_adjacency`` table: one row gather per
    hop, then the column pick (``select_hop``) on the adjacency part of the
    rows and their degree column (views, no copy).

    Draws the same tree as ``sample_tree`` for the same ``us``, or for the
    same ``generator`` state (the same uniforms in the same order)."""
    levels = [ids.to(torch.int32)]
    for hop, fanout in enumerate(fanouts):
        cur = levels[-1].contiguous()
        rows = row_gather(adj_deg, cur)  # one gather: adj ‖ deg
        u = _uniforms(cur, fanout, generator, None if us is None else us[hop])
        levels.append(select_hop(rows[:, :-1], rows[:, -1], u.contiguous()).reshape(-1))
    return levels


def gather_levels(feats: torch.Tensor, levels: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Feature rows of every tree level in one ``row_gather`` of the
    concatenated levels, split back into levels."""
    rows = row_gather(feats, torch.cat([lvl.reshape(-1) for lvl in levels]))
    return list(torch.split(rows, [lvl.numel() for lvl in levels]))


class UniformNeighborSampler:
    """The reference's sampler object: binds the adjacency once; each call
    draws from ``generator`` (or takes the uniforms ``u``)."""

    def __init__(self, adj: torch.Tensor, degrees: torch.Tensor):
        self.adj = adj
        self.degrees = degrees

    def __call__(self, ids: torch.Tensor, n_samples: int, *,
                 generator: Optional[torch.Generator] = None,
                 u: Optional[torch.Tensor] = None) -> torch.Tensor:
        return uniform_neighbor_sample(self.adj, self.degrees, ids, n_samples,
                                       generator=generator, u=u)
