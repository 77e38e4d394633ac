"""Neighbor sampling against CSR adjacency (counterpart of
``tpu_sage/sample/csr.py``).

CSR stores ``nnz`` neighbor ids (``indptr (n + 1,)``, ``indices``) instead of
the padded ``(n, max_degree)`` table. Sampling is the dense sampler's:
uniform with replacement over the true neighbors, degree-0 nodes
self-loop. Every hop draws ``torch.rand((B, k))`` in the dense sampler's
order, so for one generator state (or the same injected uniforms ``u``) the
CSR tree is bitwise the dense tree.

The reference has two hop forms: the element hop (one indices read per
sample) and the window hop (the two ``window``-wide rows of the flat
indices that cover a node's span, then the one-hot select), bit-identical
by construction. On the card a single hop of either form launches one
kernel, ``kernels/sample_hop.py::sample_hop_csr``, and a whole tree of
either form one launch of ``kernels/sample_hop.py::csr_tree`` (every hop,
up to 4); on the CPU both run their plain versions. ``sample_tree_csr``
draws every hop's uniforms first, in the hop-by-hop order, so the tree is
the same. The window pair itself, ``gather_window_pair``, stays a plain
function of row gathers, and ``window_pair_hop`` composes the window hop
from it and ``select_columns`` as the reference does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_sage_torch.kernels.sample_hop import csr_tree, hop_columns, sample_hop_csr
from tpu_sage_torch.kernels.select import select_columns
from tpu_sage_torch.ops import row_gather
from tpu_sage_torch.sample.sampler import _uniforms, sample_tree


def csr_from_padded(adj: np.ndarray, degrees: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: the padded ``(n, max_degree)`` table → ``(indptr, indices)``,
    both int32. Refuses ``nnz`` past the int32 offsets' range."""
    degrees = np.asarray(degrees, dtype=np.int64)
    indptr = np.zeros(len(degrees) + 1, dtype=np.int64)
    np.cumsum(degrees, out=indptr[1:])
    if indptr[-1] >= 2**31:
        # int32 offsets would wrap negative and read the wrong rows
        raise ValueError(
            f"CSR nnz={int(indptr[-1])} exceeds int32 offsets (2^31-1); "
            "shard the graph first (--partitioned partitions before the "
            "per-shard CSR build, so each shard's nnz stays in range)"
        )
    mask = np.arange(adj.shape[1])[None, :] < degrees[:, None]
    indices = np.asarray(adj)[mask].astype(np.int32)
    return indptr.astype(np.int32), indices


def pad_indices_for_window(indices: np.ndarray, window: int) -> np.ndarray:
    """Pad flat CSR indices to a ``window`` row multiple plus two spare rows,
    so every span ``[indptr[i], indptr[i] + window)`` lies inside the 2-D
    ``(m, window)`` view, the last real row's ``q + 1`` included."""
    pad = (-len(indices)) % window + 2 * window
    return np.concatenate([indices, np.zeros(pad, np.int32)])


def uniform_neighbor_sample_csr(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    degrees: torch.Tensor,
    ids: torch.Tensor,
    n_samples: int,
    *,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The element hop: ``out[b, k] = indices[indptr[ids[b]] + col]``, the
    id itself for degree 0. ``u`` optionally gives the ``(B, n_samples)``
    uniforms; without it they are drawn from ``generator``. Returns
    ``(B, n_samples)`` int32."""
    ids = ids.to(torch.int32).contiguous()
    u = _uniforms(ids, n_samples, generator, u)
    return sample_hop_csr(indptr, indices, degrees, ids, u.contiguous())


def gather_window_pair(indptr: torch.Tensor, indices: torch.Tensor, ids: torch.Tensor,
                       window: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(pair (N, 2·window), off (N,), start (N,))`` such that row ``i``'s
    neighbors are ``pair[i, off[i] : off[i] + deg[i]]``: the two consecutive
    rows of the ``(m, window)`` view of ``indices`` (flat and padded by
    ``pad_indices_for_window``, or already 2-D) that cover the node's span.
    Three ``row_gather`` launches on the card."""
    table = indices if indices.dim() == 2 else indices.view(-1, window)
    start = row_gather(indptr, ids)
    q = torch.div(start, window, rounding_mode="floor")
    off = start - q * window
    pair = torch.cat([row_gather(table, q), row_gather(table, q + 1)], dim=1)
    return pair, off, start


def window_pair_hop(indptr: torch.Tensor, indices: torch.Tensor, degrees: torch.Tensor,
                    ids: torch.Tensor, u: torch.Tensor, window: int) -> torch.Tensor:
    """The reference's window hop composed as it is there: the degrees, the
    window pair and the column select at ``off + col`` (``row_gather`` × 4 and
    ``select_columns`` on the card). Bitwise ``sample_hop_csr`` for the same
    uniforms; ``uniform_neighbor_sample_csr_window`` launches that instead."""
    ids = ids.to(torch.int32).contiguous()
    deg = row_gather(degrees, ids)
    pair, off, _ = gather_window_pair(indptr, indices, ids, window)
    cols = hop_columns(u, deg.clamp_min(1))
    nbr = select_columns(pair, (off[:, None] + cols).contiguous())
    return torch.where(deg[:, None] == 0, ids[:, None], nbr)


def uniform_neighbor_sample_csr_window(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    degrees: torch.Tensor,
    ids: torch.Tensor,
    n_samples: int,
    window: int,
    *,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The window hop (``window`` ≥ the graph's true max degree, ``indices``
    padded by ``pad_indices_for_window``): it reads what the element hop
    reads, so on the card it launches the same kernel."""
    if window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    return uniform_neighbor_sample_csr(indptr, indices, degrees, ids, n_samples,
                                       generator=generator, u=u)


def sample_tree_csr(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    degrees: torch.Tensor,
    ids: torch.Tensor,
    fanouts: Sequence[int],
    window: int = 0,
    *,
    generator: Optional[torch.Generator] = None,
    us: Optional[Sequence[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """``sample_tree`` against CSR storage, with the same level shapes and
    the same draws. ``window`` > 0 stands for the window hop, 0 the element
    hop: both read the same neighbors, so both run as one ``csr_tree``
    launch."""
    ids = ids.to(torch.int32).contiguous()
    return [ids] + csr_tree(indptr, indices, degrees, ids,
                            hop_uniforms(ids, fanouts, generator, us))


def hop_uniforms(ids: torch.Tensor, fanouts: Sequence[int],
                 generator: Optional[torch.Generator] = None,
                 us: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
    """Each hop's ``(N_l, f_l)`` uniforms below ``ids``: ``us`` as given, or
    drawn from ``generator`` hop by hop, as the hop-by-hop sampler draws them."""
    out, n = [], ids.shape[0]
    for hop, fanout in enumerate(fanouts):
        u = us[hop] if us is not None else torch.rand(
            (n, fanout), generator=generator, device=ids.device, dtype=torch.float32)
        out.append(u.contiguous())
        n *= fanout
    return out


def graph_sample_tree(graph, ids: torch.Tensor, fanouts: Sequence[int], *,
                      generator: Optional[torch.Generator] = None,
                      us: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
    """``sample_tree`` on whichever storage ``graph`` has: CSR (it has
    ``indptr``) or the dense padded table."""
    if hasattr(graph, "indptr"):
        return sample_tree_csr(graph.indptr, graph.indices, graph.degrees, ids, fanouts,
                               window=getattr(graph, "window", 0), generator=generator, us=us)
    return sample_tree(graph.adj, graph.degrees, ids, fanouts, generator=generator, us=us)


class CSRNeighborSampler:
    """``UniformNeighborSampler``'s interface over CSR storage."""

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor, degrees: torch.Tensor):
        self.indptr = indptr
        self.indices = indices
        self.degrees = degrees

    @classmethod
    def from_padded(cls, adj, degrees, device: str | torch.device = "cuda") -> "CSRNeighborSampler":
        indptr, indices = csr_from_padded(np.asarray(adj), np.asarray(degrees))
        return cls(*(torch.as_tensor(a, dtype=torch.int32).to(device)
                     for a in (indptr, indices, np.asarray(degrees))))

    def __call__(self, ids: torch.Tensor, n_samples: int, *,
                 generator: Optional[torch.Generator] = None,
                 u: Optional[torch.Tensor] = None) -> torch.Tensor:
        return uniform_neighbor_sample_csr(self.indptr, self.indices, self.degrees, ids,
                                           n_samples, generator=generator, u=u)
