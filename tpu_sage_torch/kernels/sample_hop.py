"""One sampler hop in one kernel: ``out[b, k] = adj[id, col(u[b, k], deg(id))]``.

Counterpart of ``tpu_sage/kernels/select.py::select_columns_pallas`` fused
with the hop's degree and adjacency-row gathers and its column arithmetic
(``tpu_sage/sample/sampler.py::uniform_neighbor_sample``). On a CUDA tensor
the wrapper launches the second entry point of ``csrc/select.cu``,
``tsg_sample_hop``; on a CPU tensor it runs ``sample_hop_reference``, the
composition the hop was before: a ``plain`` gather of the degrees,
``clamp_min(1)``, the column arithmetic, a ``plain`` gather of the rows and
``select_columns_reference``. Both are bitwise equal for the same uniforms.

``sample_hop_csr`` is the same hop against CSR adjacency
(``tpu_sage/sample/csr.py``): ``out[b, k] = indices[indptr[id] + col]``,
``id`` itself where the degree is 0. It is the entry point
``tsg_sample_hop_csr`` of ``csrc/select.cu``, with its plain version
``sample_hop_csr_reference``; single CSR hops launch it
(``uniform_neighbor_sample_csr``, ``CSRNeighborSampler``).

``csr_tree`` runs every hop of a CSR tree (up to 4 a launch) in one launch
of ``tsg_sample_tree_csr``, each counted as a ``csr_tree`` launch: one
thread per leaf walks its ancestry with ``sample_hop_csr``'s arithmetic, so the tree is
bitwise the hop-by-hop tree for the same uniforms. Every CSR tree
(``sample/csr.py::sample_tree_csr``, element and window hops) and CSR walk
(``train/unsupervised.py::graph_random_walk``, fanout 1 a hop, the last level
kept) launches it. Its plain version ``csr_tree_reference`` loops
``sample_hop_csr_reference`` hop by hop. The dense trees keep ``sample_hop``,
one launch a hop.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from tpu_sage_torch.kernels._build import launch, library, require
from tpu_sage_torch.kernels.gather import gather_rows_reference, plain_ids
from tpu_sage_torch.kernels.select import _SIGNATURES, hop_columns, select_columns_reference

TREE_HOPS = 4  # hops a csr_tree launch takes; a deeper tree launches again
MAX_LEAVES = 2**31 - 1  # the kernel's 32-bit leaf index


def sample_hop_reference(adj: torch.Tensor, degrees: torch.Tensor, ids: torch.Tensor,
                         u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``sample_hop``."""
    deg = gather_rows_reference(degrees.view(-1, 1), ids).view(-1).clamp_min(1)
    rows = gather_rows_reference(adj, ids)
    return select_columns_reference(rows, hop_columns(u, deg))


def sample_hop(adj: torch.Tensor, degrees: torch.Tensor, ids: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """``adj (n, D)`` int32, ``degrees (n,)`` int32, ``ids (B,)`` int32 and
    ``u (B, K)`` f32 uniforms in ``[0, 1)`` → ``(B, K)`` int32 neighbor ids.

    Degree 0 picks column 0 (the self pad); an id outside ``[0, n)`` reads
    as the ``plain`` gather does (a negative id wraps once by ``n``, then
    clamps)."""
    if adj.shape[0] != degrees.shape[0]:
        raise ValueError(f"adj has {adj.shape[0]} rows, degrees {degrees.shape[0]}")
    if u.dim() != 2 or u.shape[0] != ids.shape[0]:
        raise ValueError(f"u must be (B, K) with B = {ids.shape[0]}, got {tuple(u.shape)}")
    if adj.device.type == "cpu":
        return sample_hop_reference(adj, degrees, ids, u)
    if adj.device.type != "cuda":
        raise ValueError(f"sample_hop runs on cuda or cpu, got {adj.device}")
    require(adj, "adj", device=adj.device, dtypes=(torch.int32,), ndim=2)
    require(degrees, "degrees", device=adj.device, dtypes=(torch.int32,), ndim=1)
    require(ids, "ids", device=adj.device, dtypes=(torch.int32,), ndim=1)
    require(u, "u", device=adj.device, dtypes=(torch.float32,), ndim=2)
    n, d = adj.shape
    b, k = u.shape
    out = torch.empty((b, k), dtype=torch.int32, device=adj.device)
    if out.numel() == 0:
        return out
    if n == 0:
        raise ValueError("cannot sample from an empty graph")
    lib = library("select", _SIGNATURES)
    launch(lib.tsg_sample_hop, adj.data_ptr(), degrees.data_ptr(), ids.data_ptr(), u.data_ptr(),
           out.data_ptr(), n, d, b, k, device=adj.device, kernel="sample_hop")
    return out


def sample_hop_csr_reference(indptr: torch.Tensor, indices: torch.Tensor, degrees: torch.Tensor,
                             ids: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``sample_hop_csr``: the reference's element
    hop (``tpu_sage/sample/csr.py::uniform_neighbor_sample_csr``) with
    ``plain`` gathers."""
    node = plain_ids(ids, degrees.shape[0]).long()
    deg = degrees[node]
    pos = indptr[node].long()[:, None] + hop_columns(u, deg.clamp_min(1))
    nbr = indices[plain_ids(pos, indices.shape[0])]
    return torch.where(deg[:, None] == 0, ids[:, None], nbr)


def sample_hop_csr(indptr: torch.Tensor, indices: torch.Tensor, degrees: torch.Tensor,
                   ids: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``indptr (n + 1,)``, ``indices (m,)`` (``m >= nnz``: any window
    padding included), ``degrees (n,)``, ``ids (B,)``, all int32, and
    ``u (B, K)`` f32 uniforms in ``[0, 1)`` → ``(B, K)`` int32 neighbor ids.

    Degree 0 gives the id itself, and reads nothing of ``indices``; an id
    outside ``[0, n)`` reads its degree and row start as the ``plain`` gather
    does."""
    n = degrees.shape[0]
    if indptr.shape[0] != n + 1:
        raise ValueError(f"indptr has {indptr.shape[0]} entries, expected {n + 1}")
    if u.dim() != 2 or u.shape[0] != ids.shape[0]:
        raise ValueError(f"u must be (B, K) with B = {ids.shape[0]}, got {tuple(u.shape)}")
    if degrees.device.type == "cpu":
        return sample_hop_csr_reference(indptr, indices, degrees, ids, u)
    if degrees.device.type != "cuda":
        raise ValueError(f"sample_hop_csr runs on cuda or cpu, got {degrees.device}")
    for t, name, ndim in ((indptr, "indptr", 1), (indices, "indices", 1), (degrees, "degrees", 1),
                          (ids, "ids", 1)):
        require(t, name, device=degrees.device, dtypes=(torch.int32,), ndim=ndim)
    require(u, "u", device=degrees.device, dtypes=(torch.float32,), ndim=2)
    b, k = u.shape
    out = torch.empty((b, k), dtype=torch.int32, device=degrees.device)
    if out.numel() == 0:
        return out
    if n == 0 or indices.shape[0] == 0:
        raise ValueError("cannot sample from an empty graph")
    lib = library("select", _SIGNATURES)
    launch(lib.tsg_sample_hop_csr, indptr.data_ptr(), indices.data_ptr(), degrees.data_ptr(),
           ids.data_ptr(), u.data_ptr(), out.data_ptr(), n, indices.shape[0], b, k,
           device=degrees.device, kernel="sample_hop_csr")
    return out


def csr_tree_reference(indptr: torch.Tensor, indices: torch.Tensor, degrees: torch.Tensor,
                       ids: torch.Tensor, us: Sequence[torch.Tensor],
                       last_only: bool = False) -> List[torch.Tensor]:
    """Plain PyTorch version of ``csr_tree``: ``sample_hop_csr_reference``
    hop by hop."""
    levels, cur = [], ids
    for u in us:
        cur = sample_hop_csr_reference(indptr, indices, degrees, cur, u).reshape(-1)
        levels.append(cur)
    return levels[-1:] if last_only else levels


def csr_tree(indptr: torch.Tensor, indices: torch.Tensor, degrees: torch.Tensor,
             ids: torch.Tensor, us: Sequence[torch.Tensor],
             last_only: bool = False) -> List[torch.Tensor]:
    """The levels below ``ids (B,)`` of a CSR tree whose hop ``l`` draws
    ``us[l] (N_l, f_l)`` f32 (``N_0 = B``, ``N_{l+1} = N_l·f_l``), each
    ``(N_{l+1},)`` int32, as ``sample_hop_csr`` hop by hop would return them
    (the CSR arrays as there). ``last_only`` returns, and writes, only the
    deepest level (a walk). Refuses more than 2^31 - 1 leaves."""
    n = degrees.shape[0]
    if indptr.shape[0] != n + 1:
        raise ValueError(f"indptr has {indptr.shape[0]} entries, expected {n + 1}")
    sizes = [ids.shape[0]]
    for hop, u in enumerate(us):
        if u.dim() != 2 or u.shape[0] != sizes[-1]:
            raise ValueError(f"us[{hop}] must be ({sizes[-1]}, fanout), got {tuple(u.shape)}")
        sizes.append(sizes[-1] * u.shape[1])
    if max(sizes) > MAX_LEAVES:
        raise ValueError(f"a tree of {max(sizes)} leaves exceeds the kernel's 2^31 - 1")
    if degrees.device.type == "cpu":
        return csr_tree_reference(indptr, indices, degrees, ids, us, last_only)
    if degrees.device.type != "cuda":
        raise ValueError(f"csr_tree runs on cuda or cpu, got {degrees.device}")
    for t, name in ((indptr, "indptr"), (indices, "indices"), (degrees, "degrees"),
                    (ids, "ids")):
        require(t, name, device=degrees.device, dtypes=(torch.int32,), ndim=1)
    for u in us:
        require(u, "us", device=degrees.device, dtypes=(torch.float32,), ndim=2)
    hops = len(us)
    # the hops above the first empty level (a fanout of 0) have leaves to run
    live = next((h for h in range(hops) if sizes[h + 1] == 0), hops)
    if last_only and live < hops:
        live = 0
    # a level is written if it is kept, or is where the next launch starts
    kept = [h >= live or not last_only or h == hops - 1 or (h + 1) % TREE_HOPS == 0
            for h in range(hops)]
    levels = [torch.empty(sizes[h + 1], dtype=torch.int32, device=degrees.device)
              if kept[h] else None for h in range(hops)]
    if live > 0:
        if n == 0 or indices.shape[0] == 0:
            raise ValueError("cannot sample from an empty graph")
        lib = library("select", _SIGNATURES)
        for h0 in range(0, live, TREE_HOPS):
            part = range(h0, min(h0 + TREE_HOPS, live))
            u_ptrs = (ctypes.c_void_p * TREE_HOPS)(*(us[h].data_ptr() for h in part))
            out_ptrs = (ctypes.c_void_p * TREE_HOPS)(
                *(0 if levels[h] is None else levels[h].data_ptr() for h in part))
            fanouts = (ctypes.c_int * TREE_HOPS)(*(us[h].shape[1] for h in part))
            roots = ids if h0 == 0 else levels[h0 - 1]
            launch(lib.tsg_sample_tree_csr, indptr.data_ptr(), indices.data_ptr(),
                   degrees.data_ptr(), roots.data_ptr(), u_ptrs, out_ptrs, fanouts, len(part),
                   n, indices.shape[0], sizes[part[-1] + 1], device=degrees.device,
                   kernel="csr_tree")
    return levels[-1:] if last_only else levels
