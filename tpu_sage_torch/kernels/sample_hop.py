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
``id`` itself where the degree is 0. It is the third entry point of
``csrc/select.cu``, ``tsg_sample_hop_csr``, with its own counter
``CSR_LAUNCHES`` and its plain version ``sample_hop_csr_reference``.
"""

from __future__ import annotations

import torch

from tpu_sage_torch.kernels._build import launch, library, require
from tpu_sage_torch.kernels.gather import gather_rows_reference, plain_ids
from tpu_sage_torch.kernels.select import _SIGNATURES, select_columns_reference

LAUNCHES = 0  # kernel launches since the last reset (kernels.reset_launch_counts)
CSR_LAUNCHES = 0  # the same, of the CSR hop


def hop_columns(u: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """``min(trunc(u * deg), deg - 1)`` for ``u (B, K)`` f32 and ``deg (B,)``
    int32 (already at least 1): a column in ``[0, deg)``; the min guards a
    ``u`` within an ulp of 1.0."""
    return torch.minimum((u * deg[:, None].to(torch.float32)).to(torch.int32), deg[:, None] - 1)


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
    global LAUNCHES
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
           out.data_ptr(), n, d, b, k, device=adj.device)
    LAUNCHES += 1
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
    global CSR_LAUNCHES
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
           device=degrees.device)
    CSR_LAUNCHES += 1
    return out
