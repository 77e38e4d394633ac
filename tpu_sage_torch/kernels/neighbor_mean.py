"""Degree-masked neighbour mean: the exact pass's mean summary (mean, gcn and
mean_pool).

``out[v] = sum_{j < deg(v)} neigh[v, j] / deg(v)`` per feature, and
``self_rows[v]`` where ``deg(v) == 0``. The JAX package leaves this to XLA
(``tpu_sage/nn/full_graph.py``: the padding columns zeroed, then ``sum``
over the neighbours and the division); it has no Pallas kernel. One kernel,
``csrc/neighbor_mean.cu``, reads each node's true rows once and never the
padding columns, which are zero rows in the exact pass. Its arithmetic is
the expression it replaced: the sum in f32, rounded once to the table's
dtype, then divided by the degree in ``degree_dtype`` (the dtype of the
caller's denominator) and rounded to the table's dtype. Only the order of
the sum differs from torch's reduction: the kernel's groups each add every
``groups``-th neighbour in order and then their sums in group order, as
``neighbor_mean_ordered`` does. On a CPU tensor the wrapper runs
``neighbor_mean_reference``, the expression it replaced.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpu_sage_torch.kernels._build import launch, library


_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    "tsg_neighbor_mean": (_P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _I, _I, _I, _I, _I, _I,
                          _P),
}
DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256  # threads a block of csrc/neighbor_mean.cu: one node
LANES = 64  # threads on a row, fewer for a row of fewer words
THREAD_BYTES = 64  # of a row a thread reads a turn: k words
MAX_WORDS = 8  # k at most


def _denominator(degrees: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return degrees.clamp_min(1)[:, None].to(dtype)


def neighbor_mean_reference(neigh: torch.Tensor, degrees: torch.Tensor, self_rows: torch.Tensor,
                            degree_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version of ``neighbor_mean``: torch's sum over every
    column (zero past each degree) in f32, rounded to ``neigh``'s dtype,
    divided by the degree (at least 1) in ``degree_dtype`` (default
    ``neigh``'s dtype), and the node's own row where its degree is 0."""
    denom = _denominator(degrees, degree_dtype or neigh.dtype)
    summary = neigh.sum(dim=1, dtype=torch.float32).to(neigh.dtype) / denom
    return torch.where(degrees[:, None] == 0, self_rows, summary)


def neighbor_mean_ordered(neigh: torch.Tensor, degrees: torch.Tensor, self_rows: torch.Tensor,
                          degree_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``neighbor_mean_reference`` with the sum taken as the kernel takes it
    for these tensors (``groups`` of ``_plan``): group ``g`` an f32 sum from
    zero of the columns ``g, g + groups, ...`` before the degree, in order,
    and the groups' sums added in ``g`` order. On the card it equals the
    kernel bitwise."""
    groups = _plan(neigh, self_rows)["groups"]
    total = None
    for g in range(groups):
        acc = torch.zeros((neigh.shape[0], neigh.shape[2]), dtype=torch.float32,
                          device=neigh.device)
        for j in range(g, neigh.shape[1], groups):
            acc = acc + torch.where((degrees > j)[:, None], neigh[:, j].float(), 0.0)
        total = acc if total is None else total + acc
    summary = total.to(neigh.dtype) / _denominator(degrees, degree_dtype or neigh.dtype)
    return torch.where(degrees[:, None] == 0, self_rows, summary)


def neighbor_mean_plan(row_bytes: int, elem_bytes: int, *offsets: int) -> dict:
    """How ``csrc/neighbor_mean.cu`` cuts a node's rows of ``row_bytes``:
    into words of the widest of 16, 8 and 4 bytes (else the element) that
    the row and every byte offset in ``offsets`` (the base addresses and
    the strides) are multiples of; ``lanes`` threads (``LANES``, or the
    power of two that holds a narrower row's words) read a row, ``k`` words
    each a turn (at most ``THREAD_BYTES`` and ``MAX_WORDS``), and the block's
    ``THREADS // lanes`` ``groups`` split the neighbours."""
    word = next(w for w in (16, 8, 4, elem_bytes)
                if w >= elem_bytes and all(b % w == 0 for b in (row_bytes, *offsets)))
    words = row_bytes // word
    lanes = min(LANES, 1 << max(words - 1, 0).bit_length())
    k = max(1, min(-(-words // lanes), THREAD_BYTES // word, MAX_WORDS))
    return {"word": word, "lanes": lanes, "groups": THREADS // lanes, "k": k}


def _plan(neigh: torch.Tensor, self_rows: torch.Tensor) -> dict:
    """``neighbor_mean_plan`` for these tensors and a fresh output, with the
    byte strides ``strides``."""
    eb = neigh.element_size()
    strides = (neigh.stride(0) * eb, neigh.stride(1) * eb, self_rows.stride(0) * eb)
    plan = neighbor_mean_plan(neigh.shape[2] * eb, eb, *strides, neigh.data_ptr() % 16,
                              self_rows.data_ptr() % 16)
    return {**plan, "strides": strides}


def check_args(neigh: torch.Tensor, degrees: torch.Tensor, self_rows: torch.Tensor,
               degree_dtype: torch.dtype) -> None:
    """Raise on what the kernel does not take: ``neigh (rows, max_degree,
    w)`` f32 or bf16 with contiguous rows and ``max_degree >= 1``,
    ``degrees (rows,)`` int32 contiguous, ``self_rows (rows, w)`` of
    ``neigh``'s dtype with contiguous rows, all on one device, and a
    ``degree_dtype`` f32 or bf16 that keeps the quotient in ``neigh``'s
    dtype."""
    if neigh.dtype not in DTYPES:
        raise TypeError(f"neigh has dtype {neigh.dtype}, expected one of {DTYPES}")
    if neigh.dim() != 3 or neigh.shape[1] < 1:
        raise ValueError(f"neigh must be (rows, max_degree >= 1, w), got {tuple(neigh.shape)}")
    rows, _, w = neigh.shape
    if degrees.dtype != torch.int32:
        raise TypeError(f"degrees has dtype {degrees.dtype}, expected torch.int32")
    if tuple(degrees.shape) != (rows,) or not degrees.is_contiguous():
        raise ValueError(f"degrees must be contiguous ({rows},), got {tuple(degrees.shape)}")
    if self_rows.dtype != neigh.dtype:
        raise TypeError(f"self_rows has dtype {self_rows.dtype}, expected {neigh.dtype}")
    if tuple(self_rows.shape) != (rows, w):
        raise ValueError(f"self_rows must be {(rows, w)}, got {tuple(self_rows.shape)}")
    if neigh.stride(2) != 1 or self_rows.stride(1) != 1:
        raise ValueError("each row of neigh and self_rows must be contiguous")
    if (degree_dtype not in DTYPES
            or torch.promote_types(neigh.dtype, degree_dtype) != neigh.dtype):
        raise TypeError(f"degree_dtype {degree_dtype} would not keep the mean in {neigh.dtype}")
    if not (degrees.device == self_rows.device == neigh.device):
        raise ValueError(f"neigh, degrees and self_rows are on {neigh.device}, "
                         f"{degrees.device} and {self_rows.device}")


def neighbor_mean(neigh: torch.Tensor, degrees: torch.Tensor, self_rows: torch.Tensor,
                  degree_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``neigh (rows, max_degree, w)`` f32 or bf16, zero past each degree
    (rows contiguous, node and neighbour strides free), ``degrees (rows,)``
    int32, ``self_rows (rows, w)``, ``degree_dtype`` the dtype the degree
    divides in (default ``neigh``'s) → ``(rows, w)`` in ``neigh``'s dtype."""
    if neigh.device.type == "cpu":
        return neighbor_mean_reference(neigh, degrees, self_rows, degree_dtype)
    if neigh.device.type != "cuda":
        raise ValueError(f"neighbor_mean runs on cuda or cpu, got {neigh.device}")
    degree_dtype = degree_dtype or neigh.dtype
    check_args(neigh, degrees, self_rows, degree_dtype)
    rows, max_degree, w = neigh.shape
    out = torch.empty((rows, w), dtype=neigh.dtype, device=neigh.device)
    if out.numel() == 0:
        return out
    eb = neigh.element_size()
    plan = _plan(neigh, self_rows)  # out is fresh: 16-byte aligned
    word = plan["word"]
    lib = library("neighbor_mean", _SIGNATURES)
    launch(lib.tsg_neighbor_mean, neigh.data_ptr(), degrees.data_ptr(), self_rows.data_ptr(),
           out.data_ptr(), rows, max_degree, w * eb // word,
           *(s // word for s in plan["strides"]), eb, word, plan["lanes"], plan["groups"],
           plan["k"], int(degree_dtype == torch.bfloat16), device=neigh.device,
           kernel="neighbor_mean")
    return out
