"""Sampler column select: ``out[b, k] = rows[b, cols[b, k]]``, and the
column pick of a hop whose rows are already fetched, fused with its
arithmetic.

Counterpart of ``tpu_sage/kernels/select.py::select_columns_pallas`` and of
the XLA one-hot form ``tpu_sage/sample/sampler.py::select_columns``. On a CUDA
tensor each wrapper launches its entry point of ``csrc/select.cu``; on a CPU
tensor it runs its plain version. Exact: a column outside ``[0, D)`` gives 0,
as the one-hot sum does.

- ``select_columns`` (``tsg_select_columns``, counter ``LAUNCHES``): fixed
  columns (``dist/halo.py::CSRAdjRows.rows``) and the reference's window-pair
  composition (``sample/csr.py::window_pair_hop``).
- ``select_hop`` (``tsg_select_hop``, counter ``HOP_LAUNCHES``): the column
  arithmetic, the pick and the degree-0 self-loop in one launch, for the
  partitioned hop (``dist/train.py::sample_level_distributed``, dense rows
  and the CSR pair view), the CSR pick at the owner
  (``dist/halo.py::dist_sample_csr_owner_select``) and the packed sampler
  (``sample/sampler.py::sample_tree_packed``). Its plain version
  ``select_hop_reference`` is the composition those sites ran before.

The main path's hops go through ``sample_hop``, which fuses the pick with
its gathers too.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpu_sage_torch.kernels._build import launch, library, require

LAUNCHES = 0  # kernel launches since the last reset (kernels.reset_launch_counts)
HOP_LAUNCHES = 0  # the same, of select_hop

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {  # every entry point of csrc/select.cu (sample_hop uses the last three)
    "tsg_select_columns": (_P, _P, _P, _LL, _I, _LL, _I, _P),
    "tsg_select_hop": (_P, _P, _P, _P, _P, _P, _LL, _I, _LL, _LL, _LL, _I, _P),
    "tsg_sample_hop": (_P, _P, _P, _P, _P, _LL, _I, _LL, _I, _P),
    "tsg_sample_hop_csr": (_P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _P),
    "tsg_sample_tree_csr": (_P, _P, _P, _P, _P, _P, _P, _I, _LL, _LL, _LL, _P),
}


def hop_columns(u: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """``min(trunc(u * deg), deg - 1)`` for ``u (B, K)`` f32 and ``deg (B,)``
    int32 (already at least 1): a column in ``[0, deg)``; the min guards a
    ``u`` within an ulp of 1.0."""
    return torch.minimum((u * deg[:, None].to(torch.float32)).to(torch.int32), deg[:, None] - 1)


def select_columns_reference(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: indexed load, 0 for an out-of-range column."""
    d = rows.shape[-1]
    picked = torch.gather(rows, 1, cols.clamp(0, max(d - 1, 0)).long())
    return torch.where((cols >= 0) & (cols < d), picked, torch.zeros_like(picked))


def select_columns(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``rows (B, D)`` int32, ``cols (B, K)`` int32 → ``(B, K)`` int32.

    ``rows`` may be a view whose rows are spaced wider than ``D`` (a column
    slice of a wider table); its elements within a row must be adjacent."""
    global LAUNCHES
    if rows.device.type == "cpu":
        return select_columns_reference(rows, cols)
    if rows.device.type != "cuda":
        raise ValueError(f"select_columns runs on cuda or cpu, got {rows.device}")
    if rows.dtype != torch.int32 or rows.dim() != 2:
        raise TypeError(f"rows must be (B, D) int32, got {rows.dtype} {tuple(rows.shape)}")
    b, d = rows.shape
    if (d > 1 and rows.stride(1) != 1) or (b > 1 and rows.stride(0) < d):
        raise ValueError(f"rows must have adjacent columns and disjoint rows, got strides "
                         f"{rows.stride()}")
    require(cols, "cols", device=rows.device, dtypes=(torch.int32,), ndim=2)
    if cols.shape[0] != b:
        raise ValueError(f"cols has {cols.shape[0]} rows, rows has {b}")
    k = cols.shape[1]
    out = torch.empty((b, k), dtype=torch.int32, device=rows.device)
    if out.numel() == 0:
        return out
    lib = library("select", _SIGNATURES)
    launch(lib.tsg_select_columns, rows.data_ptr(), cols.data_ptr(), out.data_ptr(), b, d,
           rows.stride(0), k, device=rows.device)
    LAUNCHES += 1
    return out


def select_hop_reference(rows: torch.Tensor, deg: torch.Tensor, u: torch.Tensor,
                         shift: Optional[torch.Tensor] = None,
                         ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of ``select_hop``: the composition the hops ran
    before (``clamp_min``, the column arithmetic, the shift add, the select,
    the degree-0 ``where``)."""
    cols = hop_columns(u, deg.clamp_min(1))
    if shift is not None:
        cols = shift[:, None] + cols
    nbr = select_columns_reference(rows, cols)
    if ids is not None:
        nbr = torch.where(deg[:, None] == 0, ids[:, None], nbr)
    return nbr


def select_hop(rows: torch.Tensor, deg: torch.Tensor, u: torch.Tensor,
               shift: Optional[torch.Tensor] = None,
               ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One hop's column pick on fetched rows: ``rows (B, D)`` int32 (a view
    of row stride at least ``D`` is read in place), ``deg (B,)`` int32 (any
    stride: a column of the same rows, or a tensor of its own), ``u (B, K)``
    f32 uniforms, ``shift (B,)`` int32 added to each column (the CSR pair
    view's offset), ``ids (B,)`` int32 the frontier, which a degree-0 row
    returns (without ``ids`` it picks column 0, the self pad) → ``(B, K)``
    int32."""
    global HOP_LAUNCHES
    b = rows.shape[0]
    if rows.dim() != 2 or u.dim() != 2 or u.shape[0] != b:
        raise ValueError(f"rows must be (B, D) and u (B, K), got {tuple(rows.shape)} and "
                         f"{tuple(u.shape)}")
    for t, name in ((deg, "deg"), (shift, "shift"), (ids, "ids")):
        if t is not None and (t.dim() != 1 or t.shape[0] != b):
            raise ValueError(f"{name} must be ({b},), got {tuple(t.shape)}")
    if rows.device.type == "cpu":
        return select_hop_reference(rows, deg, u, shift, ids)
    if rows.device.type != "cuda":
        raise ValueError(f"select_hop runs on cuda or cpu, got {rows.device}")
    d = rows.shape[1]
    if rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32, got {rows.dtype}")
    if (d > 1 and rows.stride(1) != 1) or (b > 1 and rows.stride(0) < d):
        raise ValueError(f"rows must have adjacent columns and disjoint rows, got strides "
                         f"{rows.stride()}")
    for t, name in ((deg, "deg"), (shift, "shift")):
        if t is not None and (t.device != rows.device or t.dtype != torch.int32):
            raise TypeError(f"{name} must be int32 on {rows.device}, got {t.dtype} on "
                            f"{t.device}")
    if ids is not None:
        require(ids, "ids", device=rows.device, dtypes=(torch.int32,), ndim=1)
    require(u, "u", device=rows.device, dtypes=(torch.float32,), ndim=2)
    k = u.shape[1]
    out = torch.empty((b, k), dtype=torch.int32, device=rows.device)
    if out.numel() == 0:
        return out
    lib = library("select", _SIGNATURES)
    launch(lib.tsg_select_hop, rows.data_ptr(), deg.data_ptr(),
           0 if shift is None else shift.data_ptr(), 0 if ids is None else ids.data_ptr(),
           u.data_ptr(), out.data_ptr(), b, d, rows.stride(0), deg.stride(0),
           0 if shift is None else shift.stride(0), k, device=rows.device)
    HOP_LAUNCHES += 1
    return out
