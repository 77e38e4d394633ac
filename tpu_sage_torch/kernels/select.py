"""Sampler column select: ``out[b, k] = rows[b, cols[b, k]]``.

Counterpart of ``tpu_sage/kernels/select.py::select_columns_pallas`` and of
the XLA one-hot form ``tpu_sage/sample/sampler.py::select_columns``. On a CUDA
tensor the wrapper launches ``csrc/select.cu``; on a CPU tensor it runs
``select_columns_reference``. Exact: a column outside ``[0, D)`` gives 0, as
the one-hot sum does. The main path's hops go through ``sample_hop``, which
fuses the select with its gathers; the packed sampler
(``sample/sampler.py::sample_tree_packed``) launches this kernel.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_sage_torch.kernels._build import launch, library, require

LAUNCHES = 0  # kernel launches since the last reset (kernels.reset_launch_counts)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {  # every entry point of csrc/select.cu (sample_hop uses the last two)
    "tsg_select_columns": (_P, _P, _P, _LL, ctypes.c_int, _LL, ctypes.c_int, _P),
    "tsg_sample_hop": (_P, _P, _P, _P, _P, _LL, ctypes.c_int, _LL, ctypes.c_int, _P),
    "tsg_sample_hop_csr": (_P, _P, _P, _P, _P, _P, _LL, _LL, _LL, ctypes.c_int, _P),
}


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
