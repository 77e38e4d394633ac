"""Gather + fanout mean in one pass: ``out[r] = mean_j table[ids[r·F + j]]``.

Counterpart of ``tpu_sage/kernels/gather_mean.py::gather_fanout_mean``: f32
means of bf16 or f32 rows, without materializing the ``(R·F, d)`` gathered
block. On a CUDA tensor the wrapper launches ``csrc/gather_mean.cu``; on a CPU
tensor it runs ``gather_fanout_mean_reference``, which sums the fanout axis
in the kernel's order (j = 0, 1, ...) and divides by ``F``. Out-of-range ids
take the ``plain`` form (``gather.plain_ids``).
"""

from __future__ import annotations

import ctypes

import torch

from tpu_sage_torch.kernels._build import launch, library, require
from tpu_sage_torch.kernels.gather import plain_ids

LAUNCHES = 0  # kernel launches since the last reset (kernels.reset_launch_counts)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    "tsg_gather_fanout_mean": (_P, _P, _P, _LL, _LL, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, _P),
}


def word_elements(table: torch.Tensor) -> int:
    """Elements per word the kernel reads a row in: the widest (bf16: 8, 4,
    2, 1; f32: 2, 1) that divides the row width and the table's address in
    bytes. A 602-wide bf16 row moves as 301 bf16x2 words."""
    d, size = table.shape[1], table.element_size()
    for v in ((8, 4, 2) if size == 2 else (2,)):
        if d % v == 0 and table.data_ptr() % (v * size) == 0:
            return v
    return 1


def fanout_sum_mean(x: torch.Tensor) -> torch.Tensor:
    """f32 mean over axis 1 of ``(R, F, d)``, summed in order j = 0, 1, ...,
    then divided by F. The divisor is a tensor: PyTorch turns a division by a
    Python scalar into a product with its reciprocal on the card, which is
    not always the correctly rounded quotient the kernels compute."""
    acc = x[:, 0].float()
    for j in range(1, x.shape[1]):
        acc = acc + x[:, j].float()
    return acc / torch.full_like(acc, x.shape[1])


def gather_fanout_mean_reference(table: torch.Tensor, ids: torch.Tensor,
                                 fanout: int) -> torch.Tensor:
    """Plain PyTorch version of ``gather_fanout_mean``."""
    rows = table[plain_ids(ids, table.shape[0]).long()]
    return fanout_sum_mean(rows.view(-1, fanout, table.shape[1]))


def gather_fanout_mean(table: torch.Tensor, ids: torch.Tensor, fanout: int) -> torch.Tensor:
    """``table (n, d)`` bf16/f32, ``ids (R·fanout,)`` int32 → ``(R, d)`` f32."""
    global LAUNCHES
    if fanout < 1 or ids.shape[0] % fanout:
        raise ValueError(f"ids length {ids.shape[0]} is not a multiple of fanout {fanout}")
    if table.device.type == "cpu":
        return gather_fanout_mean_reference(table, ids, fanout)
    if table.device.type != "cuda":
        raise ValueError(f"gather_fanout_mean runs on cuda or cpu, got {table.device}")
    require(table, "table", device=table.device, dtypes=(torch.bfloat16, torch.float32), ndim=2)
    require(ids, "ids", device=table.device, dtypes=(torch.int32,), ndim=1)
    n, d = table.shape
    r = ids.shape[0] // fanout
    out = torch.empty((r, d), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    if n == 0:
        raise ValueError("cannot gather from an empty table")
    lib = library("gather_mean", _SIGNATURES)
    launch(lib.tsg_gather_fanout_mean, table.data_ptr(), ids.data_ptr(), out.data_ptr(), n, r,
           d, fanout, int(table.dtype == torch.bfloat16), word_elements(table),
           device=table.device)
    LAUNCHES += 1
    return out
