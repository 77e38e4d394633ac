"""Row gather, one row per block: ``out[i] = table[ids[i]]``, bitwise.

Counterpart of ``tpu_sage/kernels/gather.py::gather_rows_blockspec``, the
naive index-map gather (one row per grid step) that the JAX package keeps as
a measurement foil for ``gather_rows``; nothing on the main path calls it.
On a CUDA tensor the wrapper launches the second entry point of
``csrc/gather.cu`` (one block per output row, dtype-generic through the word
width, as ``gather_rows``); on a CPU tensor it runs
``gather_rows_blockspec_reference``.

In-range ids are the contract; the kernel and the plain version both clamp
as ``gather_rows``'s ``"clamp"`` form does, so no id reads outside the table.
"""

from __future__ import annotations

import torch

from tpu_sage_torch.kernels._build import launch, library, require
from tpu_sage_torch.kernels.gather import _SIGNATURES, _word_bytes, gather_rows_reference



def gather_rows_blockspec_reference(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``gather_rows_blockspec``."""
    return gather_rows_reference(table, ids, "clamp")


def gather_rows_blockspec(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table (n, w)`` of any dtype, ``ids (q,)`` int32 → ``(q, w)``."""
    if table.device.type == "cpu":
        return gather_rows_blockspec_reference(table, ids)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows_blockspec runs on cuda or cpu, got {table.device}")
    require(table, "table", device=table.device, dtypes=(table.dtype,), ndim=2)
    require(ids, "ids", device=table.device, dtypes=(torch.int32,), ndim=1)
    n, w = table.shape
    q = ids.shape[0]
    out = torch.empty((q, w), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    if n == 0:
        raise ValueError("cannot gather from an empty table")
    row_bytes = w * table.element_size()
    word = _word_bytes(row_bytes, table.data_ptr(), out.data_ptr())
    lib = library("gather", _SIGNATURES)
    launch(lib.tsg_gather_rows_blockspec, table.data_ptr(), ids.data_ptr(), out.data_ptr(), n,
           q, row_bytes, word, device=table.device, kernel="gather_rows_blockspec")
    return out
