"""Row gather: ``out[i] = table[ids[i]]``, bitwise.

Counterpart of ``tpu_sage/kernels/gather.py::gather_rows`` (with
``gather_rows_pallas`` and the bf16 entry ``gather_rows_bf16``). One kernel,
``csrc/gather.cu``, serves every element type: it moves bytes, in the form
``gather_plan`` picks from the row's byte width and both base addresses mod
16. On a CPU tensor the wrapper runs ``gather_rows_reference``.

``oob`` picks the reference's out-of-range semantics (``tpu_sage/ops.py``):
``"clamp"`` (the ``plain`` form: a negative id wraps once by ``n`` as Python
indexing does, then clamps to ``[0, n)``) or ``"zero"`` (the ``masked`` form:
zero rows).
"""

from __future__ import annotations

import ctypes

import torch

from tpu_sage_torch.kernels._build import launch, library, require


_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {  # both entry points of csrc/gather.cu (gather_blockspec uses the second)
    "tsg_gather_rows": (_P, _P, _P, _LL, _LL, _LL, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, _P),
    "tsg_gather_rows_blockspec": (_P, _P, _P, _LL, _LL, _LL, ctypes.c_int, _P),
}
_OOB = {"clamp": 0, "zero": 1}


def plain_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """The ids a ``plain`` gather reads: negatives wrap once by ``n``, then
    everything clamps to ``[0, n)``."""
    return torch.where(ids < 0, ids + n, ids).clamp(0, max(n - 1, 0))


def gather_rows_reference(table: torch.Tensor, ids: torch.Tensor,
                          oob: str = "clamp") -> torch.Tensor:
    """Plain PyTorch version of ``gather_rows``."""
    n = table.shape[0]
    rows = table[plain_ids(ids, n).long()]
    if oob == "zero":
        ok = (ids >= 0) & (ids < n)
        rows = torch.where(ok.view(-1, *([1] * (rows.dim() - 1))), rows,
                           torch.zeros((), dtype=rows.dtype))
    return rows


def _word_bytes(row_bytes: int, *ptrs: int) -> int:
    for w in (16, 4, 2):
        if row_bytes % w == 0 and all(p % w == 0 for p in ptrs):
            return w
    return 1


def gather_plan(row_bytes: int, table_mod16: int, out_mod16: int) -> dict:
    """How ``csrc/gather.cu`` moves rows of ``row_bytes`` between a table and
    an output whose base addresses are ``table_mod16`` and ``out_mod16`` mod 16.

    ``"words"`` for rows whose width and bases are 16-byte multiples, up to
    2,048 bytes (one 16-byte word per lane, or up to 4 issued before the
    lane's first store), and for rows of at most 128 bytes or of odd width:
    the widest word of 16, 4, 2 or 1 bytes that divides the row and both
    bases, ``lanes_per_row`` lanes (a power of two) per row, so narrow rows
    share a warp. ``"realign"`` for the other rows wider than 128 bytes whose
    width and bases are multiples of 2: aligned 16-byte loads realigned to
    the destination by shuffles, ``lanes_per_row`` lanes per row (the
    smallest power of two, at least 8, that covers the most 16-byte words a
    row can span; at most 32, so narrower rows share a warp),
    ``words_per_lane`` of them per lane (at most 4; wider rows go in chunks).
    """
    word = _word_bytes(row_bytes, table_mod16, out_mod16)
    if row_bytes > 128 and word in (2, 4) or (word == 16 and row_bytes > 2048):
        span = (16 - min(word, 4) + row_bytes + 15) // 16  # aligned words a row can touch
        lanes = min(32, max(8, 1 << (span - 1).bit_length()))
        return {"form": "realign", "word": 16, "lanes_per_row": lanes,
                "words_per_lane": min(-(-span // lanes), 4)}
    words = row_bytes // word
    return {"form": "words", "word": word,
            "lanes_per_row": min(32, 1 << max(words - 1, 0).bit_length()),
            "words_per_lane": 0}


def gather_rows(table: torch.Tensor, ids: torch.Tensor, oob: str = "clamp") -> torch.Tensor:
    """``table (n, w)`` of any dtype, ``ids (q,)`` int32 → ``(q, w)``."""
    if oob not in _OOB:
        raise ValueError(f"oob must be one of {sorted(_OOB)}, got {oob!r}")
    if table.device.type == "cpu":
        return gather_rows_reference(table, ids, oob)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cuda or cpu, got {table.device}")
    out = torch.empty((ids.shape[0], *table.shape[1:]), dtype=table.dtype, device=table.device)
    return gather_rows_into(table, ids, out, oob)


def gather_rows_into(table: torch.Tensor, ids: torch.Tensor, out: torch.Tensor,
                     oob: str = "clamp") -> torch.Tensor:
    """``gather_rows`` on the card into a given contiguous ``out (q, w)``,
    whose base, like the table's, may lie anywhere past a 16-byte boundary;
    returns ``out``."""
    if oob not in _OOB:
        raise ValueError(f"oob must be one of {sorted(_OOB)}, got {oob!r}")
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows_into runs on cuda, got {table.device}")
    require(table, "table", device=table.device, dtypes=(table.dtype,), ndim=2)
    require(ids, "ids", device=table.device, dtypes=(torch.int32,), ndim=1)
    require(out, "out", device=table.device, dtypes=(table.dtype,), ndim=2)
    n, w = table.shape
    q = ids.shape[0]
    if tuple(out.shape) != (q, w):
        raise ValueError(f"out must be {(q, w)}, got {tuple(out.shape)}")
    if out.numel() == 0:
        return out
    if n == 0:
        raise ValueError("cannot gather from an empty table")
    row_bytes = w * table.element_size()
    plan = gather_plan(row_bytes, table.data_ptr() % 16, out.data_ptr() % 16)
    lib = library("gather", _SIGNATURES)
    launch(lib.tsg_gather_rows, table.data_ptr(), ids.data_ptr(), out.data_ptr(), n, q,
           row_bytes, plan["word"], plan["lanes_per_row"], plan["words_per_lane"], _OOB[oob],
           device=table.device, kernel="gather_rows")
    return out
