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

Where a table is larger than L2 and each row is asked for several times, as
in the exact pass's chunks, the card walks the ids in id order:
``gather_order_plan`` decides from the call's shapes and the card's L2 size,
``gather_order`` (a counting sort on the card, ``tsg_gather_order``) lists
the positions bucket by bucket of ids, and the gather kernel writes each
row to its position, so the repeats of a row are served from L2. The output
is bitwise the one gathered in output order. Under ``torch.profiler`` each
gather on the card adds ``rows`` and ``ordered_rows`` to the innermost open
span (``tracing.count``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from tpu_sage_torch import tracing
from tpu_sage_torch.kernels._build import launch, library, require


_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int
_SIGNATURES = {  # the entry points of csrc/gather.cu (gather_blockspec uses the second)
    "tsg_gather_rows": (_P, _P, _P, _P, _LL, _LL, _LL, _INT, _INT, _INT, _INT, _P),
    "tsg_gather_rows_blockspec": (_P, _P, _P, _LL, _LL, _LL, _INT, _P),
    "tsg_gather_order": (_P, _LL, _LL, _INT, _INT, _P, _P, _P, _P, _P),
}
_OOB = {"clamp": 0, "zero": 1}

ORDER_MAX_BUCKETS = 512  # csrc/gather.cu kOrderMaxBuckets: the out-of-range bucket included
ORDER_TILE = 2048  # csrc/gather.cu kOrderTile: positions a block of the ordering takes
# The plan's costs, from the gather's L2-cold times on the H100 at the exact
# pass's chunks (PERF.md section 6, row 2x): in output order the gather moves
# every id's row (read and written) at ORDER_RATES[0] bytes/s; in id order
# each distinct row read once and every row written at ORDER_RATES[1], plus
# ORDER_SEAM_S for each pair of neighbouring output rows that share a 32-byte
# sector (written in two halves far apart, the sector goes back to HBM as a
# read, merge and write), plus the ordering's ORDER_COST_S seconds (fixed,
# and per id)
ORDER_RATES = (2.9e12, 2.7e12)
ORDER_SEAM_S = 2.5e-10
ORDER_COST_S = (2.0e-5, 3.0e-11)


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


def order_buckets(n_table: int, shift: int) -> int:
    """Buckets of the ordering over a table of ``n_table`` rows: ``id >>
    shift`` for the ids in range, and one more for every other id."""
    return ((n_table - 1) >> shift) + 2


def gather_order_plan(n_table: int, q: int, row_bytes: int, l2_bytes: int) -> dict:
    """Whether ``gather_rows`` of ``q`` ids from a table of ``n_table`` rows
    of ``row_bytes`` walks its ids in id order on a card with ``l2_bytes`` of
    L2, and the bucket ``shift`` of the ordering.

    ``shift`` is the least that keeps the buckets within
    ``ORDER_MAX_BUCKETS``. With ``q`` ids drawn uniformly, a chunk names
    ``n (1 - e^(-q/n))`` distinct rows, each asked for ``repeats`` times on
    average. The gather orders only where all hold:

    - rows of at least 32 bytes (a narrower one shares its sectors with
      more than two neighbours);
    - the table exceeds half of L2 (a smaller one already serves repeats
      from L2);
    - a bucket's stretch of the walk (its distinct rows read, its rows
      written) fits in a quarter of L2, so a row stays there from its
      first request to its last;
    - the costs (``ORDER_RATES``, ``ORDER_SEAM_S``, ``ORDER_COST_S``) put
      the ordering and the gather in id order below the gather in output
      order.
    """
    if n_table < 1:
        raise ValueError(f"the table has no rows: {n_table}")
    shift = 0
    while order_buckets(n_table, shift) > ORDER_MAX_BUCKETS:
        shift += 1
    load = q / n_table
    distinct = -n_table * math.expm1(-load)
    repeats = q / distinct if distinct > 0 else 1.0
    stretch = (1 << shift) * row_bytes * (distinct / n_table + load)
    # output rows whose start lies inside a 32-byte sector: all but one in
    # 32 / gcd(row_bytes, 32)
    seams = q * (1.0 - math.gcd(row_bytes, 32) / 32)
    in_output_order = 2 * q * row_bytes / ORDER_RATES[0]
    in_id_order = ((distinct + q) * row_bytes / ORDER_RATES[1] + seams * ORDER_SEAM_S
                   + ORDER_COST_S[0] + ORDER_COST_S[1] * q)
    ordered = (row_bytes >= 32 and n_table * row_bytes > l2_bytes / 2
               and stretch <= l2_bytes / 4 and in_id_order < in_output_order)
    return {"ordered": bool(ordered), "shift": shift,
            "buckets": order_buckets(n_table, shift), "repeats": repeats}


def order_keys(ids: torch.Tensor, n_table: int, shift: int) -> torch.Tensor:
    """Each id's bucket: ``id >> shift`` in ``[0, n_table)``, else the last."""
    ok = (ids >= 0) & (ids < n_table)
    return torch.where(ok, ids >> shift, order_buckets(n_table, shift) - 1)


def gather_order_reference(ids: torch.Tensor, n_table: int,
                           shift: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``gather_order``: a stable sort of the
    positions by bucket."""
    order = torch.argsort(order_keys(ids, n_table, shift), stable=True).to(torch.int32)
    return order, ids[order.long()]


def gather_order(ids: torch.Tensor, n_table: int,
                 shift: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ids (q,)`` int32 → ``(order, ids_in_order)``, both ``(q,)`` int32:
    the positions bucket by bucket (``order_keys``), in position order
    within a bucket, and the ids in that order."""
    if ids.device.type == "cpu":
        return gather_order_reference(ids, n_table, shift)
    require(ids, "ids", device=ids.device, dtypes=(torch.int32,), ndim=1)
    if n_table < 1:
        raise ValueError(f"the table has no rows: {n_table}")
    buckets = order_buckets(n_table, shift)
    if buckets > ORDER_MAX_BUCKETS:
        raise ValueError(f"{buckets} buckets at shift {shift}; at most {ORDER_MAX_BUCKETS}")
    q = ids.shape[0]
    tiles = -(-q // ORDER_TILE)
    work = torch.empty(2 * q + (tiles + 1) * buckets, dtype=torch.int32, device=ids.device)
    order, in_order, counts = work[:q], work[q:2 * q], work[2 * q:]
    lib = library("gather", _SIGNATURES)
    launch(lib.tsg_gather_order, ids.data_ptr(), q, n_table, shift, buckets,
           counts.data_ptr(), counts[tiles * buckets:].data_ptr(), order.data_ptr(),
           in_order.data_ptr(), device=ids.device, kernel="gather_order")
    return order, in_order


@functools.lru_cache(maxsize=None)
def l2_bytes(device: torch.device) -> int:
    """The L2 cache of a CUDA card, in bytes."""
    return int(torch.cuda.get_device_properties(device).L2_cache_size)


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


def _check(table: torch.Tensor, ids: torch.Tensor, out: torch.Tensor, oob: str) -> None:
    if oob not in _OOB:
        raise ValueError(f"oob must be one of {sorted(_OOB)}, got {oob!r}")
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows_into runs on cuda, got {table.device}")
    require(table, "table", device=table.device, dtypes=(table.dtype,), ndim=2)
    require(ids, "ids", device=table.device, dtypes=(torch.int32,), ndim=1)
    require(out, "out", device=table.device, dtypes=(table.dtype,), ndim=2)
    q, w = ids.shape[0], table.shape[1]
    if tuple(out.shape) != (q, w):
        raise ValueError(f"out must be {(q, w)}, got {tuple(out.shape)}")
    if out.numel() and table.shape[0] == 0:
        raise ValueError("cannot gather from an empty table")


def gather_rows_into(table: torch.Tensor, ids: torch.Tensor, out: torch.Tensor,
                     oob: str = "clamp") -> torch.Tensor:
    """``gather_rows`` on the card into a given contiguous ``out (q, w)``,
    whose base, like the table's, may lie anywhere past a 16-byte boundary;
    in id order where ``gather_order_plan`` says so; returns ``out``."""
    _check(table, ids, out, oob)
    if out.numel() == 0:
        return out
    n, q = table.shape[0], ids.shape[0]
    plan = gather_order_plan(n, q, table.shape[1] * table.element_size(),
                             l2_bytes(table.device))
    if tracing.enabled():
        tracing.count(rows=q, ordered_rows=q if plan["ordered"] else 0)
    ordering = gather_order(ids, n, plan["shift"]) if plan["ordered"] else None
    _launch_rows(table, ids, out, oob, ordering)
    return out


def gather_rows_in_order(table: torch.Tensor, ids: torch.Tensor, out: torch.Tensor, oob: str,
                         ordering: Optional[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """The gather kernel on the card as given, whatever the plan says: in
    output order with ``ordering`` None, else over ``gather_order(ids, n,
    shift)``'s ``(order, ids_in_order)``; returns ``out``."""
    _check(table, ids, out, oob)
    if ordering is not None:
        for t, name in zip(ordering, ("order", "ids_in_order")):
            require(t, name, device=table.device, dtypes=(torch.int32,), ndim=1)
            if t.shape != ids.shape:
                raise ValueError(f"{name} must be {tuple(ids.shape)}, got {tuple(t.shape)}")
    if out.numel():
        _launch_rows(table, ids, out, oob, ordering)
    return out


def _launch_rows(table, ids, out, oob, ordering) -> None:
    row_bytes = table.shape[1] * table.element_size()
    plan = gather_plan(row_bytes, table.data_ptr() % 16, out.data_ptr() % 16)
    ids_ptr, order_ptr = ((ids.data_ptr(), None) if ordering is None
                          else (ordering[1].data_ptr(), ordering[0].data_ptr()))
    lib = library("gather", _SIGNATURES)
    launch(lib.tsg_gather_rows, table.data_ptr(), ids_ptr, order_ptr, out.data_ptr(),
           table.shape[0], ids.shape[0], row_bytes, plan["word"], plan["lanes_per_row"],
           plan["words_per_lane"], _OOB[oob], device=table.device, kernel="gather_rows")
