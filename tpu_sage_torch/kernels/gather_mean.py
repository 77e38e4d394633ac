"""Gather + fanout mean in one pass: ``out[r] = mean_j table[ids[r·F + j]]``.

Counterpart of ``tpu_sage/kernels/gather_mean.py::gather_fanout_mean``: f32
means of bf16 or f32 rows, without materializing the ``(R·F, d)`` gathered
block. On a CUDA tensor the wrapper launches ``csrc/gather_mean.cu``; on a CPU
tensor it runs ``gather_fanout_mean_reference``, which sums the fanout axis
in the kernel's order (j = 0, 1, ...) and divides by ``F``. Out-of-range ids
take the ``plain`` form (``gather.plain_ids``).

``gather_fanout_mean_int8`` is the same pass over an int8 table with
per-column scales (``tpu_sage/data/quantize.py::QuantizedFeats.fanout_mean``,
XLA in the JAX package): the second entry point of ``csrc/gather_mean.cu``,
with its own counter ``INT8_LAUNCHES``, its plain version
``gather_fanout_mean_int8_reference`` and its launch plan ``int8_plan``.

``gather_fanout_mean_owned`` is the owner side of the partitioned path's
pre-reduced exchange (``tpu_sage/dist/halo.py::dist_gather_fanout_mean``,
XLA in the JAX package): the same pass over this rank's rows ``[lo, lo +
m)`` of a bf16, f32 or int8 table, rows outside the range counting as zero
rows and the divisor staying ``F``. The third entry point of
``csrc/gather_mean.cu``, with its counter ``OWNED_LAUNCHES`` and its plain
version ``gather_fanout_mean_owned_reference``. Its kernel keeps the
loads of owned rows in flight, skipping the ids it does not own.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu_sage_torch.kernels._build import launch, library, require
from tpu_sage_torch.kernels.gather import plain_ids

LAUNCHES = 0  # kernel launches since the last reset (kernels.reset_launch_counts)
INT8_LAUNCHES = 0  # the same, of the int8 entry point
OWNED_LAUNCHES = 0  # the same, of the owner-masked entry point

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    "tsg_gather_fanout_mean": (_P, _P, _P, _LL, _LL, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, _P),
    "tsg_gather_fanout_mean_int8": (_P, _P, _P, _P, _LL, _LL) + (ctypes.c_int,) * 7 + (_P,),
    "tsg_gather_fanout_mean_owned": (_P, _P, _P, _LL, _LL, _LL, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, _P),
}
_OWNED_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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


def int8_word_bytes(q: torch.Tensor) -> int:
    """Bytes per word the owner-masked kernel reads an int8 row in: the
    widest of 16, 8, 4, 2 and 1 that divides the row width and the table's
    address. A 602-wide row moves as 301 two-byte words."""
    d = q.shape[1]
    for v in (16, 8, 4, 2):
        if d % v == 0 and q.data_ptr() % v == 0:
            return v
    return 1


INT8_CHUNK = 256  # rows a packed 16-bit sum of biased bytes holds: 255 * 256 < 2^16
INT8_WORDS_PER_LANE = 5  # 4-byte column words a lane a pass (csrc: kInt8Words)


def int8_plan(d: int, base_mod16: int, fanout: int, out_dtype: torch.dtype,
              summean: bool) -> dict:
    """The int8 fanout mean's launch plan, a pure function of the row width
    ``d``, the table's address mod 16, the fanout and the mode:

    - ``word``: bytes per load. Every row is read as the aligned 4-byte
      words that cover it; ``realign`` when a row may start off 4-byte
      alignment (``d`` or the address not a multiple of 4, as for the
      602-byte rows), and then each 4-byte column word is one ``prmt`` of
      two loaded words; ``words_per_lane`` column words a lane a pass;
    - ``lanes_per_row``: lanes a root, the fewest of 8, 16 and 32 whose
      words cover the row in one pass (32 for 602 bytes; up to 4 roots a
      warp for rows of at most 160 bytes);
    - ``arith``: ``"packed int32"`` (summean: the bytes biased by 128, two
      columns' sums in the 16-bit lanes of one register), ``"magic
      bf16x2"`` or ``"magic fma"`` (dequantize then mean into bf16 or f32:
      the conversion without a conversion instruction, then one
      ``mul.rn.bf16x2`` or one FMA);
    - ``chunk``: in summean, the rows summed before the packed lanes fold
      into int32 sums, ``min(fanout, INT8_CHUNK)``; else the fanout."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    lanes = 8
    while lanes < 32 and lanes * INT8_WORDS_PER_LANE < -(-d // 4):
        lanes *= 2
    if summean:
        arith = "packed int32"
    else:
        arith = "magic bf16x2" if out_dtype == torch.bfloat16 else "magic fma"
    return {"word": 4, "realign": d % 4 != 0 or base_mod16 % 4 != 0,
            "words_per_lane": INT8_WORDS_PER_LANE, "lanes_per_row": lanes, "arith": arith,
            "chunk": min(fanout, INT8_CHUNK) if summean else fanout}


def reciprocal(fanout: int) -> float:
    """``fl32(1/F)``, correctly rounded (exact as a Python float). The
    reference's ``scale / F`` is ``scale · fl32(1/F)`` under jit, where XLA
    rewrites the division; eagerly it divides, and the two differ in the
    last bit of about one f32 mean in six."""
    return float(np.float32(1.0) / np.float32(fanout))


def gather_fanout_mean_int8_reference(q: torch.Tensor, scale: torch.Tensor, ids: torch.Tensor,
                                      fanout: int, out_dtype: torch.dtype,
                                      summean: bool = True) -> torch.Tensor:
    """Plain PyTorch version of ``gather_fanout_mean_int8``.

    ``summean=False`` takes the form the reference's ``jnp.mean`` of the
    dequantized rows has under jit on the CPU: bf16 rows are dequantized
    (one rounding) and summed in f32; f32 rows are summed as
    ``fma(q, scale, acc)``, since XLA contracts the dequantizing multiply
    into the sum (done here in f64, where ``acc + q·scale`` is exact: every
    term is a multiple of the scale's last bit and spans under 40 bits);
    then both multiply by ``fl32(1/F)``."""
    rows = q[plain_ids(ids, q.shape[0]).long()].view(-1, fanout, q.shape[1])
    if summean:
        s = rows.to(torch.int32).sum(1)
        return (s.float() * (scale * reciprocal(fanout))).to(out_dtype)
    acc = torch.zeros((rows.shape[0], q.shape[1]), dtype=torch.float32, device=q.device)
    if out_dtype == torch.float32:
        scale64 = scale.double()
        for j in range(fanout):
            acc = (acc.double() + rows[:, j].double() * scale64).float()
    else:
        deq = (rows.to(out_dtype) * scale.to(out_dtype)).float()
        for j in range(fanout):
            acc = acc + deq[:, j]
    return (acc * reciprocal(fanout)).to(out_dtype)


def gather_fanout_mean_int8(q: torch.Tensor, scale: torch.Tensor, ids: torch.Tensor,
                            fanout: int, out_dtype: torch.dtype,
                            summean: bool = True) -> torch.Tensor:
    """``q (n, d)`` int8, ``scale (d,)`` f32, ``ids (R·fanout,)`` int32 →
    ``(R, d)`` in ``out_dtype`` (bf16 or f32).

    ``summean``: the int32 sum of the raw rows times ``scale / F`` (one
    dequantization per mean); otherwise each row dequantized to
    ``out_dtype``, summed in f32 and multiplied by ``1/F`` (the reference's
    ``int8_summean=False``; the plain version says how)."""
    global INT8_LAUNCHES
    if fanout < 1 or ids.shape[0] % fanout:
        raise ValueError(f"ids length {ids.shape[0]} is not a multiple of fanout {fanout}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    if q.device.type == "cpu":
        return gather_fanout_mean_int8_reference(q, scale, ids, fanout, out_dtype, summean)
    if q.device.type != "cuda":
        raise ValueError(f"gather_fanout_mean_int8 runs on cuda or cpu, got {q.device}")
    require(q, "q", device=q.device, dtypes=(torch.int8,), ndim=2)
    require(scale, "scale", device=q.device, dtypes=(torch.float32,), ndim=1)
    require(ids, "ids", device=q.device, dtypes=(torch.int32,), ndim=1)
    n, d = q.shape
    if scale.shape[0] != d:
        raise ValueError(f"scale has {scale.shape[0]} columns, the table {d}")
    r = ids.shape[0] // fanout
    out = torch.empty((r, d), dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out
    if n == 0:
        raise ValueError("cannot gather from an empty table")
    plan = int8_plan(d, q.data_ptr() % 16, fanout, out_dtype, summean)
    lib = library("gather_mean", _SIGNATURES)
    launch(lib.tsg_gather_fanout_mean_int8, q.data_ptr(), ids.data_ptr(), scale.data_ptr(),
           out.data_ptr(), n, r, d, fanout, int(out_dtype == torch.bfloat16), int(summean),
           int(plan["realign"]), plan["lanes_per_row"], plan["chunk"], device=q.device)
    INT8_LAUNCHES += 1
    return out


def gather_fanout_mean_owned_reference(table: torch.Tensor, ids: torch.Tensor, fanout: int,
                                       lo: int) -> torch.Tensor:
    """Plain PyTorch version of ``gather_fanout_mean_owned``: the rows this
    rank owns, the others zero, summed in f32 in order j = 0, 1, ... from
    zero (an int8 table's raw values in int32), times ``fl32(1/F)``."""
    m, d = table.shape
    local = ids.long() - lo
    owned = ((local >= 0) & (local < m))[:, None]
    rows = table[local.clamp(0, max(m - 1, 0))]
    if table.dtype == torch.int8:
        s = torch.where(owned, rows.to(torch.int32), 0).view(-1, fanout, d)
        s = s.sum(1, dtype=torch.int32)
        return s.float() * reciprocal(fanout)
    x = torch.where(owned, rows.float(), 0.0).view(-1, fanout, d)
    acc = torch.zeros((x.shape[0], d), dtype=torch.float32, device=table.device)
    for j in range(fanout):
        acc = acc + x[:, j]
    return acc * reciprocal(fanout)


def gather_fanout_mean_owned(table: torch.Tensor, ids: torch.Tensor, fanout: int,
                             lo: int) -> torch.Tensor:
    """``table (m, d)`` bf16/f32/int8, this rank's rows ``[lo, lo + m)`` of
    the global table; ``ids (R·fanout,)`` int32 global ids → ``(R, d)`` f32
    partial means over the owned rows (an int8 table's of its raw values)."""
    global OWNED_LAUNCHES
    if fanout < 1 or ids.shape[0] % fanout:
        raise ValueError(f"ids length {ids.shape[0]} is not a multiple of fanout {fanout}")
    if table.device.type == "cpu":
        return gather_fanout_mean_owned_reference(table, ids, fanout, lo)
    if table.device.type != "cuda":
        raise ValueError(f"gather_fanout_mean_owned runs on cuda or cpu, got {table.device}")
    require(table, "table", device=table.device, dtypes=tuple(_OWNED_KINDS), ndim=2)
    require(ids, "ids", device=table.device, dtypes=(torch.int32,), ndim=1)
    m, d = table.shape
    r = ids.shape[0] // fanout
    out = torch.empty((r, d), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    vec = int8_word_bytes(table) if table.dtype == torch.int8 else word_elements(table)
    lib = library("gather_mean", _SIGNATURES)
    launch(lib.tsg_gather_fanout_mean_owned, table.data_ptr(), ids.data_ptr(), out.data_ptr(),
           int(lo), m, r, d, fanout, _OWNED_KINDS[table.dtype], vec, device=table.device)
    OWNED_LAUNCHES += 1
    return out
