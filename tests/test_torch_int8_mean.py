"""The int8 fanout mean's launch plan and the arithmetic its kernel relies on,
on the CPU.

``csrc/gather_mean.cu``'s int8 kernel cannot run here, so these tests hold
what it is built from: ``kernels/gather_mean.py::int8_plan`` (a pure
function, as ``gather_plan`` is tested in ``tests/test_torch_kernels.py``),
and, exhaustively in numpy, the identities it computes with: the
magic-number conversion, the biased sums in 16-bit lanes, and the bf16
product of exact bf16 operands. Then ``ops.row_gather_fanout_mean`` of an
int8 table (the kernel's plain version on CPU tensors) against ``jax.jit``
of the reference at a fanout above the packed sums' chunk and an odd width,
with ``tests/test_torch_quantize.py``'s tolerance: bitwise, except f32
dequantize-then-mean above F = 16, within 1e-6 of scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sage import ops as jops
from tpu_sage.data import quantize as jq
from tpu_sage_torch import ops
from tpu_sage_torch.data import quantize as tq
from tpu_sage_torch.kernels.gather_mean import INT8_CHUNK, int8_plan

MODES = [(torch.bfloat16, True), (torch.bfloat16, False), (torch.float32, True),
         (torch.float32, False)]
MODE_IDS = ["bf16-summean", "bf16-dequantize", "f32-summean", "f32-dequantize"]


def prmt(a, b, sel):
    """PTX ``prmt.b32`` in its generic mode, elementwise on uint32 arrays:
    result byte i is byte ``sel[i] & 7`` of (a, b), or its sign replicated
    when ``sel[i] & 8``."""
    a, b = np.asarray(a, np.uint64), np.asarray(b, np.uint64)
    both = a | (b << np.uint64(32))
    out = np.zeros(np.broadcast(a, b).shape, np.uint64)
    for i in range(4):
        nib = (sel >> (4 * i)) & 0xF
        byte = (both >> np.uint64(8 * (nib & 7))) & np.uint64(0xFF)
        if nib & 8:
            byte = np.where(byte & np.uint64(0x80), np.uint64(0xFF), np.uint64(0))
        out |= byte << np.uint64(8 * i)
    return out.astype(np.uint32)


def bf16_round(x32):
    """Round-to-nearest-even of f32 values to bf16, as f32 (finite inputs)."""
    bits = np.asarray(x32, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + np.uint64(0x7FFF) + ((bits >> np.uint64(16)) & np.uint64(1))) \
        & np.uint64(0xFFFF0000)
    return bits.astype(np.uint32).view(np.float32)


def bf16_product(q, s):
    """The bf16 product of ``q`` and ``s`` rounded once (``mul.rn.bf16x2``):
    the exact product (f64: at most 16 significant bits) rounded to 8
    significant bits, to nearest even, with bf16's subnormals and
    overflow to infinity."""
    x = np.asarray(q, np.float64) * np.asarray(s, np.float64)
    _, e = np.frexp(x)
    quantum = np.ldexp(1.0, np.maximum(e - 8, -133))
    r = np.rint(x / quantum) * quantum
    return np.where(np.abs(r) >= 2.0 ** 128, np.copysign(np.inf, x), r).astype(np.float32)


@pytest.mark.parametrize("base_mod16", range(16))
def test_int8_plan_at_the_steps_width_for_every_base(base_mod16):
    """602-byte rows are 2-byte aligned: every base realigns (the kernel
    reads aligned 4-byte words and shifts them into columns), 32 lanes a
    root cover the 151 column words in one pass."""
    for dtype, summean in MODES:
        plan = int8_plan(602, base_mod16, 10, dtype, summean)
        assert plan["word"] == 4 and plan["realign"]
        assert plan["lanes_per_row"] == 32
        assert plan["lanes_per_row"] * plan["words_per_lane"] * 4 >= 602
        assert plan["chunk"] == 10


@pytest.mark.parametrize("d,base_mod16,realign,lanes", [
    (601, 0, True, 32), (603, 8, True, 32), (601, 3, True, 32),
    (16, 0, False, 8), (16, 4, False, 8), (16, 2, True, 8), (16, 9, True, 8),
    (608, 0, False, 32), (608, 12, False, 32), (608, 6, True, 32),
    (160, 0, False, 8), (164, 0, False, 16), (320, 0, False, 16), (324, 0, False, 32),
])
def test_int8_plan_realigns_and_groups_lanes_by_width(d, base_mod16, realign, lanes):
    """Rows realign unless both the width and the base are multiples of 4;
    a root takes the fewest of 8, 16 and 32 lanes whose 5 column words a
    lane cover its row (wider rows go in passes of 32 lanes)."""
    plan = int8_plan(d, base_mod16, 10, torch.bfloat16, True)
    assert plan["realign"] == realign and plan["lanes_per_row"] == lanes
    assert plan["words_per_lane"] == 5


@pytest.mark.parametrize("fanout", [1, 10, 256, 257, 258, 300])
def test_int8_plan_chunks_long_fanouts_of_the_packed_sums(fanout):
    """Summean folds its 16-bit lanes into int32 sums every INT8_CHUNK rows,
    a multiple of every group's lanes; the dequantize modes sum in f32 and
    take the fanout whole."""
    for dtype in (torch.bfloat16, torch.float32):
        summed = int8_plan(602, 2, fanout, dtype, True)
        assert summed["arith"] == "packed int32"
        assert summed["chunk"] == min(fanout, INT8_CHUNK)
        assert summed["chunk"] % summed["lanes_per_row"] == 0 or summed["chunk"] == fanout
        deq = int8_plan(602, 2, fanout, dtype, False)
        assert deq["chunk"] == fanout
        assert deq["arith"] == ("magic bf16x2" if dtype == torch.bfloat16 else "magic fma")
    with pytest.raises(TypeError):
        int8_plan(602, 0, 10, torch.float16, True)


def test_magic_number_conversion_is_exact_for_every_int8():
    """``float(q)`` as the kernel computes it: the byte biased by XOR 0x80
    put into 0x4B0000xx by one prmt (selector 0x7540 + e picks byte e), that
    f32 minus 8388736. Exact for all 256 values, in every byte position, and
    its lower 16 bits are zero, so its upper half is ``bf16(q)``."""
    q = np.arange(-128, 128)
    byte = q.astype(np.int8).view(np.uint8).astype(np.uint32)
    for e in range(4):
        word = (byte << (8 * e)) ^ 0x80808080
        bits = prmt(word.astype(np.uint32), 0x4B000000, 0x7540 + e)
        got = bits.view(np.float32) - np.float32(8388736.0)
        np.testing.assert_array_equal(got, q.astype(np.float32))
        assert not (got.view(np.uint32) & 0xFFFF).any()
        np.testing.assert_array_equal(bf16_round(got), got)


@pytest.mark.parametrize("rows", [1, 10, INT8_CHUNK])
def test_biased_16_bit_lanes_sum_like_int32_up_to_the_chunk(rows):
    """Summean's packed sums: each byte XORed with 0x80 (q + 128, in 0..255),
    bytes 0, 1 and 2, 3 zero-extended into the 16-bit lanes of two registers
    (prmt 0x4140 and 0x4342), summed as 32-bit integers over ``rows`` rows:
    each lane less 128 · rows is the column's int32 sum. Held at the extremes
    (every byte -128, every byte 127, which fill a lane to 255 · INT8_CHUNK <
    2^16) and on random bytes; at INT8_CHUNK + 1 rows of 127 the lanes
    would still fit, so the chunk is the largest multiple of 32 that does."""
    assert 255 * INT8_CHUNK < 2 ** 16 <= 255 * (INT8_CHUNK + 32) and INT8_CHUNK % 32 == 0
    rng = np.random.default_rng(rows)
    for q in (np.full((rows, 4), -128), np.full((rows, 4), 127),
              rng.integers(-128, 128, (rows, 4))):
        words = (q.astype(np.int8).view(np.uint8).astype(np.uint32)
                 << (8 * np.arange(4, dtype=np.uint32))).sum(1).astype(np.uint32)
        biased = words ^ np.uint32(0x80808080)
        lanes = [prmt(biased, 0, 0x4140).astype(np.uint64).sum(),
                 prmt(biased, 0, 0x4342).astype(np.uint64).sum()]
        assert max(lanes) < 2 ** 32
        got = [int(lanes[0] & 0xFFFF), int(lanes[0] >> 16), int(lanes[1] & 0xFFFF),
               int(lanes[1] >> 16)]
        np.testing.assert_array_equal(np.array(got) - 128 * rows, q.sum(0))


def test_realigning_prmt_takes_any_byte_offset():
    """A column word off 4-byte alignment by ``sh`` bytes is one prmt of the
    two aligned words that cover it, selector 0x3210 + 0x1111 · sh."""
    data = np.random.default_rng(0).integers(0, 256, 64).astype(np.uint8)
    words = data.view(np.uint32)
    for start in range(0, 56):
        sh, k = start % 4, start // 4
        got = prmt(words[k], words[k + 1], 0x3210 + 0x1111 * sh)
        assert int(got) == int(data[start:start + 4].view(np.uint32)[0])


def test_bf16_product_of_exact_operands_rounds_like_the_f32_product():
    """The bf16 dequantize: ``round_bf16(fl32(q · s))`` (the plain version's
    f32 product, exact since q and s have 8 significant bits each, then its
    rounding) equals the bf16 product rounded once (``mul.rn.bf16x2`` of
    ``bf16(q)`` and ``bf16(s)``) for every int8 q and every finite bf16 s,
    subnormals and overflow included."""
    s = np.arange(0, 1 << 16, dtype=np.uint32) << 16
    s = s.view(np.float32)
    s = s[np.isfinite(s)]
    assert s.size == 65280
    for q in range(-128, 128):
        with np.errstate(over="ignore"):
            f32 = np.float32(q) * s
        want = np.where(np.isfinite(f32), bf16_round(np.where(np.isfinite(f32), f32, 0)), f32)
        got = bf16_product(q, s)
        np.testing.assert_array_equal(got.view(np.uint32), want.astype(np.float32).view(
            np.uint32), err_msg=f"q = {q}")


@pytest.mark.parametrize("dtype,summean", MODES, ids=MODE_IDS)
def test_int8_mean_above_the_chunk_at_an_odd_width_matches_the_jitted_reference(dtype,
                                                                                summean):
    """``ops.row_gather_fanout_mean`` of a 603-wide int8 table at F = 300
    (past the packed sums' chunk of 256) against ``jax.jit`` of the
    reference's: bitwise, but f32 dequantize-then-mean (XLA's CPU reduction
    of a fanout above 16 takes its own order) within 1e-6 of scale."""
    rng = np.random.default_rng(7)
    feats = (rng.normal(size=(400, 603)) * rng.uniform(0.05, 4.0, size=603)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jf = jq.quantize_feats(feats, out_dtype=jdt)
    tf = tq.quantize_feats(feats, out_dtype=dtype, device="cpu")
    ids = rng.integers(-3, 403, 8 * 300).astype(np.int32)
    want = jax.jit(lambda f, i: jops.row_gather_fanout_mean(
        f, i, 300, int8_summean=summean))(jf, jnp.asarray(ids))
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = ops.row_gather_fanout_mean(tf, torch.from_numpy(ids), 300, int8_summean=summean)
    assert got.dtype == dtype and tuple(got.shape) == (8, 603)
    if dtype == torch.float32 and not summean:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
        return
    np.testing.assert_array_equal(got.float().numpy(), want)
