"""The row gather in id order (``kernels/gather.py``): ``gather_order_plan``,
the ordering ``gather_order`` and the gather kernel walking it.

On the CPU: the plan at the exact cells' shapes and at the shapes that must
stay in output order, the ordering's plain version (a stable sort of the
positions by id bucket), the plain ordered gather against
``gather_rows_reference``, the wrapper's choice and its span counters, and
the constants the wrapper shares with ``csrc/gather.cu``. The tests marked
``chip`` hold the ordering kernel against its plain version and the ordered
gather bitwise against the gather in output order, on the card; they skip
without one. This file imports no JAX, so on the card it runs alone::

    python3 -m pytest tests/test_torch_gather_order.py --noconftest -m chip -q
"""

import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_sage_torch import kernels, tracing
from tpu_sage_torch.kernels import _build
from tpu_sage_torch.kernels import gather
from tpu_sage_torch.kernels.gather import (ORDER_MAX_BUCKETS, ORDER_TILE, gather_order,
                                           gather_order_plan, gather_order_reference,
                                           gather_rows, gather_rows_in_order, gather_rows_reference,
                                           order_buckets, order_keys)

N_NODES, DEGREE, CHUNK = 232_965, 128, 4096  # the exact cells' graph and chunk
RAGGED = N_NODES - (N_NODES // CHUNK) * CHUNK  # the last chunk's 3,589 nodes
H100_L2 = 50 * 1024 * 1024


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here; this test runs on the card")
    return torch.device("cuda", 0)


# (table rows, ids, row bytes, ordered): the exact cells' chunks (f32 602 and
# 256 wide for mean, the pool's 512), whole and ragged; a bf16 602-wide
# chunk (exact validation's layer 0), whose rows share sectors with their
# neighbours too often to gain; the sampled training gathers (bf16 602
# wide) and the fused first layer's projected rows (bf16 128 wide) at 512
# and 12,800 ids, the NCE step's level 1 and the fused backward's raw rows;
# the owners' answers of a 4-rank partitioned exact pass; a table under
# half of L2
PLAN_CASES = {
    "mean layer 0 chunk": (N_NODES, CHUNK * DEGREE, 2408, True),
    "mean layer 1 chunk": (N_NODES, CHUNK * DEGREE, 1024, True),
    "max-pool chunk": (N_NODES, CHUNK * DEGREE, 2048, True),
    "ragged last chunk": (N_NODES, RAGGED * DEGREE, 2408, True),
    "ragged last chunk, layer 1": (N_NODES, RAGGED * DEGREE, 1024, True),
    "ragged last chunk, max-pool": (N_NODES, RAGGED * DEGREE, 2048, True),
    "bf16 602 chunk": (N_NODES, CHUNK * DEGREE, 1204, False),
    "train level 0": (N_NODES, 512, 1204, False),
    "train level 1": (N_NODES, 12_800, 1204, False),
    "fused projected 512": (N_NODES, 512, 256, False),
    "fused projected 12,800": (N_NODES, 12_800, 256, False),
    "NCE level 1": (N_NODES, 153_600, 1204, False),
    "fused backward raw rows": (N_NODES, 128_000, 1204, False),
    "4-rank halo owner": (58_242, 4 * 2048 * DEGREE, 2048, True),
    "table under half of L2": (10_000, 524_288, 2408, False),
    "rows under 32 bytes": (20_000_000, 80_000_000, 16, False),
    "one row": (1, 4096, 2408, False),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_orders_at_the_exact_cells_shapes_only(case):
    n, q, row_bytes, ordered = PLAN_CASES[case]
    plan = gather_order_plan(n, q, row_bytes, H100_L2)
    assert plan["ordered"] is ordered
    assert plan["buckets"] == order_buckets(n, plan["shift"]) <= ORDER_MAX_BUCKETS
    assert plan["shift"] == 0 or order_buckets(n, plan["shift"] - 1) > ORDER_MAX_BUCKETS


def test_plan_at_the_cells_shapes_buckets_512_rows_and_reads_each_row_two_and_a_half_times():
    plan = gather_order_plan(N_NODES, CHUNK * DEGREE, 2408, H100_L2)
    assert plan["shift"] == 9 and plan["buckets"] == 457
    assert plan["repeats"] == pytest.approx(2.5155, abs=1e-4)


@pytest.mark.parametrize("n", [1, 2, 1022, 1023, 1024, 5000, 58_242, N_NODES, 111_059_956])
def test_plan_shift_is_the_least_that_keeps_the_buckets(n):
    shift = gather_order_plan(n, 1000, 4, H100_L2)["shift"]
    assert order_buckets(n, shift) <= ORDER_MAX_BUCKETS
    assert shift == 0 or order_buckets(n, shift - 1) > ORDER_MAX_BUCKETS


def test_plan_refuses_an_empty_table():
    with pytest.raises(ValueError, match="no rows"):
        gather_order_plan(0, 10, 4, H100_L2)


def exact_ids(nodes, n=N_NODES, degree=DEGREE, pad=0.0, oob=0.0, seed=0):
    """A chunk's ``nodes × degree`` neighbour ids, uniform in ``[0, n)``,
    a share ``pad`` of them -1 (past a node's degree) and a share ``oob``
    out of range on either side."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, n, (nodes * degree,), generator=g, dtype=torch.int32)
    u = torch.rand(ids.shape, generator=g)
    ids = torch.where(u < pad, -1, ids)
    far = torch.where(torch.rand(ids.shape, generator=g) < 0.5, -n - 3, n + 5).to(torch.int32)
    return torch.where((u >= pad) & (u < pad + oob), far, ids)


# (nodes, degree, table rows, pad share, out-of-range share)
ORDER_CASES = {
    "cell chunk": (CHUNK, DEGREE, N_NODES, 0.0, 0.0),
    "ragged last chunk": (RAGGED, DEGREE, N_NODES, 0.0, 0.0),
    "ragged, padded, out of range": (RAGGED, DEGREE, N_NODES, 0.3, 0.05),
    "under one tile": (7, 13, 5000, 0.1, 0.1),
    "small table": (64, 32, 40, 0.0, 0.2),
    "every id padding": (3, 50, 1000, 1.0, 0.0),
}


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_plain_ordering_is_a_stable_permutation_by_bucket(case):
    nodes, degree, n, pad, oob = ORDER_CASES[case]
    ids = exact_ids(nodes, n, degree, pad, oob)
    shift = gather_order_plan(n, ids.numel(), 4, H100_L2)["shift"]
    order, in_order = gather_order_reference(ids, n, shift)
    assert order.dtype == in_order.dtype == torch.int32
    assert torch.equal(torch.sort(order).values, torch.arange(ids.numel(), dtype=torch.int32))
    assert torch.equal(in_order, ids[order.long()])
    keys = order_keys(ids, n, shift)[order.long()]
    assert bool((keys[1:] >= keys[:-1]).all())
    same = keys[1:] == keys[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())  # position order within a bucket
    outside = (ids < 0) | (ids >= n)
    assert torch.equal(order_keys(ids, n, shift) == order_buckets(n, shift) - 1,
                       outside | (ids >> shift == order_buckets(n, shift) - 1))
    assert bool((order_keys(ids, n, shift)[~outside] == ids[~outside] >> shift).all())


def test_ordering_on_the_cpu_is_its_plain_version_and_launches_nothing():
    ids = exact_ids(9, 300, 11, pad=0.2, oob=0.1)
    kernels.reset_launch_counts()
    got = gather_order(ids, 300, 2)
    want = gather_order_reference(ids, 300, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sum(kernels.launch_counts().values()) == 0


def plain_ordered_gather(table, ids, oob, shift):
    """``out[order] = table[ids[order]]``: the gather walking the ids in
    id order, in plain PyTorch."""
    order, in_order = gather_order_reference(ids, table.shape[0], shift)
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype)
    out[order.long()] = gather_rows_reference(table, in_order, oob)
    return out


@pytest.mark.parametrize("oob", ["clamp", "zero"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("case", ["ragged, padded, out of range", "small table", "under one tile"])
def test_plain_ordered_gather_is_bitwise_the_gather_in_output_order(oob, dtype, case):
    nodes, degree, n, pad, oob_share = ORDER_CASES[case]
    ids = exact_ids(nodes, n, degree, pad, oob_share, seed=3)
    table = (torch.randn((n, 37), generator=torch.Generator().manual_seed(1)) * 50).to(dtype)
    shift = gather_order_plan(n, ids.numel(), 37 * table.element_size(), H100_L2)["shift"]
    got = plain_ordered_gather(table, ids, oob, shift)
    assert torch.equal(got.view(torch.uint8), gather_rows_reference(table, ids, oob).view(torch.uint8))


def test_source_constants_match_the_wrapper():
    text = open(_build.library_path("gather")[0]).read()
    warps = int(re.search(r"kWarps = (\d+);", text).group(1))
    steps = int(re.search(r"kOrderSteps = (\d+);", text).group(1))
    assert ORDER_TILE == warps * 32 * steps
    assert f"kOrderMaxBuckets = {ORDER_MAX_BUCKETS};" in text
    assert 'extern "C" int tsg_gather_order(' in text
    for kernel in ("gather_order_count_kernel", "gather_order_offsets_kernel",
                   "gather_order_scatter_kernel"):
        assert kernel in text
        # the benchmark times gather_rows's kernels by their names: the
        # ordering's must not match them
        assert not re.search(r"gather_rows_(words|realign)_kernel", kernel)
    assert "template <typename W, int WPL, bool ORDERED>" in text
    assert "template <int WPL, int LPR, int UNIT, bool ORDERED>" in text


class _Recorder:
    """Stands in for the card in ``gather_rows_into``: records the ordering
    and the launch it would make."""

    def __init__(self, monkeypatch):
        self.orderings, self.launches = [], []
        monkeypatch.setattr(gather, "_check", lambda *a: None)
        monkeypatch.setattr(gather, "l2_bytes", lambda device: H100_L2)
        monkeypatch.setattr(gather, "gather_order",
                            lambda ids, n, shift: self.orderings.append((n, shift)) or ("o", "i"))
        monkeypatch.setattr(gather, "_launch_rows",
                            lambda table, ids, out, oob, ordering: self.launches.append(ordering))


@pytest.mark.parametrize("case", ["mean layer 0 chunk", "max-pool chunk", "train level 1",
                                  "NCE level 1"])
def test_wrapper_orders_as_planned_and_counts_its_rows_in_the_open_span(monkeypatch, case):
    n, q, row_bytes, ordered = PLAN_CASES[case]
    rec = _Recorder(monkeypatch)
    width = row_bytes // 4 if row_bytes % 4 == 0 else row_bytes // 2
    dtype = torch.float32 if row_bytes % 4 == 0 else torch.bfloat16
    table = torch.zeros((1, width), dtype=dtype).expand(n, width)  # the shape, no memory
    out = torch.zeros((1, width), dtype=dtype).expand(q, width)
    ids = torch.zeros(q, dtype=torch.int32)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("tsg.exact.gather"):
            gather.gather_rows_into(table, ids, out, "zero")
        gather.gather_rows_into(table, ids, out, "zero")  # no open span: no counter
    recs = tracing.records()
    assert [r.name for r in recs] == ["tsg.exact.gather"]
    assert recs[0].counters == {"rows": q, "ordered_rows": q if ordered else 0}
    shift = gather_order_plan(n, q, row_bytes, H100_L2)["shift"]
    assert rec.orderings == ([(n, shift)] * 2 if ordered else [])
    assert rec.launches == ([("o", "i")] * 2 if ordered else [None, None])
    tracing.reset()
    gather.gather_rows_into(table, ids, out, "zero")  # no profiler: no record at all
    assert not tracing.records()


def test_card_entry_points_refuse_cpu_tensors():
    t, i = torch.zeros(3, 2), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="runs on cuda"):
        gather_rows_in_order(t, i, torch.zeros(1, 2), "zero", None)
    with pytest.raises(ValueError, match="oob must be one of"):
        gather_rows_in_order(t, i, torch.zeros(1, 2), "wrap", None)


# ---- on the card -------------------------------------------------------------

def _ordering_on_card(ids, n, shift):
    got = gather_order(ids.cuda(), n, shift)
    torch.cuda.synchronize()
    return tuple(t.cpu() for t in got)


@pytest.mark.chip
@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_ordering_kernel_equals_its_plain_version_on_the_card(card, case):
    nodes, degree, n, pad, oob = ORDER_CASES[case]
    ids = exact_ids(nodes, n, degree, pad, oob, seed=11)
    for shift in sorted({gather_order_plan(n, ids.numel(), 4, H100_L2)["shift"], 10}):
        if order_buckets(n, shift) > ORDER_MAX_BUCKETS:
            continue
        kernels.reset_launch_counts()
        got = _ordering_on_card(ids, n, shift)
        assert kernels.launch_counts()["gather_order"] == 1
        want = gather_order_reference(ids, n, shift)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (case, shift)


@pytest.mark.chip
def test_ordering_kernel_refuses_too_many_buckets(card):
    with pytest.raises(ValueError, match="buckets"):
        gather_order(torch.zeros(10, dtype=torch.int32, device=card), N_NODES, 0)


def _table(n, width, dtype, device, seed=5):
    g = torch.Generator(device=device).manual_seed(seed)
    if dtype == torch.int8:
        return torch.randint(-128, 128, (n, width), generator=g, device=device, dtype=torch.int8)
    return torch.randn((n, width), generator=g, device=device).to(dtype)


def _out_at(q, width, dtype, device, offset_bytes):
    """A contiguous ``(q, width)`` output whose base lies ``offset_bytes``
    past a 16-byte boundary, inside a buffer of 7s, and the buffer."""
    k = offset_bytes // torch.tensor([], dtype=dtype).element_size()
    flat = torch.full((q * width + 16,), 7, dtype=dtype, device=device)
    return flat[k:k + q * width].view(q, width), flat


def _untouched_around(flat, out):
    """The buffer's elements before and after ``out`` are still 7."""
    k = (out.data_ptr() - flat.data_ptr()) // flat.element_size()
    rest = torch.cat([flat[:k], flat[k + out.numel():]])
    return bool((rest == 7).all())


# (width, dtype): realign at 4-byte and 2-byte units, words at 1,024 and
# 2,048 bytes (whole sectors); rows that share sectors with their neighbours
# in the words form (1,200 bytes: half sectors; 36 bytes: two rows a warp)
# and in the realign form at 2-byte units (int8 602)
GATHER_FORMS = {
    "f32 602 (realign, UNIT 4)": (602, torch.float32),
    "bf16 602 (realign, UNIT 2)": (602, torch.bfloat16),
    "f32 256 (words)": (256, torch.float32),
    "f32 512 (words)": (512, torch.float32),
    "bf16 600 (words, half sectors)": (600, torch.bfloat16),
    "f32 9 (words, two rows a warp)": (9, torch.float32),
    "int8 602 (realign, UNIT 2)": (602, torch.int8),
}
# (ids case, oob, output base past 16 bytes): whole and ragged chunks, -1 and
# out-of-range ids under both forms, outputs off alignment by a whole
# element of each dtype
ORDERED_CASES = [(form, *case) for form in sorted(GATHER_FORMS) for case in (
    ("cell chunk", "zero", 0),
    ("ragged last chunk", "zero", 0),
    ("ragged, padded, out of range", "zero", 0),
    ("ragged, padded, out of range", "clamp", 0),
    ("cell chunk", "zero", 4),
    ("ragged, padded, out of range", "clamp", 2),
) if case[2] % torch.tensor([], dtype=GATHER_FORMS[form][1]).element_size() == 0]


@pytest.mark.chip
@pytest.mark.parametrize("form, ids_case, oob, out_offset", ORDERED_CASES)
def test_ordered_gather_is_bitwise_the_gather_in_output_order_on_the_card(card, form, ids_case,
                                                                         oob, out_offset):
    width, dtype = GATHER_FORMS[form]
    nodes, degree, n, pad, oob_share = ORDER_CASES[ids_case]
    table = _table(n, width, dtype, card)
    ids = exact_ids(nodes, n, degree, pad, oob_share, seed=2).to(card)
    q = ids.shape[0]
    plan = gather_order_plan(n, q, width * table.element_size(), gather.l2_bytes(card))
    plain, plain_buf = _out_at(q, width, dtype, card, out_offset)
    ordered, ordered_buf = _out_at(q, width, dtype, card, out_offset)
    kernels.reset_launch_counts()
    gather_rows_in_order(table, ids, plain, oob, None)
    gather_rows_in_order(table, ids, ordered, oob, gather_order(ids, n, plan["shift"]))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gather_rows"] == 2
    assert torch.equal(ordered.view(torch.uint8), plain.view(torch.uint8))
    assert _untouched_around(ordered_buf, ordered) and _untouched_around(plain_buf, plain)
    want = gather_rows_reference(table.cpu(), ids.cpu(), oob)
    assert torch.equal(plain.cpu().view(torch.uint8), want.view(torch.uint8))


@pytest.mark.chip
@pytest.mark.parametrize("width, ordered", [(602, True), (256, True), (512, True)])
def test_wrapper_orders_the_cells_chunks_on_the_card(card, width, ordered):
    table = _table(N_NODES, width, torch.float32, card)
    ids = exact_ids(CHUNK, seed=4).to(card)
    kernels.reset_launch_counts()
    got = gather_rows(table, ids, "zero")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["gather_order"], counts["gather_rows"]) == (int(ordered), 1)
    assert torch.equal(got.cpu(), gather_rows_reference(table.cpu(), ids.cpu(), "zero"))


@pytest.mark.chip
@pytest.mark.parametrize("q", [512, 12_800])
def test_wrapper_keeps_the_training_gathers_in_output_order_on_the_card(card, q):
    table = _table(N_NODES, 602, torch.bfloat16, card)
    ids = torch.randint(0, N_NODES, (q,), dtype=torch.int32, device=card)
    kernels.reset_launch_counts()
    got = gather_rows(table, ids)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {k: int(k == "gather_rows") for k in kernels.KERNELS}
    assert torch.equal(got, table[ids.long()])
