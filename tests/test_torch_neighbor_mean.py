"""The degree-masked neighbour mean (``kernels/neighbor_mean.py``), the exact
pass's mean, gcn and mean_pool summary.

On the CPU: its plain version against the expressions it replaced in
``nn/full_graph.py`` (torch's sum over the neighbours, the division by the
clamped degree, the degree-0 self-loop), its plain version in the kernel's order,
its plan, its argument checks, its counter and its source note, and the
exact passes against the parent's summary patched in. The tests marked
``chip`` hold the CUDA kernel against the plain version in its order on
the card; they skip without one. This file imports no JAX, so on the card it
runs alone::

    python3 -m pytest tests/test_torch_neighbor_mean.py --noconftest -m chip -q
"""

import math
import os

import pytest
import torch

from tpu_sage_torch import kernels
from tpu_sage_torch.kernels import _build
from tpu_sage_torch.kernels import neighbor_mean as nmean
from tpu_sage_torch.kernels.neighbor_mean import (check_args, neighbor_mean, neighbor_mean_ordered,
                                                  neighbor_mean_plan, neighbor_mean_reference)
from tpu_sage_torch.nn import full_graph

N_NODES, FEAT_DIM, DEGREE, HIDDEN, CHUNK = 232_965, 602, 128, 128, 4096  # the mean cell
REL_TOL = 2e-6  # the kernel's order of the f32 sum against torch's reduction


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here; this test runs on the card")
    return torch.device("cuda", 0)


def parents_summary(model, agg, neigh, d_chunk, h_self, src_self):
    """``nn/full_graph.py::_chunk_summary`` as it was before the kernel."""
    agg_name = model.aggregator_class
    mask = torch.arange(neigh.shape[1], device=neigh.device) < d_chunk[:, None]
    isolated = d_chunk[:, None] == 0
    dtype = h_self.dtype
    denom = d_chunk.clamp_min(1)[:, None].to(dtype)
    if agg_name in ("mean", "gcn"):
        summary = neigh.sum(dim=1, dtype=torch.float32).to(dtype) / denom
        summary = torch.where(isolated, h_self, summary)
        if agg_name == "gcn":
            summary = torch.where(isolated, h_self, (summary * denom + h_self) / (denom + 1.0))
    elif agg_name == "max_pool":
        summary = full_graph.neighbor_max(neigh, d_chunk, src_self)
    elif agg_name == "mean_pool":
        summary = torch.where(isolated, src_self, neigh.sum(dim=1) / denom)
    else:
        q = full_graph._dense(h_self, agg.att_q.kernel)
        qk = q @ agg.att_k.kernel.T
        x = neigh.to(torch.promote_types(neigh.dtype, qk.dtype))
        scores = (x @ qk[:, :, None])[..., 0] / math.sqrt(q.shape[-1])
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        alpha = torch.softmax(scores, dim=-1)
        summary = torch.where(isolated, h_self, (alpha[:, None, :] @ x)[:, 0])
    return summary


def parents_mean(neigh, degrees, self_rows, degree_dtype=None):
    """The parent's mean (and gcn) branch, or with ``degree_dtype`` its
    mean_pool branch (the degree in ``h_self``'s dtype)."""
    denom = degrees.clamp_min(1)[:, None].to(degree_dtype or neigh.dtype)
    isolated = degrees[:, None] == 0
    if degree_dtype is None:
        summary = neigh.sum(dim=1, dtype=torch.float32).to(neigh.dtype) / denom
        return torch.where(isolated, self_rows, summary)
    return torch.where(isolated, self_rows, neigh.sum(dim=1) / denom)


def ragged(rows, max_degree, width, dtype, seed=0, device="cpu"):
    """``(neigh, degrees, self_rows)``: degrees 0 and ``max_degree`` among
    random ones, padding columns zero (as the masked gather leaves them)."""
    g = torch.Generator().manual_seed(seed)
    degrees = torch.randint(0, max_degree + 1, (rows,), generator=g, dtype=torch.int32)
    degrees[:3] = torch.tensor([0, max_degree, 1], dtype=torch.int32)[:rows]
    neigh = torch.randn((rows, max_degree, width), generator=g)
    past = torch.arange(max_degree) >= degrees[:, None].long()
    neigh = neigh.masked_fill(past[:, :, None], 0.0).to(dtype)
    self_rows = torch.randn((rows, width), generator=g).to(dtype)
    return neigh.to(device), degrees.to(device), self_rows.to(device)


# ---- CPU -------------------------------------------------------------------

@pytest.mark.parametrize("branch", ["mean", "mean_pool"])
@pytest.mark.parametrize("width", [602, 256, 13])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reference_equals_the_parents_expression(dtype, width, branch):
    neigh, degrees, self_rows = ragged(24, 128, width, dtype)
    degree_dtype = torch.bfloat16 if branch == "mean_pool" else None
    if branch == "mean_pool":  # the pool's table is f32; h_self (the degree's dtype) bf16
        neigh, self_rows = neigh.float(), self_rows.float()
    want = parents_mean(neigh, degrees, self_rows, degree_dtype)
    got = neighbor_mean_reference(neigh, degrees, self_rows, degree_dtype)
    assert got.dtype == want.dtype == neigh.dtype and torch.equal(got, want)
    assert torch.equal(neighbor_mean(neigh, degrees, self_rows, degree_dtype), want)  # CPU


@pytest.mark.parametrize("width,groups", [(602, 4), (13, 16), (20, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ordered_version_adds_in_the_kernels_groups_and_never_reads_the_padding(dtype, width,
                                                                               groups):
    neigh, degrees, self_rows = ragged(40, 40, width, dtype, seed=1)
    assert nmean._plan(neigh, self_rows)["groups"] == groups
    past = torch.arange(40) >= degrees[:, None].long()
    loud = neigh.masked_fill(past[:, :, None], float("nan"))
    got = neighbor_mean_ordered(loud, degrees, self_rows)
    assert got.dtype == dtype and torch.equal(got, neighbor_mean_ordered(neigh, degrees,
                                                                         self_rows))
    for v in range(40):
        d = int(degrees[v])
        if d == 0:
            assert torch.equal(got[v], self_rows[v])
            continue
        sums = []
        for g in range(groups):  # every groups-th neighbour from g, in order
            acc = torch.zeros(width)
            for j in range(g, d, groups):
                acc = acc + neigh[v, j].float()
            sums.append(acc)
        total = sums[0]
        for acc in sums[1:]:  # then the groups in order
            total = total + acc
        assert torch.equal(got[v], total.to(dtype) / torch.tensor(float(d)).to(dtype))
    torch.testing.assert_close(got.float(), neighbor_mean_reference(neigh, degrees,
                                                                    self_rows).float(),
                               rtol=2 ** -6 if dtype == torch.bfloat16 else REL_TOL, atol=1e-6)


def test_the_orders_agree_bitwise_where_every_sum_is_exact():
    neigh, degrees, self_rows = ragged(64, 32, 24, torch.float32, seed=2)
    neigh = (neigh * 8).round() / 8
    assert torch.equal(neighbor_mean_ordered(neigh, degrees, self_rows),
                       neighbor_mean_reference(neigh, degrees, self_rows))


@pytest.mark.parametrize("degree_dtype", [torch.float32, torch.bfloat16])
def test_the_degree_divides_in_its_dtype(degree_dtype):
    """bf16 holds integers exactly only up to 256: 257 divides as 256."""
    neigh = torch.zeros((3, 4, 2))
    neigh[:2, 0] = 257.0  # a negative degree has no true column: its row is zero
    degrees = torch.tensor([257, 300, -3], dtype=torch.int32)
    denom = torch.tensor([256.0 if degree_dtype == torch.bfloat16 else 257.0, 300.0, 1.0])
    want = (torch.tensor([257.0, 257.0, 0.0]) / denom)[:, None].expand(3, 2)
    for fn in (neighbor_mean_reference, neighbor_mean_ordered):
        got = fn(neigh, degrees, torch.ones((3, 2)), degree_dtype)
        assert torch.equal(got, want), fn.__name__


def test_a_strided_view_takes_the_values_of_its_copy():
    """The benchmark's ``half_the_neighbours`` fault passes ``neigh[:, :keep]``."""
    neigh, degrees, self_rows = ragged(32, 16, 24, torch.float32, seed=3)
    keep = 8
    view, deg = neigh[:, :keep], degrees.clamp(max=keep)
    assert not view.is_contiguous() and view.stride(2) == 1
    for fn in (neighbor_mean_reference, neighbor_mean_ordered):
        assert torch.equal(fn(view, deg, self_rows), fn(view.contiguous(), deg, self_rows))
    check_args(view, deg, self_rows, torch.float32)  # the card takes the view without a copy


@pytest.mark.parametrize("row_bytes,elem,offsets,plan", [
    (1024, 4, (0, 131072, 1024, 1024), dict(word=16, lanes=64, groups=4, k=1)),  # layer 1
    (2408, 4, (0, 308224, 2408, 2408), dict(word=8, lanes=64, groups=4, k=5)),   # layer 0
    (1204, 2, (0, 154112, 1204, 1204), dict(word=4, lanes=64, groups=4, k=5)),   # bf16 602
    (52, 4, (0, 6656, 52), dict(word=4, lanes=16, groups=16, k=1)),             # 13-wide f32
    (26, 2, (0, 3328, 26), dict(word=2, lanes=16, groups=16, k=1)),             # 13-wide bf16
    (2048, 4, (8, 2048), dict(word=8, lanes=64, groups=4, k=4)),                # a base off 8
    (2048, 4, (4, 2048), dict(word=4, lanes=64, groups=4, k=8)),                # off 4
    (16384, 4, (0, 16384), dict(word=16, lanes=64, groups=4, k=4)),             # 4 turns
    (2, 2, (0, 2), dict(word=2, lanes=1, groups=256, k=1)),                     # one bf16
])
def test_plan(row_bytes, elem, offsets, plan):
    got = neighbor_mean_plan(row_bytes, elem, *offsets)
    assert got == plan
    assert got["lanes"] * got["groups"] == nmean.THREADS
    assert got["k"] * got["word"] <= nmean.THREAD_BYTES and got["k"] <= nmean.MAX_WORDS
    assert got["k"] == 1 or got["lanes"] == nmean.LANES  # the kernel's immediate offsets


def test_plan_of_a_view_follows_its_strides():
    neigh = torch.zeros((4, 16, 6))  # 24-byte rows: 8-byte words
    assert neighbor_mean_plan(24, 4, *(s * 4 for s in neigh.stride()[:2]))["word"] == 8
    view = torch.zeros((4, 16, 8))[:, 1:]  # offset by one 32-byte row: 16-byte words
    assert neighbor_mean_plan(32, 4, *(s * 4 for s in view.stride()[:2]),
                              view.storage_offset() * 4 % 16)["word"] == 16
    view = torch.zeros((4, 16, 6))[:, 1:, :4]  # 16-byte rows 24 bytes apart: 8-byte words
    assert neighbor_mean_plan(16, 4, *(s * 4 for s in view.stride()[:2]),
                              view.storage_offset() * 4 % 16)["word"] == 8


@pytest.mark.parametrize("bad,error,match", [
    (dict(neigh=torch.zeros((4, 3, 5), dtype=torch.float64)), TypeError, "neigh has dtype"),
    (dict(neigh=torch.zeros((4, 15))), ValueError, "must be \\(rows, max_degree"),
    (dict(neigh=torch.zeros((4, 0, 5))), ValueError, "max_degree >= 1"),
    (dict(degrees=torch.zeros(4, dtype=torch.int64)), TypeError, "degrees has dtype"),
    (dict(degrees=torch.zeros(5, dtype=torch.int32)), ValueError, "degrees must be"),
    (dict(degrees=torch.zeros(8, dtype=torch.int32)[::2]), ValueError, "degrees must be"),
    (dict(self_rows=torch.zeros((4, 5), dtype=torch.bfloat16)), TypeError, "self_rows has"),
    (dict(self_rows=torch.zeros((4, 6))), ValueError, "self_rows must be"),
    (dict(neigh=torch.zeros((4, 5, 3)).transpose(1, 2)), ValueError, "contiguous"),
    (dict(self_rows=torch.zeros((5, 4)).t()), ValueError, "contiguous"),
    (dict(degree_dtype=torch.float64), TypeError, "degree_dtype"),
    (dict(neigh=torch.zeros((4, 3, 5), dtype=torch.bfloat16),
          self_rows=torch.zeros((4, 5), dtype=torch.bfloat16)), TypeError, "degree_dtype"),
])
def test_check_args_refuses_what_the_kernel_does_not_take(bad, error, match):
    args = dict(neigh=torch.zeros((4, 3, 5)), degrees=torch.zeros(4, dtype=torch.int32),
                self_rows=torch.zeros((4, 5)), degree_dtype=torch.float32)
    check_args(**args)
    check_args(**{**args, "degree_dtype": torch.bfloat16})  # f32 quotient of a bf16 degree
    args.update(bad)
    with pytest.raises(error, match=match):
        check_args(**args)


def test_launch_counts_list_the_kernel_and_the_plain_versions_launch_nothing():
    assert kernels.KERNELS["neighbor_mean"][:2] == (nmean, "neighbor_mean")
    kernels.reset_launch_counts()
    neighbor_mean(*ragged(4, 3, 5, torch.float32))
    neighbor_mean_ordered(*ragged(4, 3, 5, torch.float32))
    assert kernels.launch_counts()["neighbor_mean"] == 0
    _build.counts["neighbor_mean"] = 7
    assert kernels.launch_counts()["neighbor_mean"] == 7
    kernels.reset_launch_counts()
    assert _build.counts["neighbor_mean"] == 0


def test_the_source_notes_what_it_replaces_its_bound_and_its_entry():
    src, lib = _build.library_path("neighbor_mean")
    text = open(src).read()
    for needle in ("Replaces no Pallas kernel", "tpu_sage/nn/full_graph.py",
                   "Bound on the H100: bytes", 'extern "C" int tsg_neighbor_mean(',
                   "cudaGetLastError()", "__ldcs", "__fdiv_rn",
                   "kernels/neighbor_mean.py::neighbor_mean_plan",
                   "kernels/neighbor_mean.py::neighbor_mean_ordered"):
        assert needle in text, needle
    assert "neighbor_mean" in _build.SOURCES
    assert os.path.basename(lib).startswith("libneighbor_mean_")


def _model(aggregator, n_nodes, n_classes, feat_dim, hidden, dims):
    from tpu_sage_torch.train.trainer import TrainConfig, build_model

    cfg = TrainConfig(n_train_samples=(25, 10), n_val_samples=(25, 10), output_dims=dims,
                      aggregator_class=aggregator, agg_hidden_dim=hidden)
    model = build_model(cfg, n_nodes, n_classes, feat_dim)
    model.reset_parameters(torch.Generator().manual_seed(6))
    return model


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [64, 37])
@pytest.mark.parametrize("aggregator", ["mean", "gcn", "mean_pool"])
def test_exact_pass_equals_the_pass_with_the_parents_summary(monkeypatch, aggregator, chunk,
                                                             dtype):
    from tpu_sage_torch.data.synthetic import sbm_store

    store = sbm_store(n_nodes=300, n_classes=4, feat_dim=12, seed=5)
    store.degrees[::7] = 0
    model = _model(aggregator, store.n_nodes, store.n_classes, store.feat_dim, 24, (16, 8))
    graph = store.to_device(train=False, dtype=dtype, device="cpu")
    got = full_graph.embed_all_nodes(model, graph, chunk=chunk, with_head=True)
    monkeypatch.setattr(full_graph, "_chunk_summary", parents_summary)
    want = full_graph.embed_all_nodes(model, graph, chunk=chunk, with_head=True)
    assert torch.isfinite(got).all() and torch.equal(got, want)


# ---- on the card -------------------------------------------------------------

def _card_case(name, device):
    """``(neigh, degrees, self_rows, degree_dtype)`` on the card for one named case."""
    full = torch.full((CHUNK,), DEGREE, dtype=torch.int32, device=device)
    if name == "layer-0 chunk f32":  # every degree full, as in the cell
        g = torch.Generator(device=device).manual_seed(10)
        return (torch.randn((CHUNK, DEGREE, FEAT_DIM), generator=g, device=device), full,
                torch.randn((CHUNK, FEAT_DIM), generator=g, device=device), None)
    if name == "layer-1 chunk f32":
        g = torch.Generator(device=device).manual_seed(11)
        return (torch.relu(torch.randn((CHUNK, DEGREE, 2 * HIDDEN), generator=g,
                                       device=device)), full,
                torch.randn((CHUNK, 2 * HIDDEN), generator=g, device=device), None)
    if name == "602 wide bf16":
        return (*ragged(CHUNK, DEGREE, FEAT_DIM, torch.bfloat16, seed=12, device=device), None)
    if name == "ragged last chunk":
        return (*ragged(N_NODES % CHUNK, DEGREE, FEAT_DIM, torch.float32, seed=13,
                        device=device), None)
    if name == "degrees 0-128":
        return (*ragged(CHUNK, DEGREE, 2 * HIDDEN, torch.float32, seed=14, device=device), None)
    if name == "strided view":
        neigh, degrees, self_rows = ragged(CHUNK, DEGREE, 2 * HIDDEN, torch.float32, seed=15,
                                           device=device)
        return neigh[:, :DEGREE // 2], degrees.clamp(max=DEGREE // 2), self_rows, None
    if name == "13 wide, element loads":
        return (*ragged(1000, 40, 13, torch.float32, seed=16, device=device), None)
    if name == "13 wide bf16, element loads":
        return (*ragged(1000, 40, 13, torch.bfloat16, seed=17, device=device), None)
    if name == "mean_pool: f32 rows, bf16 degrees past 256":
        neigh, degrees, self_rows = ragged(2000, 64, 512, torch.float32, seed=18, device=device)
        degrees[degrees > 0] += 200  # 201-264: bf16 rounds 257-264 off the integer
        return neigh, degrees, self_rows, torch.bfloat16
    if name == "self rows strided, 4,096 wide":
        neigh, degrees, _ = ragged(300, 9, 4096, torch.float32, seed=19, device=device)
        return neigh, degrees, torch.randn((300, 2 * 4096), device=device)[:, 4096:], None
    raise KeyError(name)


CARD_CASES = ["layer-0 chunk f32", "layer-1 chunk f32", "602 wide bf16", "ragged last chunk",
              "degrees 0-128", "strided view", "13 wide, element loads",
              "13 wide bf16, element loads", "mean_pool: f32 rows, bf16 degrees past 256",
              "self rows strided, 4,096 wide"]


@pytest.mark.chip
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_equals_its_neighbour_order_plain_version_on_the_card(card, case):
    neigh, degrees, self_rows, degree_dtype = _card_case(case, card)
    kernels.reset_launch_counts()
    got = neighbor_mean(neigh, degrees, self_rows, degree_dtype)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["neighbor_mean"] == 1
    want = neighbor_mean_ordered(neigh, degrees, self_rows, degree_dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.chip
@pytest.mark.parametrize("case", ["layer-0 chunk f32", "layer-1 chunk f32", "degrees 0-128"])
def test_kernel_is_within_f32_rounding_of_the_parents_expression_on_the_card(card, case):
    neigh, degrees, self_rows, _ = _card_case(case, card)
    got = neighbor_mean(neigh, degrees, self_rows)
    want = parents_mean(neigh, degrees, self_rows)
    # the mean of |x|: a sum's rounding is relative to the sum of its terms' sizes
    scale = neigh.abs().sum(dim=1) / degrees.clamp_min(1)[:, None]
    assert torch.all((got - want).abs() <= REL_TOL * scale)


def _cell_graph(device, seed=0):
    from tpu_sage_torch.graph.graph_data import DeviceGraph

    g = torch.Generator(device=device).manual_seed(seed)
    adj = torch.randint(0, N_NODES, (N_NODES, DEGREE), generator=g, device=device,
                        dtype=torch.int32)
    feats = torch.randn((N_NODES, FEAT_DIM), generator=g, device=device)
    return DeviceGraph(adj=adj, degrees=torch.full((N_NODES,), DEGREE, dtype=torch.int32,
                                                   device=device),
                       feats=feats, targets=torch.zeros(N_NODES, dtype=torch.int32,
                                                        device=device))


def _cell_model(aggregator, device):
    return _model(aggregator, N_NODES, 41, FEAT_DIM, 512, (HIDDEN, HIDDEN)).to(device)


@pytest.mark.chip
def test_mean_pass_on_the_card_equals_the_pass_with_the_plain_version(card, monkeypatch):
    graph = _cell_graph(card)
    model = _cell_model("mean", card)
    got = full_graph.embed_all_nodes(model, graph, chunk=CHUNK)
    monkeypatch.setattr(full_graph, "neighbor_mean", neighbor_mean_ordered)
    want = full_graph.embed_all_nodes(model, graph, chunk=CHUNK)
    assert torch.isfinite(got).all() and torch.equal(got, want)


@pytest.mark.chip
@pytest.mark.parametrize("aggregator,mean,max_", [("mean", 114, 0), ("max_pool", 0, 114)])
def test_launches_a_pass_at_the_cells_shapes(card, aggregator, mean, max_):
    """57 chunks of 4,096 nodes × 2 layers; max pool takes ``neighbor_max``."""
    graph = _cell_graph(card)
    model = _cell_model(aggregator, card)
    kernels.reset_launch_counts()
    full_graph.embed_all_nodes(model, graph, chunk=CHUNK)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["neighbor_mean"], counts["neighbor_max"]) == (mean, max_)
    assert counts["gather_rows"] == 114
