"""The degree-masked neighbour max (``kernels/neighbor_max.py``), the exact
pass's max-pool summary.

On the CPU: its plain version against the expression it replaced in
``nn/full_graph.py`` (``masked_fill_`` of the padding columns with
``finfo.min``, ``amax``, the degree-0 self-loop), its plan, its argument
checks and its source note. The tests marked ``chip`` hold the CUDA kernel
against the plain version on the card; they skip without one. This file
imports no JAX, so on the card it runs alone::

    python3 -m pytest tests/test_torch_neighbor_max.py --noconftest -m chip -q
"""

import os

import pytest
import torch

from tpu_sage_torch import kernels
from tpu_sage_torch.kernels import _build
from tpu_sage_torch.kernels import neighbor_max as nm
from tpu_sage_torch.kernels.neighbor_max import (check_args, neighbor_max, neighbor_max_plan,
                                                 neighbor_max_reference)
from tpu_sage_torch.nn import full_graph

N_NODES, FEAT_DIM, DEGREE, HIDDEN, CHUNK = 232_965, 602, 128, 512, 4096  # the max-pool cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here; this test runs on the card")
    return torch.device("cuda", 0)


def parents_expression(neigh, degrees, self_rows):
    """The max-pool branch of ``_chunk_summary`` before the kernel, on a copy."""
    neigh = neigh.clone()
    mask = torch.arange(neigh.shape[1], device=neigh.device) < degrees[:, None]
    isolated = degrees[:, None] == 0
    neigh.masked_fill_(~mask[:, :, None], torch.finfo(neigh.dtype).min)
    return torch.where(isolated, self_rows, neigh.amax(dim=1))


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


def nan_equal(a, b):
    """Equal values, NaN where the other has NaN (``torch.equal`` calls NaN unequal)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)))


# ---- CPU -------------------------------------------------------------------

@pytest.mark.parametrize("width", [512, 128, 13])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reference_equals_the_parents_expression(dtype, width):
    neigh, degrees, self_rows = ragged(64, 16, width, dtype)
    want = parents_expression(neigh, degrees, self_rows)
    got = neighbor_max_reference(neigh, degrees, self_rows)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(neighbor_max(neigh, degrees, self_rows), want)  # the CPU wrapper


@pytest.mark.parametrize("fill", [1e30, float("inf")])
def test_padding_columns_are_never_read(fill):
    neigh, degrees, self_rows = ragged(48, 12, 20, torch.float32, seed=1)
    past = torch.arange(12) >= degrees[:, None].long()
    loud = neigh.masked_fill(past[:, :, None], fill)
    got = neighbor_max_reference(loud, degrees, self_rows)
    assert torch.equal(got, parents_expression(neigh, degrees, self_rows))
    for v in range(48):
        d = int(degrees[v])
        want = self_rows[v] if d == 0 else neigh[v, :d].amax(0)
        assert torch.equal(got[v], want)


def test_a_node_with_padding_starts_at_finfo_min_and_a_full_one_at_minus_inf():
    """The masked form's value where every true neighbour is -inf: finfo.min
    when padding columns take part in the max, -inf when none do."""
    for dtype in (torch.float32, torch.bfloat16):
        neigh = torch.full((2, 4, 3), float("-inf"), dtype=dtype)
        degrees = torch.tensor([2, 4], dtype=torch.int32)
        got = neighbor_max_reference(neigh, degrees, torch.zeros((2, 3), dtype=dtype))
        assert torch.equal(got[0], torch.full((3,), torch.finfo(dtype).min, dtype=dtype))
        assert torch.equal(got[1], torch.full((3,), float("-inf"), dtype=dtype))
        assert torch.equal(got, parents_expression(neigh, degrees, torch.zeros((2, 3),
                                                                              dtype=dtype)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nan_in_a_true_column_propagates_and_in_a_padding_column_does_not(dtype):
    neigh, degrees, self_rows = ragged(8, 6, 10, dtype, seed=2)
    degrees[3:] = torch.tensor([3, 3, 6, 0, 2], dtype=torch.int32)
    neigh[3, 1, 4] = float("nan")   # a true column
    neigh[4, 5, 4] = float("nan")   # padding (degree 3)
    neigh[5, 5, 0] = float("nan")   # the last true column of a full node
    neigh[6, 0, 2] = float("nan")   # a degree-0 node's padding
    got = neighbor_max_reference(neigh, degrees, self_rows)
    assert torch.isnan(got[3, 4]) and torch.isnan(got[5, 0])
    assert torch.isnan(got).sum() == 2
    assert nan_equal(got, parents_expression(neigh, degrees, self_rows))


def test_a_strided_view_takes_the_values_of_its_copy():
    """The benchmark's ``half_the_neighbours`` fault passes ``neigh[:, :keep]``."""
    neigh, degrees, self_rows = ragged(32, 16, 24, torch.float32, seed=3)
    keep = 8
    view, deg = neigh[:, :keep], degrees.clamp(max=keep)
    assert not view.is_contiguous() and view.stride(2) == 1
    got = neighbor_max_reference(view, deg, self_rows)
    assert torch.equal(got, neighbor_max_reference(view.contiguous(), deg, self_rows))
    assert torch.equal(got, parents_expression(view, deg, self_rows))
    check_args(view, deg, self_rows)  # the card takes the view without a copy


@pytest.mark.parametrize("row_bytes,elem,offsets,plan", [
    (2048, 4, (0, 262144, 2048, 2048), {"word": 16, "lanes": 128}),  # the cell's chunk
    (512, 4, (0, 65536, 512), {"word": 16, "lanes": 32}),            # 128-wide f32
    (1024, 2, (0, 131072, 1024), {"word": 16, "lanes": 64}),         # 512-wide bf16
    (2408, 4, (0, 2408), {"word": 4, "lanes": 256}),                 # 602-wide f32
    (52, 4, (0, 52), {"word": 4, "lanes": 16}),                      # 13-wide f32
    (2048, 4, (4, 2048), {"word": 4, "lanes": 256}),                 # a base off 16 bytes
    (8192, 4, (0, 8192), {"word": 16, "lanes": 256}),                # wider than 256 words
    (2, 2, (0, 2), {"word": 2, "lanes": 1}),                         # one bf16 a row
])
def test_plan(row_bytes, elem, offsets, plan):
    got = neighbor_max_plan(row_bytes, elem, *offsets)
    assert got == plan
    assert nm.THREADS % got["lanes"] == 0


def test_plan_of_a_view_follows_its_strides():
    neigh = torch.zeros((4, 16, 6))  # 24-byte rows: no 16-byte words
    assert neighbor_max_plan(24, 4, *(s * 4 for s in neigh.stride()[:2]))["word"] == 4
    neigh = torch.zeros((4, 16, 8))[:, 1:]  # offset by one 32-byte row: still aligned
    assert neighbor_max_plan(32, 4, *(s * 4 for s in neigh.stride()[:2]),
                             neigh.storage_offset() * 4 % 16)["word"] == 16


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
])
def test_check_args_refuses_what_the_kernel_does_not_take(bad, error, match):
    args = dict(neigh=torch.zeros((4, 3, 5)), degrees=torch.zeros(4, dtype=torch.int32),
                self_rows=torch.zeros((4, 5)))
    check_args(**args)
    args.update(bad)
    with pytest.raises(error, match=match):
        check_args(**args)


def test_launch_counts_list_the_kernel_and_the_plain_version_launches_nothing():
    assert kernels.KERNELS["neighbor_max"][:2] == (nm, "neighbor_max")
    kernels.reset_launch_counts()
    neighbor_max(*ragged(4, 3, 5, torch.float32))
    assert kernels.launch_counts()["neighbor_max"] == 0
    _build.counts["neighbor_max"] = 7
    assert kernels.launch_counts()["neighbor_max"] == 7
    kernels.reset_launch_counts()
    assert _build.counts["neighbor_max"] == 0


def test_the_source_notes_what_it_replaces_its_bound_and_its_entry():
    src, lib = _build.library_path("neighbor_max")
    text = open(src).read()
    for needle in ("Replaces no Pallas kernel", "tpu_sage/nn/full_graph.py",
                   "Bound on the H100: bytes", 'extern "C" int tsg_neighbor_max(',
                   "cudaGetLastError()", "__ldcs", "kernels/neighbor_max.py::neighbor_max_plan"):
        assert needle in text, needle
    assert "neighbor_max" in _build.SOURCES
    assert os.path.basename(lib).startswith("libneighbor_max_")


def _model(aggregator, n_nodes, n_classes, feat_dim, hidden, dims):
    from tpu_sage_torch.train.trainer import TrainConfig, build_model

    cfg = TrainConfig(n_train_samples=(25, 10), n_val_samples=(25, 10), output_dims=dims,
                      aggregator_class=aggregator, agg_hidden_dim=hidden)
    model = build_model(cfg, n_nodes, n_classes, feat_dim)
    model.reset_parameters(torch.Generator().manual_seed(6))
    return model


@pytest.mark.parametrize("chunk", [64, 37])
def test_max_pool_pass_equals_the_pass_with_the_parents_expression(monkeypatch, chunk):
    from tpu_sage_torch.data.synthetic import sbm_store

    store = sbm_store(n_nodes=300, n_classes=4, feat_dim=12, seed=5)
    store.degrees[::7] = 0
    model = _model("max_pool", store.n_nodes, store.n_classes, store.feat_dim, 24, (16, 8))
    graph = store.to_device(train=False, dtype=torch.float32, device="cpu")
    got = full_graph.embed_all_nodes(model, graph, chunk=chunk, with_head=True)
    monkeypatch.setattr(full_graph, "neighbor_max", parents_expression)
    want = full_graph.embed_all_nodes(model, graph, chunk=chunk, with_head=True)
    assert torch.equal(got, want)


# ---- on the card -------------------------------------------------------------

def _card_case(name, device):
    """``(neigh, degrees, self_rows)`` on the card for one named case."""
    if name == "cell chunk f32":  # every degree full, as in the cell
        neigh = torch.relu(torch.randn((CHUNK, DEGREE, HIDDEN), device=device))
        return (neigh, torch.full((CHUNK,), DEGREE, dtype=torch.int32, device=device),
                torch.relu(torch.randn((CHUNK, HIDDEN), device=device)))
    if name == "cell chunk bf16":
        return ragged(CHUNK, DEGREE, HIDDEN, torch.bfloat16, seed=11, device=device)
    if name == "ragged last chunk":
        return ragged(N_NODES % CHUNK, DEGREE, HIDDEN, torch.float32, seed=12, device=device)
    if name == "random degrees 0-128":
        return ragged(CHUNK, DEGREE, HIDDEN, torch.float32, seed=13, device=device)
    if name == "strided view":
        neigh, degrees, self_rows = ragged(CHUNK, DEGREE, HIDDEN, torch.float32, seed=14,
                                           device=device)
        return neigh[:, :DEGREE // 2], degrees.clamp(max=DEGREE // 2), self_rows
    if name == "13 wide, element loads":
        return ragged(1000, 40, 13, torch.float32, seed=15, device=device)
    if name == "602 wide bf16, element loads":
        return ragged(500, 33, 602, torch.bfloat16, seed=16, device=device)
    if name == "self rows strided, 4,096 wide":
        neigh, degrees, _ = ragged(300, 9, 4096, torch.float32, seed=17, device=device)
        return neigh, degrees, torch.randn((300, 2 * 4096), device=device)[:, 4096:]
    raise KeyError(name)


CARD_CASES = ["cell chunk f32", "cell chunk bf16", "ragged last chunk", "random degrees 0-128",
              "strided view", "13 wide, element loads", "602 wide bf16, element loads",
              "self rows strided, 4,096 wide"]


@pytest.mark.chip
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_equals_its_plain_version_on_the_card(card, case):
    neigh, degrees, self_rows = _card_case(case, card)
    kernels.reset_launch_counts()
    got = neighbor_max(neigh, degrees, self_rows)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["neighbor_max"] == 1
    want = neighbor_max_reference(neigh, degrees, self_rows)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.chip
def test_kernel_propagates_nan_as_amax_does_on_the_card(card):
    neigh, degrees, self_rows = ragged(64, 16, 512, torch.float32, seed=18, device=card)
    degrees[3:7] = torch.tensor([5, 5, 16, 0], dtype=torch.int32, device=card)
    neigh[3, 2, 100] = float("nan")
    neigh[4, 10, 100] = float("nan")
    neigh[5, 15, 7] = float("nan")
    got = neighbor_max(neigh, degrees, self_rows)
    assert nan_equal(got, neighbor_max_reference(neigh, degrees, self_rows))
    assert int(torch.isnan(got).sum()) == 2


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
    return _model(aggregator, N_NODES, 41, FEAT_DIM, HIDDEN, (128, 128)).to(device)


@pytest.mark.chip
def test_max_pool_pass_on_the_card_equals_the_pass_with_the_plain_version(card, monkeypatch):
    graph = _cell_graph(card)
    model = _cell_model("max_pool", card)
    got = full_graph.embed_all_nodes(model, graph, chunk=CHUNK)
    monkeypatch.setattr(full_graph, "neighbor_max", neighbor_max_reference)
    want = full_graph.embed_all_nodes(model, graph, chunk=CHUNK)
    assert torch.isfinite(got).all() and torch.equal(got, want)


@pytest.mark.chip
@pytest.mark.parametrize("aggregator,launches", [("max_pool", 114), ("mean", 0)])
def test_launches_a_pass_at_the_cells_shapes(card, aggregator, launches):
    """57 chunks of 4,096 nodes × 2 layers for max pool; the mean bypasses it."""
    graph = _cell_graph(card)
    model = _cell_model(aggregator, card)
    kernels.reset_launch_counts()
    full_graph.embed_all_nodes(model, graph, chunk=CHUNK)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["neighbor_max"] == launches
    assert counts["gather_rows"] == 114
