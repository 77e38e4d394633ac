"""The fused column pick (``kernels/select.py::select_hop``) against the JAX
package's compositions, on the CPU.

``select_hop`` is the column arithmetic, the pick and the degree-0 self-loop
of a hop whose rows are already fetched: the partitioned hop
(``tpu_sage/dist/train.py::sample_level_distributed``, dense adjacency ‖
degree rows and the CSR pair view), the CSR pick at the owner
(``tpu_sage/dist/halo.py::dist_sample_csr_owner_select``) and the packed
sampler (``tpu_sage/sample/sampler.py::sample_tree_packed``). Its plain
version must be bitwise each of them for the same rows and uniforms; the
world-1 checks run in this process (a gloo group of one rank against a
one-device JAX mesh).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tpu_sage.data.synthetic import sbm_store as j_sbm_store
from tpu_sage.dist import halo as jhalo
from tpu_sage.dist import train as jtrain
from tpu_sage.dist.mesh import make_mesh
from tpu_sage.sample import sampler as jsampler
from tpu_sage_torch import kernels
from tpu_sage_torch.dist import halo, mesh
from tpu_sage_torch.dist.train import sample_level_distributed
from tpu_sage_torch.kernels import _build
from tpu_sage_torch.kernels.select import (hop_columns, select_columns_reference, select_hop,
                                           select_hop_reference)
from tpu_sage_torch.sample import csr
from tpu_sage_torch.sample.sampler import pack_adjacency, sample_tree_packed

FANOUT = 5


def _t(a, dtype=torch.int32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _store(seed):
    """An SBM store with isolated nodes (degree 0, self-padded rows), the
    last node among them."""
    store = j_sbm_store(n_nodes=120, n_classes=3, feat_dim=4, avg_degree=3, max_degree=9,
                        seed=seed)
    iso = np.r_[np.arange(0, 120, 11), 119]
    store.train_degrees[iso] = 0
    store.train_adj[iso] = iso[:, None]
    return store.train_adj.astype(np.int32), store.train_degrees.astype(np.int32)


def _frontier(seed, n=120, q=48):
    ids = np.random.default_rng(seed).integers(0, n, size=q).astype(np.int32)
    ids[:3] = [0, 11, 119]  # isolated
    return ids


def _csr_arrays(adj, deg):
    window = int(deg.max())
    indptr, indices = csr.csr_from_padded(adj, deg)
    return indptr, csr.pad_indices_for_window(indices, window), window


@pytest.fixture(scope="module")
def mesh1(eight_devices):
    return make_mesh(n_devices=1)


def _jmap(mesh1, fn, *arrays):
    spec = P("data")
    return jax.jit(shard_map(fn, mesh=mesh1, in_specs=(spec,) * len(arrays), out_specs=spec,
                             check_vma=False))(*arrays)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("form", ["dense", "pair"])
def test_select_hop_reference_is_the_jax_partitioned_hop_on_injected_rows(seed, form):
    """The JAX hop (``tpu_sage/dist/train.py:587-608``) fed the rows through
    its ``gather`` seam, and the port's hop fed the same rows and the
    uniforms JAX draws from the key: the same neighbors, the degree-0
    self-loop included; the port's hop is ``select_hop`` on views of the
    rows, and ``select_hop_reference`` is the composition it replaced."""
    adj, deg = _store(seed)
    ids = _frontier(seed)
    if form == "dense":
        rows = np.concatenate([adj, deg[:, None]], 1)[ids]
        window = 0
    else:
        indptr, indices, window = _csr_arrays(adj, deg)
        rows = halo.CSRPairRows(_t(indptr), _t(indices), _t(deg), window).rows(_t(ids)).numpy()
    key = jax.random.key(seed)
    want, _ = jtrain.sample_level_distributed(
        key, jnp.asarray(rows), jnp.asarray(ids), FANOUT, "data",
        gather=lambda t, i, a: (jnp.asarray(rows), jnp.zeros((), jnp.int32)),
        pair_window=window)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (ids.shape[0], FANOUT))))
    got, ovf = sample_level_distributed(
        _t(rows), _t(ids), FANOUT, gather=lambda t, i: (_t(rows), torch.zeros((), dtype=torch.int32)),
        pair_window=window, u=u)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(ovf) == 0
    r = _t(rows)
    if form == "dense":
        view, r_deg, shift = r[:, :-1], r[:, -1], None
    else:
        view, r_deg, shift = r[:, :2 * window], r[:, 2 * window + 1], r[:, 2 * window]
    cols = hop_columns(u, r_deg.clamp_min(1))
    if shift is not None:
        cols = shift[:, None] + cols
    old = torch.where(r_deg[:, None] == 0, _t(ids)[:, None], select_columns_reference(view, cols))
    fused = select_hop(view, r_deg, u, shift=shift, ids=_t(ids))
    assert torch.equal(fused, old) and torch.equal(fused.reshape(-1), got)
    assert (fused[:3] == _t(ids[:3])[:, None]).all()  # isolated nodes self-loop


@pytest.mark.parametrize("form", ["dense", "pair"])
def test_the_world_1_partitioned_hop_is_bitwise_jax(mesh1, form):
    """At world 1, the port's hop through its exact exchange (a gloo group
    of one rank in this process) against the JAX hop through its exchange
    on a one-device mesh, for the same uniforms, on the dense adjacency ‖
    degree table and on the CSR pair view."""
    adj, deg = _store(3)
    ids = _frontier(3)
    key = jax.random.key(4)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (ids.shape[0], FANOUT))))
    if form == "dense":
        table = np.concatenate([adj, deg[:, None]], 1)
        window = 0
        jtable = (jnp.asarray(table),)
        jview = lambda t: t  # noqa: E731
        view = _t(table)
    else:
        indptr, indices, window = _csr_arrays(adj, deg)
        jtable = (jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(deg))
        jview = lambda ip, ind, dg: jhalo.CSRPairRows(ip, ind, dg, window)  # noqa: E731
        view = halo.CSRPairRows(_t(indptr), _t(indices), _t(deg), window)
    want = _jmap(mesh1, lambda *a: jtrain.sample_level_distributed(
        key, jview(*a[:-1]), a[-1], FANOUT, "data", pair_window=window)[0],
        *jtable, jnp.asarray(ids))
    kernels.reset_launch_counts()
    got, ovf = mesh.run_in_process(
        lambda: sample_level_distributed(view, _t(ids), FANOUT, pair_window=window, u=u), "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(ovf) == 0
    assert sum(kernels.launch_counts().values()) == 0  # CPU tensors launch nothing


def test_select_hop_reference_is_the_jax_owner_select_pick(mesh1):
    """``dist_sample_csr_owner_select`` at world 1: the port's (its pick one
    ``select_hop`` with the pair's offset as the shift, no ids: the owner
    answers values ‖ degree) against the JAX package's, bitwise, degree-0
    rows included; and the requester's self-loop on top gives the
    single-device CSR hop."""
    adj, deg = _store(5)
    indptr, indices, window = _csr_arrays(adj, deg)
    ids = _frontier(5)
    u = np.array(jax.random.uniform(jax.random.key(6), (ids.shape[0], FANOUT)))
    want = _jmap(mesh1, lambda ip, ind, dg, i, uu: jhalo.dist_sample_csr_owner_select(
        ip, ind, dg, window, i, uu, "data"), jnp.asarray(indptr), jnp.asarray(indices),
        jnp.asarray(deg), jnp.asarray(ids), jnp.asarray(u))
    got = mesh.run_in_process(lambda: halo.dist_sample_csr_owner_select(
        _t(indptr), _t(indices), _t(deg), window, _t(ids), torch.from_numpy(u)), "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:3, -1] == 0).all()
    pair, off, _ = csr.gather_window_pair(_t(indptr), _t(indices), _t(ids), window)
    r_deg = _t(deg[ids])
    picked = select_hop(pair, r_deg, torch.from_numpy(u), shift=off)
    assert torch.equal(picked, got[:, :-1])
    hop = csr.uniform_neighbor_sample_csr(_t(indptr), _t(indices), _t(deg), _t(ids), FANOUT,
                                          u=torch.from_numpy(u))
    assert torch.equal(select_hop(pair, r_deg, torch.from_numpy(u), shift=off, ids=_t(ids)), hop)


@pytest.mark.parametrize("seed", [7, 8])
def test_select_hop_reference_is_the_jax_packed_hop(seed):
    """Each hop of the JAX package's ``sample_tree_packed`` (one gather of
    adjacency ‖ degree, the column arithmetic, the select) against
    ``select_hop_reference`` on the same rows and uniforms, degree 0 picking
    column 0 (the self pad), and the port's packed tree against JAX's."""
    adj, deg = _store(seed)
    ids = _frontier(seed)
    fanouts = (4, 3)
    key = jax.random.key(seed)
    j_packed = jsampler.pack_adjacency(jnp.asarray(adj), jnp.asarray(deg))
    want = jsampler.sample_tree_packed(key, j_packed, jnp.asarray(ids), fanouts)
    packed = pack_adjacency(_t(adj), _t(deg))
    us, k = [], key
    for level, f in enumerate(fanouts):
        k, sub = jax.random.split(k)
        u = torch.from_numpy(np.array(jax.random.uniform(sub, (want[level].shape[0], f))))
        us.append(u)
        rows = packed[_t(want[level]).long()]
        got = select_hop_reference(rows[:, :-1], rows[:, -1], u)
        np.testing.assert_array_equal(got.reshape(-1).numpy(), np.asarray(want[level + 1]))
        assert torch.equal(select_hop(rows[:, :-1], rows[:, -1], u), got)
    ours = sample_tree_packed(packed, _t(ids), fanouts, us=us)
    for a, b in zip(ours, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (ours[1].view(-1, 4)[:3] == _t(ids[:3])[:, None]).all()  # the self pad


def test_select_hop_edges_match_the_composition():
    """Columns out of range (degrees above the row width), shifts that move
    the column out of range or wrap int32, u at 0 and one ulp below 1,
    degrees 0 and negative, with and without ids: bitwise the composition."""
    g = torch.Generator().manual_seed(0)
    b, d, k = 64, 6, 9
    rows = torch.randint(-5, 100, (b, d + 3), generator=g, dtype=torch.int32)[:, 1:d + 1]
    deg = torch.randint(-2, d + 9, (b,), generator=g, dtype=torch.int32)
    deg[:4] = 0
    shift = torch.randint(-4, 4, (b,), generator=g, dtype=torch.int32)
    shift[4:6] = 2**31 - 3
    ids = torch.randint(0, 1000, (b,), generator=g, dtype=torch.int32)
    u = torch.rand((b, k), generator=g)
    u[:, 0], u[:, 1] = 0.0, float(np.nextafter(np.float32(1), np.float32(0)))
    for s in (None, shift):
        for i in (None, ids):
            cols = hop_columns(u, deg.clamp_min(1))
            if s is not None:
                cols = s[:, None] + cols
            want = select_columns_reference(rows, cols)
            if i is not None:
                want = torch.where(deg[:, None] == 0, i[:, None], want)
            assert torch.equal(select_hop(rows, deg, u, shift=s, ids=i), want)
    assert (select_hop(rows, deg, u, shift=shift)[4:6] == 0).all()  # wrapped negative


def test_select_hop_checks_its_arguments_and_counts_only_launches():
    rows = torch.zeros(4, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="u \\(B, K\\)"):
        select_hop(rows, rows[:, 0], torch.zeros(3, 2))
    with pytest.raises(ValueError, match="deg must be"):
        select_hop(rows, rows[:3, 0], torch.zeros(4, 2))
    with pytest.raises(ValueError, match="ids must be"):
        select_hop(rows, rows[:, 0], torch.zeros(4, 2), ids=torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        select_hop(rows.to("meta"), rows[:, 0].to("meta"), torch.zeros(4, 2, device="meta"))
    kernels.reset_launch_counts()
    select_hop(rows, rows[:, 0], torch.zeros(4, 2), shift=rows[:, 1], ids=rows[:, 2].clone())
    assert kernels.launch_counts()["select_hop"] == 0
    assert kernels.KERNELS["select_hop"][:2] == (kernels.select, "select")


def test_select_source_notes_both_new_entry_points():
    text = open(_build.library_path("select")[0]).read()
    for entry in ("tsg_select_hop(", "tsg_sample_tree_csr("):
        assert f'extern "C" int {entry}' in text
    for needle in ("tpu_sage/dist/train.py:587-608", "tpu_sage/dist/halo.py:135-180",
                   "tpu_sage/sample/sampler.py:111-132", "sample_tree_csr",
                   "Leaves above 2^31 - 1 are refused", "Bound on the H100: bytes"):
        assert needle in text, needle
