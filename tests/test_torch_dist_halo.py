"""The port's halo exchange (tpu_sage_torch/dist/halo.py) at 4 gloo ranks
against the JAX package's shard_map forms on 4 of the 8 CPU devices.

One group of ranks per module (tests/torch_dist_workers.py::halo_checks)
runs every check; each test holds one part of what the ranks returned
against JAX. Bitwise: exact, ring and pipelined gathers, bucketed rows and
which queries overflow, the CSR pair and aligned rows, the owner-select, the
distributed hops against the single-device sampler with the same uniforms.
To a tolerance: the pre-reduced fanout means, whose owners' partials the
port sums in rank order where JAX's psum_scatter takes its own (and, in the
ring, where XLA fuses the add into an FMA); each owner's partial alone is
bitwise JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tests import torch_dist_workers as W
from tpu_sage.data.synthetic import sbm_store as j_sbm_store
from tpu_sage.dist import halo as jhalo
from tpu_sage.dist.mesh import make_mesh
from tpu_sage.dist.partition import shard_graph_csr as j_shard_graph_csr
from tpu_sage.dist.train import make_gather_last as j_make_gather_last
from tpu_sage.sample.sampler import uniform_neighbor_sample as j_uniform_neighbor_sample
from tpu_sage_torch.kernels import gather_mean

WORLD = 4
TABLES = ["f32", "bf16", "int8"]
FRONTIER = 24  # ids per rank for the hops


@pytest.fixture(scope="module")
def mesh4(eight_devices):
    return make_mesh(n_devices=WORLD)


@pytest.fixture(scope="module")
def hop_inputs():
    store = W.hop_store()
    rng = np.random.default_rng(9)
    frontier = rng.integers(0, store.n_nodes, size=WORLD * FRONTIER).astype(np.int32)
    key = jax.random.key(7)
    u = np.asarray(jax.random.uniform(key, (WORLD * FRONTIER, W.FANOUT)))
    return frontier, u, key


@pytest.fixture(scope="module")
def port(tmp_path_factory, hop_inputs):
    out = tmp_path_factory.mktemp("halo")
    frontier, u, _ = hop_inputs
    np.savez(out / "inputs.npz", frontier=frontier, u=u)
    W.spawn_ranks(W.halo_checks, WORLD, str(out))
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _jmap(mesh, fn, *arrays, n_out=1):
    spec = P("data")
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,) * len(arrays),
                             out_specs=spec if n_out == 1 else (spec,) * n_out,
                             check_vma=False))(*arrays)


def _jax_table(name):
    tables, _, _ = W.halo_inputs(WORLD)
    t = jnp.asarray(tables[name])
    return t.astype(jnp.bfloat16) if name == "bf16" else t


def _ids(which=1):
    return jnp.asarray(W.halo_inputs(WORLD)[which].reshape(-1))


def _per_rank(port, key):
    return np.concatenate([port[r][key].float().numpy() for r in range(WORLD)])


@pytest.mark.parametrize("name", TABLES)
def test_exact_ring_and_pipelined_gathers_are_bitwise_jax(mesh4, port, name):
    table = _jax_table(name)
    ids, ids2 = _ids(1), _ids(2)
    want = np.asarray(table[ids].astype(jnp.float32))
    exact = _jmap(mesh4, lambda t, i: jhalo.dist_gather(t, i, "data"), table, ids)
    ring = _jmap(mesh4, lambda t, i: jhalo.dist_gather_ring(t, i, "data", WORLD), table, ids)
    np.testing.assert_array_equal(np.asarray(exact.astype(jnp.float32)), want)
    np.testing.assert_array_equal(np.asarray(ring.astype(jnp.float32)), want)
    np.testing.assert_array_equal(_per_rank(port, f"exact/{name}"), want)
    np.testing.assert_array_equal(_per_rank(port, f"ring/{name}"), want)
    assert port[0][f"exact/{name}"].dtype == {"f32": torch.float32, "bf16": torch.bfloat16,
                                              "int8": torch.int8}[name]

    pip0, pip1 = _jmap(mesh4, lambda t, a, b: tuple(jhalo.dist_gather_ring_pipelined(
        t, [a, b], "data", WORLD, last_fanout=W.FANOUT)), table, ids2, ids, n_out=2)
    np.testing.assert_array_equal(_per_rank(port, f"pipelined0/{name}"),
                                  np.asarray(pip0.astype(jnp.float32)))
    # the pre-reduced level: both sides add the owners' partial means in the
    # ring's order, but XLA contracts acc + sum·fl32(1/F) into one FMA where
    # the port rounds the partial mean first; within 1e-6 of the scale
    ring_mean = _jmap(mesh4, lambda t, i: jhalo.dist_gather_ring_fanout_mean(
        t, i, W.FANOUT, "data", WORLD), table, ids)
    for key, want in (("pipelined1", np.asarray(pip1)), ("ring_mean", np.asarray(ring_mean))):
        np.testing.assert_allclose(_per_rank(port, f"{key}/{name}"), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(), err_msg=key)


@pytest.mark.parametrize("name", TABLES)
def test_bucketed_rows_and_overflow_are_jax(mesh4, port, name):
    """At the default capacity factor's capacity and at an undersized one
    (2 per destination): the same rows, the same queries overflowed (zero
    rows), the same count per rank."""
    table, ids = _jax_table(name), _ids(1)
    for cap in (int(2.0 * W.QUERIES / WORLD), 2):
        rows, ovf = _jmap(mesh4, lambda t, i: jhalo.dist_gather_bucketed(
            t, i, "data", WORLD, cap), table, ids, n_out=2)
        np.testing.assert_array_equal(_per_rank(port, f"bucketed{cap}/{name}"),
                                      np.asarray(rows.astype(jnp.float32)))
        got = [int(port[r][f"overflow{cap}/{name}"]) for r in range(WORLD)]
        assert got == np.asarray(ovf).tolist()
    assert sum(int(port[r][f"overflow2/{name}"]) for r in range(WORLD)) > 0


@pytest.mark.parametrize("name", TABLES)
def test_pre_reduced_mean_within_tolerance_of_jax(mesh4, port, name):
    """The exact mode's pre-reduced level: each rank's per-root f32 means of
    the rows it asked for (raw values of an int8 table) within 1e-6 of the
    means' scale of JAX's (the owners' partials summed in another order)."""
    table, ids = _jax_table(name), _ids(1)
    want = np.asarray(_jmap(mesh4, lambda t, i: j_make_gather_last("exact", WORLD)(
        t, i, W.FANOUT, "data")[0], table, ids))
    got = _per_rank(port, f"mean/{name}")
    assert port[0][f"mean/{name}"].dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    local = np.asarray(table[ids].astype(jnp.float32)).reshape(-1, W.FANOUT, W.WIDTH).mean(1)
    np.testing.assert_allclose(got, local, rtol=0, atol=1e-6 * np.abs(local).max())


@pytest.mark.parametrize("name", TABLES)
def test_owner_partial_is_bitwise_jax_per_shard(mesh4, name):
    """The owner-masked kernel's plain version against JAX's per-shard
    partial of dist_gather_fanout_mean (jitted): with only shard s's rows
    non-zero, JAX's exchanged sum is shard s's partial plus zeros."""
    table, ids = _jax_table(name), _ids(1)
    m = W.N_ROWS // WORLD
    all_ids = torch.from_numpy(np.array(ids))
    tables, _, _ = W.halo_inputs(WORLD)
    for s in range(WORLD):
        only = jnp.zeros_like(table).at[s * m:(s + 1) * m].set(table[s * m:(s + 1) * m])
        want = _jmap(mesh4, lambda t, i: jhalo.dist_gather_fanout_mean(
            t, i, W.FANOUT, "data"), only, ids)
        local = torch.from_numpy(np.ascontiguousarray(tables[name][s * m:(s + 1) * m]))
        if name == "bf16":
            local = local.to(torch.bfloat16)
        got = gather_mean.gather_fanout_mean_owned(local, all_ids, W.FANOUT, s * m)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_owner_partial_wrapper_contract():
    """On CPU tensors the wrapper runs its plain version; ids outside the
    range count as zero rows over a divisor that stays F; bad shapes raise."""
    table = torch.arange(12, dtype=torch.float32).view(4, 3)
    ids = torch.tensor([10, 11, 99, -1, 13, 10], dtype=torch.int32)  # rows 10..13 owned
    out = gather_mean.gather_fanout_mean_owned(table, ids, 3, lo=10)
    recip = np.float32(1) / np.float32(3)
    np.testing.assert_array_equal(out[0].numpy(), (table[0] + table[1]).numpy() * recip)
    np.testing.assert_array_equal(out[1].numpy(), (table[3] + table[0]).numpy() * recip)
    with pytest.raises(ValueError):
        gather_mean.gather_fanout_mean_owned(table, ids[:5], 3, lo=10)


def test_csr_pair_rows_and_owner_select_are_bitwise_jax(mesh4, port, hop_inputs):
    frontier, u, _ = hop_inputs
    store = j_sbm_store(n_nodes=100, n_classes=3, feat_dim=8, avg_degree=2, max_degree=12,
                        seed=3)
    g, _ = j_shard_graph_csr(store, mesh4, train=True)
    w = g.window
    ids = jnp.asarray(frontier)
    pair = _jmap(mesh4, lambda ip, ind, deg, i: jhalo.dist_gather(
        jhalo.CSRPairRows(ip, ind, deg, w), i, "data"), g.indptr, g.indices, g.degrees, ids)
    adj = _jmap(mesh4, lambda ip, ind, deg, i: jhalo.dist_gather(
        jhalo.CSRAdjRows(ip, ind, deg, w), i, "data"), g.indptr, g.indices, g.degrees, ids)
    sel = _jmap(mesh4, lambda ip, ind, deg, i, uu: jhalo.dist_sample_csr_owner_select(
        ip, ind, deg, w, i, uu, "data"), g.indptr, g.indices, g.degrees, ids, jnp.asarray(u))
    np.testing.assert_array_equal(_per_rank(port, "csr_pair"), np.asarray(pair))
    np.testing.assert_array_equal(_per_rank(port, "csr_adj"), np.asarray(adj))
    np.testing.assert_array_equal(_per_rank(port, "owner_select"), np.asarray(sel))


def test_distributed_hops_are_bitwise_the_single_device_sampler(port, hop_inputs):
    """Every hop form (dense rows by exact, ring and bucketed exchange; CSR
    pair rows; the owner-select) picks, for the same uniforms, what the JAX
    package's single-device uniform_neighbor_sample picks, isolated nodes
    self-looping."""
    frontier, _, key = hop_inputs
    store = j_sbm_store(n_nodes=100, n_classes=3, feat_dim=8, avg_degree=2, max_degree=12,
                        seed=3)
    assert (store.train_degrees[frontier] == 0).any()
    want = np.asarray(j_uniform_neighbor_sample(key, jnp.asarray(store.train_adj),
                                                jnp.asarray(store.train_degrees),
                                                jnp.asarray(frontier), W.FANOUT)).reshape(-1)
    for k in ("hop/exact", "hop/ring", "hop/bucketed", "hop_pair/exact", "hop_pair/ring",
              "hop_pair/bucketed", "hop_owner"):
        got = np.concatenate([port[r][k].numpy() for r in range(WORLD)])
        np.testing.assert_array_equal(got, want, err_msg=k)
