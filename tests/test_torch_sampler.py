"""tpu_sage_torch sampler against the JAX package's.

``torch.Generator`` and ``jax.random`` draw different numbers, so parity
feeds JAX's uniforms to the port and checks the picked columns bit for bit;
the distribution of the port's own draws is checked with a χ² test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from tpu_sage.sample import sampler as jsampler
from tpu_sage_torch.kernels.sample_hop import sample_hop, sample_hop_reference
from tpu_sage_torch.sample.sampler import (gather_levels, pack_adjacency, sample_tree,
                                           sample_tree_packed, uniform_neighbor_sample)

ONE_MINUS_ULP = np.nextafter(np.float32(1.0), np.float32(0.0))


def _graph():
    """Degrees 0 (isolated, self-padded), 1, 3 (< fanout), 8 (full), 5."""
    rng = np.random.default_rng(0)
    n, max_degree = 5, 8
    degrees = np.array([0, 1, 3, 8, 5], dtype=np.int32)
    adj = np.repeat(np.arange(n, dtype=np.int32)[:, None], max_degree, axis=1)
    for v, d in enumerate(degrees):
        adj[v, :d] = rng.integers(0, n, d)
    return adj, degrees


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_injected_uniforms_pick_reference_columns(seed):
    adj, deg = _graph()
    ids = np.array([0, 1, 2, 3, 4, 3, 0, 2], dtype=np.int32)
    key = jax.random.key(seed)
    want = jsampler.uniform_neighbor_sample(key, jnp.asarray(adj), jnp.asarray(deg),
                                            jnp.asarray(ids), 6)
    u = jax.random.uniform(key, (ids.shape[0], 6))
    ours = uniform_neighbor_sample(_t(adj), _t(deg), _t(ids), 6, u=_t(u))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))


def test_uniforms_near_one_and_zero_match_reference(monkeypatch):
    """u within an ulp of 1.0 must still pick a real neighbor (the min guard);
    the reference draws the same crafted uniforms through a patched
    jax.random.uniform."""
    adj, deg = _graph()
    ids = np.array([0, 1, 2, 3, 4], dtype=np.int32)
    u = np.tile(np.array([ONE_MINUS_ULP, 0.0, 0.5, 0.99999, ONE_MINUS_ULP], np.float32), (5, 1))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(u))
    want = np.asarray(jsampler.uniform_neighbor_sample(
        jax.random.key(0), jnp.asarray(adj), jnp.asarray(deg), jnp.asarray(ids), 5))
    ours = uniform_neighbor_sample(_t(adj), _t(deg), _t(ids), 5, u=_t(u)).numpy()
    np.testing.assert_array_equal(ours, want)
    for row, v in enumerate(ids):
        allowed = adj[v, :max(deg[v], 1)]
        assert np.isin(ours[row], allowed).all()


def test_degree_zero_samples_itself_with_generator():
    adj, deg = _graph()
    gen = torch.Generator().manual_seed(0)
    out = uniform_neighbor_sample(_t(adj), _t(deg), torch.tensor([0, 0], dtype=torch.int32),
                                  7, generator=gen)
    assert (out == 0).all()


def test_sample_tree_bit_equal_under_reference_key_splits():
    adj, deg = _graph()
    ids = np.array([0, 1, 2, 3], dtype=np.int32)
    fanouts = (5, 3)
    key = jax.random.key(11)
    want = jsampler.sample_tree(key, jnp.asarray(adj), jnp.asarray(deg), jnp.asarray(ids), fanouts)
    us, k, n = [], key, ids.shape[0]
    for f in fanouts:  # the reference's split structure, one split per hop
        k, sub = jax.random.split(k)
        us.append(_t(jax.random.uniform(sub, (n, f))))
        n *= f
    ours = sample_tree(_t(adj), _t(deg), _t(ids), fanouts, us=us)
    assert [l.shape[0] for l in ours] == [4, 20, 60]
    for a, b in zip(ours, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_hop_reference_matches_reference_hop(seed):
    """The fused hop's plain version, directly and through the wrapper on CPU
    tensors, bitwise against JAX's uniform_neighbor_sample fed the same
    uniforms, on the degree 0/1/3/8/5 graph."""
    adj, deg = _graph()
    ids = np.array([0, 1, 2, 3, 4, 3, 0, 2, 1], dtype=np.int32)
    key = jax.random.key(seed)
    want = np.asarray(jsampler.uniform_neighbor_sample(key, jnp.asarray(adj), jnp.asarray(deg),
                                                       jnp.asarray(ids), 7))
    u = _t(jax.random.uniform(key, (ids.shape[0], 7)))
    for fn in (sample_hop_reference, sample_hop):
        ours = fn(_t(adj), _t(deg), _t(ids), u)
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), want)


def test_out_of_range_ids_and_u_near_one_match_reference_plain_form(monkeypatch):
    """Ids below -n, negative and >= n read as JAX's plain gather does (wrap
    once by n, then clamp), with u at 0 and within an ulp of 1.0."""
    adj, deg = _graph()
    ids = np.array([-1, -3, -5, -6, -40, 5, 9, 0, 4], dtype=np.int32)
    u = np.tile(np.array([ONE_MINUS_ULP, 0.0, 0.5, ONE_MINUS_ULP], np.float32), (ids.shape[0], 1))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(u))
    want = np.asarray(jsampler.uniform_neighbor_sample(
        jax.random.key(0), jnp.asarray(adj), jnp.asarray(deg), jnp.asarray(ids), 4))
    ours = uniform_neighbor_sample(_t(adj), _t(deg), _t(ids), 4, u=_t(u)).numpy()
    np.testing.assert_array_equal(ours, want)
    np.testing.assert_array_equal(ours[0], ours[-1])  # -1 reads row n - 1
    np.testing.assert_array_equal(ours[4], ours[7])   # -40 wraps to -35, clamps to 0


def test_sample_hop_checks_its_shapes():
    adj, deg = _graph()
    ids = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="degrees"):
        sample_hop(_t(adj), _t(deg[:4]), ids, torch.zeros(3, 2))
    with pytest.raises(ValueError, match="u must be"):
        sample_hop(_t(adj), _t(deg), ids, torch.zeros(2, 2))


def _reference_uniforms(key, n, fanouts):
    """Each hop's uniforms under the reference's split structure."""
    us = []
    for f in fanouts:
        key, sub = jax.random.split(key)
        us.append(jax.random.uniform(sub, (n, f)))
        n *= f
    return us


@pytest.mark.parametrize("seed", [11, 12])
def test_packed_sampler_bit_equal_to_reference_and_to_sample_tree(seed):
    """pack_adjacency and sample_tree_packed bitwise against the JAX
    package's, and against the port's sample_tree with the same uniforms."""
    adj, deg = _graph()
    ids = np.array([0, 1, 2, 3, 4, 2], dtype=np.int32)
    fanouts = (5, 3)
    key = jax.random.key(seed)
    j_packed = jsampler.pack_adjacency(jnp.asarray(adj), jnp.asarray(deg))
    packed = pack_adjacency(_t(adj), _t(deg))
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (5, 9)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(j_packed))
    want = jsampler.sample_tree_packed(key, j_packed, jnp.asarray(ids), fanouts)
    us = [_t(u) for u in _reference_uniforms(key, ids.shape[0], fanouts)]
    ours = sample_tree_packed(packed, _t(ids), fanouts, us=us)
    fused = sample_tree(_t(adj), _t(deg), _t(ids), fanouts, us=us)
    assert [l.shape[0] for l in ours] == [6, 30, 90]
    for a, b, c in zip(ours, want, fused):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_levels_bitwise_the_reference(dtype):
    """gather_levels: one gather of the concatenated levels, split back into
    levels, bitwise the JAX package's on the same tree and table."""
    adj, deg = _graph()
    ids = np.array([0, 1, 2, 3, 4, 2], dtype=np.int32)
    key = jax.random.key(5)
    levels = jsampler.sample_tree(key, jnp.asarray(adj), jnp.asarray(deg), jnp.asarray(ids),
                                  (5, 3))
    feats = np.random.default_rng(3).normal(size=(5, 7)).astype(np.float32)
    want = jsampler.gather_levels(jnp.asarray(feats, dtype=dtype), levels)
    ours = gather_levels(_t(feats).to(getattr(torch, dtype)), [_t(l) for l in levels])
    assert [tuple(o.shape) for o in ours] == [(6, 7), (30, 7), (90, 7)]
    for a, b in zip(ours, want):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


def test_packed_sampler_draws_the_same_tree_from_one_generator_state():
    adj, deg = _graph()
    ids = torch.tensor([1, 2, 3, 4, 0], dtype=torch.int32)
    packed = sample_tree_packed(pack_adjacency(_t(adj), _t(deg)), ids, (4, 2),
                                generator=torch.Generator().manual_seed(9))
    fused = sample_tree(_t(adj), _t(deg), ids, (4, 2), generator=torch.Generator().manual_seed(9))
    for a, b in zip(packed, fused):
        assert torch.equal(a, b)


def test_sample_tree_generator_is_deterministic_per_seed():
    adj, deg = _graph()
    ids = torch.tensor([1, 2, 3, 4], dtype=torch.int32)

    def draw(seed):
        return sample_tree(_t(adj), _t(deg), ids, (4, 2),
                           generator=torch.Generator().manual_seed(seed))

    for a, b in zip(draw(3), draw(3)):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(draw(3), draw(4)))


def test_generator_draws_are_uniform_over_true_neighbors():
    """χ² over the 5 true columns of one node (padding never drawn)."""
    n, max_degree, d = 2, 8, 5
    adj = np.repeat(np.arange(n, dtype=np.int32)[:, None], max_degree, axis=1)
    adj[1, :d] = np.arange(10, 10 + d)  # node 1's neighbors are ids 10..14
    adj = np.concatenate([adj, np.zeros((13, max_degree), np.int32)])
    degrees = np.zeros(adj.shape[0], np.int32)
    degrees[1] = d
    ids = torch.ones(4000, dtype=torch.int32)
    out = uniform_neighbor_sample(_t(adj), _t(degrees), ids, 10,
                                  generator=torch.Generator().manual_seed(5)).numpy().ravel()
    assert np.isin(out, np.arange(10, 10 + d)).all()
    counts = np.bincount(out - 10, minlength=d)
    _, pvalue = scipy.stats.chisquare(counts)
    assert pvalue > 1e-4, f"sampling not uniform: counts={counts}"


@pytest.mark.parametrize("seed", [3, 4])
def test_packed_hop_is_the_parents_composition_for_one_generator_state(seed):
    """Each packed hop is one ``select_hop`` on the gathered adjacency ‖
    degree rows; from one generator state the tree is the one the parent's
    composition drew (the row gather, ``clamp_min``, ``hop_columns``,
    ``select_columns``), degree-0 rows picking their self pad."""
    from tpu_sage_torch.kernels.sample_hop import hop_columns
    from tpu_sage_torch.kernels.select import select_columns

    adj, deg = _graph()
    packed = pack_adjacency(_t(adj), _t(deg))
    ids = torch.tensor([0, 1, 2, 3, 4, 0, 3], dtype=torch.int32)
    fanouts = (6, 3)
    tree = sample_tree_packed(packed, ids, fanouts, generator=torch.Generator().manual_seed(seed))
    gen, old = torch.Generator().manual_seed(seed), [ids]
    for f in fanouts:
        rows = packed[old[-1].long()]
        u = torch.rand((rows.shape[0], f), generator=gen)
        old.append(select_columns(rows[:, :-1], hop_columns(u, rows[:, -1].clamp_min(1)))
                   .reshape(-1))
    for a, b in zip(tree, old):
        assert torch.equal(a, b)
    assert (tree[1].view(-1, 6)[[0, 5]] == 0).all()  # node 0 is isolated: its self pad
