"""The counts of ``counts.py`` against figures worked by hand."""

import math

import numpy as np
import pytest

from benchmark import counts

N = 232_965


def test_sampled_edges_per_step():
    assert counts.sampled_edges(512, (25, 10)) == 512 * (25 + 250) == 140_800
    assert counts.sampled_edges((2 + 10) * 512, (25, 10)) == 6_144 * 275 == 1_689_600
    assert counts.tree_sizes(512, (25, 10)) == [512, 12_800, 128_000]


@pytest.mark.parametrize("n,draws", [(10, 1), (10, 10), (1000, 5000), (N, 128_000)])
def test_expected_distinct_formula(n, draws):
    assert counts.expected_distinct(n, draws) == pytest.approx(n * (1 - (1 - 1 / n) ** draws),
                                                               rel=1e-9)


def test_expected_distinct_by_sampling():
    rng = np.random.default_rng(0)
    seen = [len(np.unique(rng.integers(0, 5000, 7000))) for _ in range(200)]
    assert np.mean(seen) == pytest.approx(counts.expected_distinct(5000, 7000), rel=2e-3)


def test_deepest_level_distinct_rows():
    # 128,000 uniform draws over Reddit's nodes: N(1 - exp(-128000/N)), about 98,475
    assert counts.expected_distinct(N, 128_000) == pytest.approx(N * -math.expm1(-128_000 / N),
                                                                 rel=1e-5)
    assert 98_400 < counts.expected_distinct(N, 128_000) < 98_550


def test_supervised_step_counts():
    c = counts.sage_mean_step(N, 602, (128, 128), (25, 10), 512, 2, 230_185, n_classes=41)
    deep = counts.expected_distinct(N, 128_000) * 1204 + 4 * 128_000 + 12_800 * 1204
    assert c["deep_mean_bytes"] == pytest.approx(deep)
    rows = counts.expected_distinct(N, 141_312)
    assert c["bytes"] == pytest.approx(rows * 1204 + 4 * 140_800 + 32 * 230_185)
    layer0 = 2 * 602 * 128 * (counts.expected_distinct(N, 13_312) + 13_312)
    act = 2 * (2 * 256 * 128 * 512) + 2 * 256 * 41 * 512
    assert c["flops"] == pytest.approx(2 * (layer0 + act) + act)


def test_exact_pass_least_bytes_and_flops():
    c = counts.exact_pass(N, 602, (128, 128), 128, 4, 4096)
    # layer 0: the f32 table read, 256-wide f32 out written; layer 1: that
    # read, 256-wide out written; each layer's adjacency and degrees read
    assert c["bytes"] == 4 * N * (602 + 256) + 4 * N * (256 + 256) + 2 * 4 * N * 129
    assert c["bytes"] == 1_517_068_080
    assert c["flops"] == 2 * (2 * N * 602 * 128) + 2 * (2 * N * 256 * 128)


def test_exact_pass_gather_rows_least_bytes():
    c = counts.exact_pass(N, 602, (128, 128), 128, 4, 4096)
    # 56 whole chunks of 4,096 nodes and a last one of 3,589, each gathering
    # 128 neighbour rows a node: 2,408-byte rows at layer 0, 1,024 at layer 1
    assert 56 * 4096 + 3589 == N
    q, q_last = 4096 * 128, 3589 * 128
    one = (counts.expected_distinct(N, q) + q, counts.expected_distinct(N, q_last) + q_last)
    rows = 56 * one[0] + one[1]
    ids = 4 * (56 * q + q_last)
    assert c["gather_rows_bytes"] == pytest.approx(rows * (2408 + 1024) + 2 * ids)
    # a pool gathers its 512-wide projected rows at both layers, and
    # projects every node's 602-, then 256-wide row to 512 first
    p = counts.exact_pass(N, 602, (128, 128), 128, 4, 4096, pool_hidden=512)
    assert p["gather_rows_bytes"] == pytest.approx(rows * 2 * 2048 + 2 * ids)
    assert p["flops"] == 2 * N * (602 * 128 + 512 * 128 + 602 * 512) \
        + 2 * N * (256 * 128 + 512 * 128 + 256 * 512)
    assert p["bytes"] == c["bytes"]
    # a whole chunk reads N(1 - exp(-524288/N)), about 208,423 distinct rows
    assert 208_300 < counts.expected_distinct(N, q) < 208_550
