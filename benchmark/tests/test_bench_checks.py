"""The sampler judgements of ``checks.py`` on a graph small enough to check
by hand, and the norms' gap."""

import torch

from benchmark import checks

# node: neighbours (degree 2, then padding with the node's own id)
ADJ = torch.tensor([[1, 2, 0], [2, 2, 1], [0, 0, 2], [3, 3, 3]], dtype=torch.int32)
DEG = torch.tensor([2, 1, 1, 0], dtype=torch.int32)


def test_bad_edges_counts_non_neighbours():
    parents = torch.tensor([0, 0, 1, 2, 3, 1])
    children = torch.tensor([1, 2, 2, 0, 3, 1])  # the last: column 2 is padding
    assert checks.bad_edges(ADJ, DEG, parents, children) == 1
    assert checks.bad_edges(ADJ, DEG, parents, children, block=2) == 1


def test_bad_tree_follows_the_fanout():
    levels = [torch.tensor([0, 3]), torch.tensor([1, 2, 3, 3]), torch.tensor([2, 2, 0, 2] + [3] * 4)]
    assert checks.bad_tree(ADJ, DEG, levels, (2, 2)) == 1  # 2's neighbour is 0 only
    assert checks.bad_tree(ADJ, DEG, levels[:2], (3,)) > 0  # wrong size


def test_leaf_gap_and_moving_leaves():
    ref = {"a": torch.ones(4), "b": torch.full((4,), 2.0), "c": torch.zeros(4)}
    prog = {"a": torch.ones(4) * 1.1, "b": torch.full((4,), 2.0), "c": None}
    # |a|: 2 against 2.2; the median leaf's norm is 2 -> 0.1
    assert abs(max(checks.leaf_gaps(prog, ref).values()) - 0.1) < 1e-6
    assert checks.moving_leaves(ref) == ["a", "b"]
    assert max(checks.leaf_gaps({}, ref, ["a", "b"]).values()) == 1.0


def test_worst_over_ranks():
    ranks = [{"embed_err": 1e-7, "nonfinite_steps": 0.0, "gap": 2.0},
             {"embed_err": 3e-4, "nonfinite_steps": 0.0, "gap": float("nan")},
             {"embed_err": 2e-7, "nonfinite_steps": 0.0}]
    got = checks.worst(ranks)
    assert got["embed_err"] == 3e-4 and got["nonfinite_steps"] == 0.0
    assert got["gap"] is None  # a rank that did not produce it
    both = checks.worst(ranks[:2])
    assert both["gap"] != both["gap"]  # the rank's nan, not the other's 2.0
    verdict = checks.judge(got, {"embed_err": 2e-4, "gap": 1.0})
    assert not verdict["embed_err"]["ok"] and not verdict["gap"]["ok"]
