"""Replica divergence checks (counterpart of ``tpu_sage/dist/debug.py``).

Every rank holds the parameters and optimizer state; the failure mode left
is replicas drifting apart after a resume or a non-deterministic reduction.
A fingerprint is one float per replica to compare instead of the whole
state.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from tpu_sage_torch.dist.mesh import world


def _leaves(tree: Any):
    if isinstance(tree, torch.nn.Module):
        yield from (t for _, t in sorted(tree.state_dict().items()))
    elif isinstance(tree, torch.optim.Optimizer):
        for _, st in sorted(tree.state_dict()["state"].items()):
            for _, v in sorted(st.items()):
                yield from _leaves(v)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def tree_fingerprint(tree: Any) -> torch.Tensor:
    """Order-stable scalar fingerprint: the sum of every numeric leaf's f32
    mean (a module's state, an optimizer's state, nested dicts and lists of
    tensors)."""
    means = [t.detach().float().mean().cpu() for t in _leaves(tree)
             if t.dtype != torch.bool and t.numel()]
    return torch.stack(means).sum()


def assert_replicas_equal(x: Any, name: str = "value") -> None:
    """Raise unless every rank's fingerprint of ``x`` agrees (rtol 1e-6,
    atol 1e-8); nothing to compare at world 1."""
    if world() == 1:
        return
    fp = [None] * world()
    dist.all_gather_object(fp, float(tree_fingerprint(x)))
    ref = torch.tensor(fp, dtype=torch.float64)
    if not torch.allclose(ref, ref[0].expand_as(ref), rtol=1e-6, atol=1e-8):
        raise AssertionError(f"replica divergence in {name}: fingerprints {fp}")
