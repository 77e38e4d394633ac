"""The comparisons that decide ``correct``: the program's outputs judged
against the plain reference, number by number, each against its limit.

Limits live in ``limits/<cell>.json`` beside the readings they were set
from. A number that is not finite fails.
"""

from __future__ import annotations

import json
import math
import statistics
from typing import Dict, Iterable, Optional

import torch


def load_limits(path: str) -> Dict[str, float]:
    """The limits of a cell's ``limits/<cell>.json``."""
    with open(path) as f:
        return {k: float(v["limit"]) for k, v in json.load(f)["limits"].items()}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """``{name: {"value", "limit", "ok"}}`` for every limit; a number the
    run did not produce fails."""
    out = {}
    for name, limit in limits.items():
        v = values.get(name)
        ok = v is not None and math.isfinite(v) and v <= limit
        out[name] = {"value": v, "limit": limit, "ok": ok}
    return out


def _allowed(adj: torch.Tensor, degrees: torch.Tensor, parents: torch.Tensor) -> torch.Tensor:
    """Each parent's neighbour row with the columns past its degree set to
    -1; a parent of degree 0 has itself as its only neighbour."""
    p = parents.long()
    rows = adj[p].long()
    deg = degrees[p].long()
    cols = torch.arange(rows.shape[1], device=rows.device)
    rows = torch.where(cols[None, :] < deg[:, None], rows, -1)
    rows[:, 0] = torch.where(deg == 0, p, rows[:, 0])
    return rows


def bad_edges(adj, degrees, parents: torch.Tensor, children: torch.Tensor,
              block: int = 1 << 18) -> int:
    """How many ``children[i]`` are not a neighbour of ``parents[i]``."""
    bad = 0
    for s in range(0, parents.shape[0], block):
        rows = _allowed(adj, degrees, parents[s:s + block])
        hit = (rows == children[s:s + block].long()[:, None]).any(1)
        bad += int((~hit).sum())
    return bad


def bad_tree(adj, degrees, levels, fanouts) -> int:
    """Ids of a sampled tree that are not a neighbour of their parent."""
    bad = 0
    for lv, (parent, child) in enumerate(zip(levels[:-1], levels[1:])):
        if child.numel() != parent.numel() * int(fanouts[lv]):
            return child.numel() + parent.numel()
        bad += bad_edges(adj, degrees, parent.repeat_interleave(int(fanouts[lv])), child)
    return bad


def _norm(t: Optional[torch.Tensor]) -> float:
    return 0.0 if t is None else float(t.detach().double().norm())


def leaf_gaps(program: Dict[str, Optional[torch.Tensor]], reference: Dict[str, torch.Tensor],
              names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap of norms: ``| |p| - |r| |`` over the larger of the
    reference leaf's norm and the median leaf's."""
    names = list(reference if names is None else names)
    ref = {k: _norm(reference[k]) for k in names}
    med = statistics.median(ref.values())
    return {k: abs(_norm(program.get(k)) - ref[k]) / max(ref[k], med) if max(ref[k], med) > 0
            else 0.0 for k in names}


def moving_leaves(first_grads: Dict[str, torch.Tensor], share: float = 1e-3) -> list:
    """Leaves whose first reference gradient is at least ``share`` of the
    median leaf's: the others move under Adam by round-off alone."""
    norms = {k: _norm(g) for k, g in first_grads.items()}
    med = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= share * med]
