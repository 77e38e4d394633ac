"""Operations and least bytes of the work a cell asks for, from its shapes.

Nothing here comes from the program: the numbers are fixed by the
configuration and the traffic, so a kernel that is renamed, fused or
redesigned leaves them standing, and no implementation can beat the least
time they give. FLOPs count the products (two a multiply-add); least bytes
count every distinct input row read once, every id and output written once,
and nothing an implementation could keep on the chip.

Where a product can be done in two known orders (project the mean of the
neighbours' rows, or project each distinct row once and average the
projections) the cheaper count is taken, so the bound stays a bound.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional, Sequence

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")
PARAM_ACCESSES = 8  # an Adam step: gradient written and read; parameter, m, v read and written


def expected_distinct(n: int, draws: int) -> float:
    """Expected distinct values among ``draws`` uniform draws from ``n``."""
    if draws <= 0:
        return 0.0
    return n * -math.expm1(draws * math.log1p(-1.0 / n))


def tree_sizes(roots: int, fanouts: Sequence[int]) -> list:
    """Nodes at each level of a sampled tree: ``[R0, R0*f1, R0*f1*f2, ...]``."""
    sizes = [roots]
    for f in fanouts:
        sizes.append(sizes[-1] * int(f))
    return sizes


def sampled_edges(roots: int, fanouts: Sequence[int]) -> int:
    """Edges a tree samples: every node below the roots."""
    return sum(tree_sizes(roots, fanouts)[1:])


def sage_mean_step(n: int, feat_dim: int, output_dims: Sequence[int], fanouts: Sequence[int],
                   roots: int, feat_bytes: int, n_params: int,
                   n_classes: Optional[int] = None) -> Dict[str, float]:
    """One GraphSAGE-mean training step over a tree of ``roots`` roots:
    ``flops`` (forward, the weights' gradients, the activations' gradients
    where an input needs one), ``bytes`` (distinct feature rows, sampled ids,
    Adam's traffic), and ``deep_mean_bytes``, the least bytes of the deepest
    level's neighbour mean (its distinct rows, its ids, its means written in
    the table's dtype). ``n_classes`` adds the supervised head."""
    sizes = tree_sizes(roots, fanouts)
    depth = len(fanouts)
    fwd = 0.0
    # layer 0 on the raw rows: self rows deduplicated, neighbour means or
    # projected distinct rows, whichever is fewer
    per_row = 2.0 * feat_dim * output_dims[0]
    self_rows = expected_distinct(n, sum(sizes[:depth]))
    neigh_rows = min(sum(sizes[:depth]), expected_distinct(n, sum(sizes[1:])))
    layer0 = per_row * (self_rows + neigh_rows)
    act = 0.0  # products whose input is an activation (their input gradient is needed)
    d_in = 2 * output_dims[0]
    for i, d_out in enumerate(output_dims[1:], start=1):
        rows = sum(sizes[:depth - i])
        act += 2 * (2.0 * d_in * d_out * rows)
        d_in = 2 * d_out
    if n_classes is not None:
        act += 2.0 * d_in * n_classes * roots
    fwd = layer0 + act
    flops = 2 * fwd + act
    feat_rows = expected_distinct(n, sum(sizes))
    nbytes = (feat_rows * feat_dim * feat_bytes + 4.0 * sum(sizes[1:])
              + PARAM_ACCESSES * 4.0 * n_params)
    deep = sizes[-1]
    deep_mean_bytes = (expected_distinct(n, deep) * feat_dim * feat_bytes + 4.0 * deep
                       + sizes[-2] * feat_dim * feat_bytes)
    return {"flops": flops, "bytes": nbytes, "deep_mean_bytes": deep_mean_bytes}


def exact_pass(n: int, feat_dim: int, output_dims: Sequence[int], degree: int,
               value_bytes: int, chunk: int, pool_hidden: int = 0) -> Dict[str, float]:
    """One exact layer-wise pass over every node in chunks of ``chunk``:
    ``flops``, each layer's products (self and neighbour branches, and with
    ``pool_hidden`` the pool's projection of every node); ``bytes``, its
    source table read once, its output written once, its adjacency and
    degrees read once; ``gather_rows_bytes``, the least bytes of gathering
    each chunk's ``chunk * degree`` neighbour rows (the source rows, or the
    pool's ``pool_hidden``-wide ones), layer by layer: each distinct row of
    the chunk read once, every gathered row written once, the int32 ids
    read once."""
    flops, nbytes, gather, d_in = 0.0, 0.0, 0.0, feat_dim
    for d_out in output_dims:
        neigh_in = pool_hidden or d_in
        flops += 2.0 * n * (d_in * d_out + neigh_in * d_out + (d_in * pool_hidden))
        nbytes += value_bytes * n * (d_in + 2 * d_out) + 4.0 * n * (degree + 1)
        for start in range(0, n, chunk):
            q = min(chunk, n - start) * degree
            gather += (expected_distinct(n, q) + q) * neigh_in * value_bytes + 4.0 * q
        d_in = 2 * d_out
    return {"flops": flops, "bytes": nbytes, "gather_rows_bytes": gather}


def peaks(device_name: str) -> Optional[dict]:
    """The published peaks of a card by its ``torch.cuda.get_device_name``,
    or None for a card the table does not hold."""
    with open(PEAKS_FILE) as f:
        return json.load(f).get(device_name)


def least_seconds(counts: Dict[str, float], peak: dict, dtype: str) -> float:
    """The larger of the FLOPs at the dtype's peak and the bytes at HBM's."""
    return max(counts["flops"] / peak[f"{dtype}_flops_per_s"],
               counts["bytes"] / peak["hbm_bytes_per_s"])
