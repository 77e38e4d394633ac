"""Whole-table projection + gather with a scatter-free backward: the fused
first layer (counterpart of ``tpu_sage/nn/fused.py``).

The mean aggregator's first pass commutes with its projection, so the
feature table can be projected once per step (``table @ W``, one
``torch.matmul``, as the JAX package leaves ``jnp.dot`` to XLA) and every
tree level gathered in output space: 128-wide rows instead of 602-wide ones.

Autograd through ``(table @ W)[ids]`` would scatter the rows' cotangents
into a table-sized buffer and multiply it by the whole table again. The
backward here computes ``dW = Σ_levels X[ids]ᵀ g`` from the raw rows instead
(``gather_rows`` of the table at each level's ids), with f32 accumulation,
and casts ``dW`` to the table's dtype as the reference's ``_pg_bwd`` does.
Nothing table-sized is built; the table and the ids get no gradient.

A level whose projected rows feed only a fanout mean (every neighbor level
of the mean aggregator) is returned as that mean: ``row_gather_fanout_mean``
of the projected table (the ``gather_fanout_mean`` kernel), f32 sums divided
by ``F`` and rounded once to the table's dtype, which is how ``jnp.mean``
rounds the gathered rows in the reference. Its backward takes the mean's
cotangent per row as ``jnp.mean``'s VJP rounds it, ``dtype(f32(g) / F)``,
and sums the level's raw rows in f32 over each group of ``F`` before the
product (the same sum reassociated). The other levels are plain gathers
(``row_gather``, the ``gather_rows`` kernel).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from tpu_sage_torch.ops import row_gather, row_gather_fanout_mean


class _ProjectGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, w, fanouts, *ids_list):
        dt = torch.promote_types(table.dtype, w.dtype)  # jnp.dot's promotion
        proj = torch.matmul(table.to(dt), w.to(dt))
        outs = []
        for ids, fanout in zip(ids_list, fanouts):
            if fanout == 1:
                outs.append(row_gather(proj, ids))
            else:
                outs.append(row_gather_fanout_mean(proj, ids, fanout).to(proj.dtype))
        ctx.save_for_backward(table, *ids_list)
        ctx.fanouts = fanouts
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        table, *ids_list = ctx.saved_tensors
        dw = None
        for ids, fanout, g in zip(ids_list, ctx.fanouts, grads):
            if g is None:
                continue
            x = row_gather(table, ids)  # the level's raw rows, backward only
            if fanout == 1:
                xs = x.float()
            else:
                xs = x.view(-1, fanout, x.shape[-1]).sum(1, dtype=torch.float32)
                g = (g.float() / fanout).to(g.dtype)  # each row's share of the mean
            contrib = xs.T @ g.float()
            dw = contrib if dw is None else dw + contrib
        dw = None if dw is None else dw.to(table.dtype)
        return (None, dw, None) + (None,) * len(ids_list)


def project_gather(table: torch.Tensor, w: torch.Tensor, ids_list: Sequence[torch.Tensor],
                   fanouts: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """``[(table @ w)[ids] for ids in ids_list]``; a level with a fanout
    ``F > 1`` in ``fanouts`` (default all 1) comes back as its fanout mean
    ``(len(ids) // F, O)``. The product is in the promoted dtype of
    ``table`` and ``w``, as the outputs are; ``dW`` comes back in the
    table's dtype (autograd casts it to ``w``'s). An int8 table has no
    product to fuse and raises ``TypeError``, as ``jnp.dot`` does on the
    reference's."""
    if not isinstance(table, torch.Tensor):
        raise TypeError(f"project_gather needs a dense feature table, got {type(table).__name__}")
    fanouts = tuple(fanouts) if fanouts is not None else (1,) * len(ids_list)
    if len(fanouts) != len(ids_list):
        raise ValueError(f"{len(ids_list)} id levels, {len(fanouts)} fanouts")
    ids_list = [ids.reshape(-1).to(torch.int32).contiguous() for ids in ids_list]
    return list(_ProjectGather.apply(table, w, fanouts, *ids_list))
