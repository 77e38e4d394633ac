"""Shared device-side primitives (counterpart of ``tpu_sage/ops.py``).

``row_gather`` is the framework-wide spelling of ``table[ids]``;
``row_gather_fanout_mean`` is the deepest tree level's gather + fanout mean.
Both go through hand-written kernels (``tpu_sage_torch.kernels``) on CUDA
tensors. A table that gathers itself (``data/quantize.py::QuantizedFeats``:
int8 rows, dequantized after the gather) is dispatched to its own methods.
The reference's gather chunking (``row_gather_chunked``, ``snap_chunks``) is
a TPU descriptor-stream knob that changes no value; the port launches one
kernel per gather.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_sage_torch.kernels.gather import gather_rows
from tpu_sage_torch.kernels.gather_mean import gather_fanout_mean

_OOB_OF_FORM = {"plain": "clamp", "masked": "zero"}


def row_gather(table: torch.Tensor, ids: torch.Tensor,
               form: Optional[str] = None) -> torch.Tensor:
    """``table[ids]`` for ``ids`` of any shape; trailing table dims follow.

    ``form`` keeps the reference's out-of-range semantics: ``"plain"`` (the
    default) wraps a negative id once by ``n`` and clamps, as ``table[ids]``
    does in JAX; ``"masked"`` yields zero rows. The samplers only produce
    in-range ids, for which both forms are ``table[ids]``.
    """
    own = getattr(table, "row_gather", None)
    if own is not None:
        return own(ids, form=form)
    form = form or "plain"
    if form not in _OOB_OF_FORM:
        raise ValueError(f"unknown gather form {form!r}; expected one of {sorted(_OOB_OF_FORM)}")
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    rows = gather_rows(table.reshape(table.shape[0], -1), flat, oob=_OOB_OF_FORM[form])
    return rows.reshape(*ids.shape, *table.shape[1:])


def row_gather_fanout_mean(table: torch.Tensor, ids: torch.Tensor, fanout: int,
                           int8_summean: bool = True) -> torch.Tensor:
    """``mean(table[ids].reshape(-1, fanout, D), axis=1)`` in one pass: f32
    means of a dense table; of a ``QuantizedFeats`` table, means in its
    compute dtype, from the int32 sum of the raw rows (``int8_summean``) or
    from the dequantized rows (the reference's ``int8_summean=False``).

    Only valid where the rows' sole consumer is the fanout mean: the deepest
    tree level under the mean aggregator with the identity prep."""
    own = getattr(table, "fanout_mean", None)
    if own is not None:
        return own(ids, ids.numel() // fanout, fanout, summean=int8_summean)
    return gather_fanout_mean(table, ids.reshape(-1).to(torch.int32).contiguous(), fanout)
