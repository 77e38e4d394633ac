"""Shared device-side primitives (counterpart of ``tpu_sage/ops.py``).

``row_gather`` is the framework-wide spelling of ``table[ids]``;
``row_gather_fanout_mean`` is the deepest tree level's gather + fanout mean.
Both go through hand-written kernels (``tpu_sage_torch.kernels``) on CUDA
tensors. A table that gathers itself (``data/quantize.py::QuantizedFeats``:
int8 rows, dequantized after the gather) is dispatched to its own methods.
The reference's gather chunking (``row_gather_chunked``, ``snap_chunks``) is
a TPU descriptor-stream knob that changes no value; the port launches one
kernel per gather, so ``TPU_SAGE_GATHER_CHUNKS`` has nothing to switch here.
``TPU_SAGE_GATHER_FORM`` and ``TPU_SAGE_INT8_SUMMEAN`` override the callers'
``form`` and ``int8_summean`` as in the JAX package (``overrides.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_sage_torch import overrides
from tpu_sage_torch.kernels.gather import gather_rows
from tpu_sage_torch.kernels.gather_mean import gather_fanout_mean

# "masked_chunked" is the JAX package's masked form with chunked gathers
# (its ``row_gather`` masks every form but "plain"); chunking changes no value
_OOB_OF_FORM = {"plain": "clamp", "masked": "zero", "masked_chunked": "zero"}


def row_gather(table: torch.Tensor, ids: torch.Tensor,
               form: Optional[str] = None) -> torch.Tensor:
    """``table[ids]`` for ``ids`` of any shape; trailing table dims follow.

    ``form`` keeps the reference's out-of-range semantics: ``"plain"`` (the
    default) wraps a negative id once by ``n`` and clamps, as ``table[ids]``
    does in JAX; ``"masked"`` (and ``"masked_chunked"``) yields zero rows.
    The samplers only produce in-range ids, for which both forms are
    ``table[ids]``.
    """
    own = getattr(table, "row_gather", None)
    if own is not None:
        return own(ids, form=form)
    form = overrides.gather_form(form) or "plain"
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
        return own(ids, ids.numel() // fanout, fanout,
                   summean=overrides.int8_summean(int8_summean))
    return gather_fanout_mean(table, ids.reshape(-1).to(torch.int32).contiguous(), fanout)
