"""int8 feature storage with per-column symmetric scales (counterpart of
``tpu_sage/data/quantize.py``).

Storing the feature table as int8 halves the resident table (232,965 × 602:
280.5 MB in bf16, 140.2 MB in int8) and every gathered byte. The scales are
per column, a ``(d,)`` vector, so a row gather stays one int8 row fetch.

``QuantizedFeats`` stands in for the dense table: ``.shape``, ``.ndim``,
``.dtype`` (the compute dtype) and ``.device`` are the table's, ``qf[ids]``
and ``row_gather`` return dequantized rows in the compute dtype, and
``fanout_mean`` is the deepest level's gather + mean in one kernel
(``kernels/gather_mean.py::gather_fanout_mean_int8``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sage_torch.kernels.gather_mean import gather_fanout_mean_int8
from tpu_sage_torch.ops import row_gather


class QuantizedFeats:
    """int8 feature rows and per-column scales on one device; indexes like a
    dense table of ``out_dtype``."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 out_dtype: torch.dtype = torch.bfloat16):
        if q.dtype != torch.int8 or q.dim() != 2:
            raise TypeError(f"q must be (n, d) int8, got {q.dtype} {tuple(q.shape)}")
        if scale.shape != (q.shape[1],) or scale.device != q.device:
            raise ValueError(f"scale must be ({q.shape[1]},) on {q.device}, got "
                             f"{tuple(scale.shape)} on {scale.device}")
        self.q = q
        self.scale = scale.to(torch.float32).contiguous()
        self.out_dtype = out_dtype
        self._scale_dt = self.scale.to(out_dtype)  # the dequantizing factor

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.dim()

    @property
    def dtype(self) -> torch.dtype:
        return self.out_dtype

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        """Resident bytes: the int8 rows and the f32 scales."""
        return self.q.numel() + 4 * self.scale.numel()

    def _dequantize(self, rows: torch.Tensor) -> torch.Tensor:
        # int8 times the scale in the compute dtype, one launch: q converts
        # exactly (|q| <= 127), so the product rounds once, as in JAX
        return rows * self._scale_dt

    def __getitem__(self, idx) -> torch.Tensor:
        if isinstance(idx, torch.Tensor):
            return self.row_gather(idx)
        return self._dequantize(self.q[idx])

    def row_gather(self, ids: torch.Tensor, form=None) -> torch.Tensor:
        """``gather_rows`` of the int8 rows (``ops.row_gather``'s ``form``),
        then one dequantizing multiply."""
        return self._dequantize(row_gather(self.q, ids, form=form))

    def fanout_mean(self, ids: torch.Tensor, n_roots: int, fanout: int,
                    summean: bool = True) -> torch.Tensor:
        """``(n_roots, d)`` means of the flat ``ids``' rows in groups of
        ``fanout``, in the compute dtype. ``summean``: the exact int32 sum
        of the raw rows times ``scale / fanout``; otherwise each row
        dequantized, then the f32 mean (the reference's
        ``int8_summean=False``)."""
        flat = ids.reshape(-1).to(torch.int32).contiguous()
        if flat.shape[0] != n_roots * fanout:
            raise ValueError(f"{flat.shape[0]} ids are not {n_roots} roots x {fanout}")
        return gather_fanout_mean_int8(self.q, self.scale, flat, fanout, self.out_dtype,
                                       summean=summean)

    def dequantize(self) -> torch.Tensor:
        """The whole table in the compute dtype (exact inference)."""
        return self._dequantize(self.q)


def column_scales(feats: np.ndarray) -> np.ndarray:
    """``scale[j] = max|feats[:, j]| / 127`` (1.0 for all-zero columns), f32."""
    absmax = np.abs(np.asarray(feats, dtype=np.float32)).max(axis=0)
    return np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)


def quantize_rows(feats: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Rows of float features → int8 at the given per-column scales: each
    value rounds to the nearest step, so its error is at most ``scale[j]/2``."""
    return np.clip(np.rint(np.asarray(feats, dtype=np.float32) / scale), -127, 127).astype(np.int8)


def quantize_np(feats: np.ndarray):
    """Host-side: float features → ``(q int8, scale float32)`` numpy pair
    (``quantize_rows`` at ``column_scales``)."""
    scale = column_scales(feats)
    return quantize_rows(feats, scale), scale


def quantize_feats(feats: np.ndarray, out_dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device = "cuda") -> QuantizedFeats:
    """Host-side quantization, then the int8 table and its scales uploaded
    to ``device``."""
    q, scale = quantize_np(feats)
    device = torch.device(device)
    return QuantizedFeats(torch.from_numpy(q).to(device).contiguous(),
                          torch.from_numpy(scale).to(device), out_dtype=out_dtype)
