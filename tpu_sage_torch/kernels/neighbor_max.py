"""Degree-masked neighbour max: the exact pass's max-pool summary.

``out[v] = max_{j < deg(v)} neigh[v, j]`` per feature, and ``self_rows[v]``
where ``deg(v) == 0``. The JAX package leaves this to XLA
(``tpu_sage/nn/full_graph.py``: the padding columns filled with
``finfo.min``, then ``max``); it has no Pallas kernel. One kernel,
``csrc/neighbor_max.cu``, reads each node's true rows once and never the
padding columns, with the result of the masked form on every input (NaN
included). On a CPU tensor the wrapper runs ``neighbor_max_reference``.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_sage_torch.kernels._build import launch, library


_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    "tsg_neighbor_max": (_P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _I, _I, _I, _P),
}
DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256  # threads a block of csrc/neighbor_max.cu: one node


def neighbor_max_reference(neigh: torch.Tensor, degrees: torch.Tensor,
                           self_rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``neighbor_max``: columns ``>= degree``
    filled with ``finfo.min``, ``amax`` over the neighbours, and the node's
    own row where its degree is 0."""
    past = torch.arange(neigh.shape[1], device=neigh.device) >= degrees[:, None]
    filled = neigh.masked_fill(past[:, :, None], torch.finfo(neigh.dtype).min)
    return torch.where(degrees[:, None] == 0, self_rows, filled.amax(dim=1))


def neighbor_max_plan(row_bytes: int, elem_bytes: int, *offsets: int) -> dict:
    """How ``csrc/neighbor_max.cu`` cuts a row of ``row_bytes``: into 16-byte
    words where the row and every byte offset in ``offsets`` (the base
    addresses and the strides) are 16-byte multiples, else into single
    elements; ``lanes`` threads (a power of two, at most ``THREADS``) cover
    a row's words, and the block's ``THREADS // lanes`` groups split the
    neighbour axis."""
    word = 16 if all(b % 16 == 0 for b in (row_bytes, *offsets)) else elem_bytes
    words = row_bytes // word
    return {"word": word, "lanes": min(THREADS, 1 << max(words - 1, 0).bit_length())}


def check_args(neigh: torch.Tensor, degrees: torch.Tensor, self_rows: torch.Tensor) -> None:
    """Raise on what the kernel does not take: ``neigh (rows, max_degree,
    w)`` f32 or bf16 with contiguous rows and ``max_degree >= 1``,
    ``degrees (rows,)`` int32 contiguous, ``self_rows (rows, w)`` of
    ``neigh``'s dtype with contiguous rows, all on one device."""
    if neigh.dtype not in DTYPES:
        raise TypeError(f"neigh has dtype {neigh.dtype}, expected one of {DTYPES}")
    if neigh.dim() != 3 or neigh.shape[1] < 1:
        raise ValueError(f"neigh must be (rows, max_degree >= 1, w), got {tuple(neigh.shape)}")
    rows, _, w = neigh.shape
    if degrees.dtype != torch.int32:
        raise TypeError(f"degrees has dtype {degrees.dtype}, expected torch.int32")
    if tuple(degrees.shape) != (rows,) or not degrees.is_contiguous():
        raise ValueError(f"degrees must be contiguous ({rows},), got {tuple(degrees.shape)}")
    if self_rows.dtype != neigh.dtype:
        raise TypeError(f"self_rows has dtype {self_rows.dtype}, expected {neigh.dtype}")
    if tuple(self_rows.shape) != (rows, w):
        raise ValueError(f"self_rows must be {(rows, w)}, got {tuple(self_rows.shape)}")
    if neigh.stride(2) != 1 or self_rows.stride(1) != 1:
        raise ValueError("each row of neigh and self_rows must be contiguous")
    if not (degrees.device == self_rows.device == neigh.device):
        raise ValueError(f"neigh, degrees and self_rows are on {neigh.device}, "
                         f"{degrees.device} and {self_rows.device}")


def neighbor_max(neigh: torch.Tensor, degrees: torch.Tensor,
                 self_rows: torch.Tensor) -> torch.Tensor:
    """``neigh (rows, max_degree, w)`` f32 or bf16 (rows contiguous, node and
    neighbour strides free), ``degrees (rows,)`` int32, ``self_rows (rows,
    w)`` → ``(rows, w)`` in ``neigh``'s dtype."""
    if neigh.device.type == "cpu":
        return neighbor_max_reference(neigh, degrees, self_rows)
    if neigh.device.type != "cuda":
        raise ValueError(f"neighbor_max runs on cuda or cpu, got {neigh.device}")
    check_args(neigh, degrees, self_rows)
    rows, max_degree, w = neigh.shape
    out = torch.empty((rows, w), dtype=neigh.dtype, device=neigh.device)
    if out.numel() == 0:
        return out
    eb = neigh.element_size()
    strides = (neigh.stride(0) * eb, neigh.stride(1) * eb, self_rows.stride(0) * eb)
    plan = neighbor_max_plan(w * eb, eb, *strides, neigh.data_ptr() % 16,
                             self_rows.data_ptr() % 16, out.data_ptr() % 16)
    word = plan["word"]
    lib = library("neighbor_max", _SIGNATURES)
    launch(lib.tsg_neighbor_max, neigh.data_ptr(), degrees.data_ptr(), self_rows.data_ptr(),
           out.data_ptr(), rows, max_degree, w * eb // word, *(s // word for s in strides), eb,
           word, plan["lanes"], device=neigh.device, kernel="neighbor_max")
    return out
