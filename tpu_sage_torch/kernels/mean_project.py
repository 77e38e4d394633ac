"""Fanout mean + projection: ``out = mean(x, axis=1) @ W``.

Counterpart of ``tpu_sage/kernels/mean_project.py::mean_project``: ``x (B, F,
D)`` and ``W (D, O)`` of one dtype (bf16 or f32), an f32 accumulator, output
in ``x.dtype``. The forward on a CUDA tensor launches ``csrc/mean_project.cu``;
on a CPU tensor it runs ``mean_project_reference``. The backward is the
reference's (computed outside Pallas there too), two plain products with
``meanx`` recomputed::

    dW = meanx^T @ g
    dx = broadcast(g @ W^T) / F
"""

from __future__ import annotations

import ctypes

import torch

from tpu_sage_torch.kernels._build import launch, library, require
from tpu_sage_torch.kernels.gather_mean import fanout_sum_mean

LAUNCHES = 0  # kernel launches since the last reset (kernels.reset_launch_counts)

_P = ctypes.c_void_p
_SIGNATURES = {
    "tsg_mean_project": (_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, _P),
}
_MAX_SMEM_BYTES = 232_448  # per-block shared memory on Hopper


def kernel_smem_bytes(d: int, o: int) -> int:
    """Shared memory the kernel's block takes: the f32 (4, D) mean tile and
    8 warps' f32 (4, O) partial products."""
    return 4 * (4 * d + 8 * 4 * o)


def mean_project_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward: f32 mean, f32 product, cast."""
    return (fanout_sum_mean(x) @ w.float()).to(x.dtype)


def _forward_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"mean_project runs on cuda or cpu, got {x.device}")
    require(x, "x", device=x.device, dtypes=(torch.bfloat16, torch.float32), ndim=3)
    require(w, "w", device=x.device, dtypes=(x.dtype,), ndim=2)
    b, f, d = x.shape
    if f == 0:
        raise ValueError("mean_project needs a fanout of at least 1")
    if w.shape[0] != d:
        raise ValueError(f"w has {w.shape[0]} rows, x has width {d}")
    o = w.shape[1]
    if kernel_smem_bytes(d, o) > _MAX_SMEM_BYTES:
        raise ValueError(f"mean_project kernel: D={d}, O={o} need {kernel_smem_bytes(d, o)} "
                         f"bytes of shared memory, more than {_MAX_SMEM_BYTES}")
    out = torch.empty((b, o), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = library("mean_project", _SIGNATURES)
    launch(lib.tsg_mean_project, x.data_ptr(), w.data_ptr(), out.data_ptr(), b, f, d, o,
           int(x.dtype == torch.bfloat16), device=x.device)
    LAUNCHES += 1
    return out


class _MeanProject(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.device.type == "cpu":
            return mean_project_reference(x, w)
        return _forward_kernel(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        meanx = x.mean(dim=1)
        dw = meanx.t() @ g
        dmean = g @ w.t()
        dx = (dmean / x.shape[1]).unsqueeze(1).expand_as(x)
        return dx, dw


def mean_project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (B, F, D)``, ``w (D, O)`` of one dtype → ``(B, O)`` in ``x.dtype``."""
    return _MeanProject.apply(x, w)
