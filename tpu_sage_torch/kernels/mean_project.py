"""Fanout mean + projection: ``out = mean(x, axis=1) @ W``.

Counterpart of ``tpu_sage/kernels/mean_project.py::mean_project``: ``x (B, F,
D)`` and ``W (D, O)``, W bf16 or f32, x of W's dtype or f32 (the f32 rows of
a linear or node-embedding prep under a bf16 model); output in ``W.dtype``.
The contract is the reference's, rounding included::

    out = to(W.dtype)( to(W.dtype)(mean_f32(x, axis=1)) @ W )

the mean summed in f32 in the order j = 0, 1, ..., divided by F and rounded
once to ``W.dtype`` (as ``jnp.mean`` of a bf16 tile returns it; for f32 rows,
as the JAX package's ``fc_neigh(jnp.mean(x))`` casts the mean), the product
accumulated in f32 and rounded once. For f32 both roundings are no-ops.

The forward on a CUDA tensor launches ``csrc/mean_project.cu`` (bf16 W:
persistent blocks that stage W once and walk tiles of roots, x streamed into
shared memory with bulk asynchronous copies, or ``cp.async`` words when it
is not 16-byte aligned, and the product on the tensor cores; f32: persistent
blocks whose warps stream x's column chunks into registers and reduce them,
while W streams through a ring of bulk copies and the product runs in exact
f32 on the SIMT units, chunk by chunk); on a CPU tensor it runs
``mean_project_reference``.
The backward is the reference's (computed outside Pallas there too), two
plain products with ``meanx`` recomputed in W's dtype, each only when its
input needs a gradient, ``dx`` divided in x's dtype::

    dW = meanx^T @ g
    dx = broadcast(g @ W^T) / F
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tpu_sage_torch.kernels._build import launch, library, require
from tpu_sage_torch.kernels.gather_mean import fanout_sum_mean


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "tsg_mean_project_bf16": (_P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _LL, _P),
    "tsg_mean_project_f32": (_P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _LL, _P),
}
_MAX_SMEM_BYTES = 232_448  # per-block shared memory on Hopper

# the bf16 kernel's compile-time shape (csrc/mean_project.cu)
_WARPS, _STAGES, _KC, _BAR_BYTES = 16, 3, 64, 128
_MAX_D, _MAX_O = 2048, 1024
_MAX_ITEMS = 8 * _WARPS  # product items: (16 output columns, 8 roots, half of K)
# x slots, measured on the H100 (PERF.md): up to 32 KB with one tile a
# block, where W stays resident beside slots of at least 16 KB; up to 48 KB
# with several tiles a block, where W stays resident only beside slots of at
# least 32 KB, else the ring's larger slots win. Beside a W ring, a slot of
# 5/6 the size is taken when it leaves room for a buffer that saves a pass
# over W (each pass waits for its chunks from L2)
_ONE_TILE = dict(slot=32768, min_slot=16384)
_TILES = dict(slot=49152, min_slot=32768)


def _ceil(a: int, m: int) -> int:
    return -(-a // m) * m


def _layout(f: int, d: int, o_pad: int, row: int, step: int, tb: int, slot: int,
            min_slot: int) -> dict | None:
    """The block's shared memory at ``tb`` roots a tile: W resident beside
    an x ring of slots of up to ``slot`` bytes when they can hold
    ``min_slot``, else a ring of W chunk buffers beside slots of ``slot``
    bytes, or smaller ones where no W buffer would fit (a slot holds at most
    a tile's rows); None when ``tb`` does not fit at all. Offsets and slots
    are 128-byte multiples (``Layout`` in the source)."""
    n_mt, n_nt = o_pad // 16, -(-tb // 8)
    ksplit = 2 if n_mt * n_nt <= 8 else 1
    if n_mt * n_nt * ksplit > _MAX_ITEMS:
        return None
    ms = _ceil(_ceil(d, 16) // 2, 32) + 4  # mean row stride, 32-bit words
    fixed = _ceil(_BAR_BYTES + tb * ms * 4 + (n_mt * n_nt * 512 if ksplit == 2 else 0), 128)
    n_chunks = -(-d // _KC)

    def ring(slot_max):
        g = min(max(0, slot_max) // row, _ceil(tb * f, step)) // step * step
        g = max(g, step)
        return g, _ceil(g * row, 128)

    w_all = d * 2 * o_pad
    g_rows, x_slot = ring(min(slot, (_MAX_SMEM_BYTES - fixed - w_all) // _STAGES))
    if x_slot >= min_slot and fixed + _STAGES * x_slot + w_all <= _MAX_SMEM_BYTES:
        return dict(tb=tb, ksplit=ksplit, g_rows=g_rows, n_wbufs=n_chunks, resident=True,
                    smem=fixed + _STAGES * x_slot + w_all)

    def w_ring(target):  # W in a ring of chunk buffers beside slots of `target` bytes
        g, x = ring(target)
        n_wbufs = min(n_chunks, (_MAX_SMEM_BYTES - fixed - _STAGES * x) // (_KC * 2 * o_pad))
        return (-(-n_chunks // n_wbufs), -x, g, n_wbufs) if n_wbufs >= 1 else None

    rings = [r for r in map(w_ring, (slot, slot * 5 // 6)) if r] or \
        [r for r in map(w_ring, (slot // 2, slot // 4, 0)) if r][:1]
    if not rings:
        return None
    _, neg_slot, g_rows, n_wbufs = min(rings)  # fewest passes over W, then the larger slot
    w_bytes = w_all if n_wbufs == n_chunks else n_wbufs * _KC * 2 * o_pad
    return dict(tb=tb, ksplit=ksplit, g_rows=g_rows, n_wbufs=n_wbufs,
                resident=n_wbufs == n_chunks, smem=fixed + _STAGES * -neg_slot + w_bytes)


def bf16_plan(b: int, f: int, d: int, o: int, x_ptr: int, x_bytes: int = 2,
              n_sm: int = 132) -> dict:
    """Launch shape of the bf16 kernel for ``x (b, f, d)`` of ``x_bytes``-byte
    elements (2: bf16, 4: f32) at address ``x_ptr`` and a bf16 ``W (d, o)``
    on a card of ``n_sm`` SMs: the persistent ``grid`` (``min(ceil(b / 4),
    n_sm)`` blocks, each an even share of the 4-root units), the roots per
    tile ``tb`` (4 while ``b`` fits one 4-root unit per SM, so a block owns
    one tile, as on the main path; else 16, or 8 or 4 where 16 does not
    fit), the copy word for x (16 bytes, a bulk copy per stage, when it
    divides the address and a 4-root unit of ``4·f·d·x_bytes`` bytes, else
    8- or 4-byte cp.async words), the x rows per ring stage (``16`` divides
    a stage's bytes), W's columns padded to a power of two ``o_pad``,
    whether W is resident or a ring of ``n_wbufs`` chunk buffers, the
    product's K split and the shared memory. A pure function of its
    arguments; raises for what the kernel does not take."""
    if d > _MAX_D or o > _MAX_O:
        raise ValueError(f"mean_project bf16 kernel takes D <= {_MAX_D} and O <= {_MAX_O}, "
                         f"got D={d}, O={o}")
    row = d * x_bytes
    word = next((w for w in (16, 8, 4) if x_ptr % w == 0 and (4 * f * row) % w == 0), None)
    if word is None:
        raise ValueError("mean_project bf16 kernel needs x 4-byte aligned")
    step = 16 // math.gcd(row, 16)  # fewest rows whose bytes 16 divides
    o_pad = max(16, 1 << (o - 1).bit_length())
    units = -(-b // 4)
    one_tile = units <= n_sm
    for tb in (4,) if one_tile else (16, 8, 4):
        lay = _layout(f, d, o_pad, row, step, tb, **(_ONE_TILE if one_tile else _TILES))
        if lay is not None:
            return dict(word=word, o_pad=o_pad, grid=max(1, min(units, n_sm)), **lay)
    raise ValueError(f"mean_project bf16 kernel: D={d}, O={o} do not fit in shared memory")


# the f32 kernel's compile-time shape (csrc/mean_project.cu): 16 warps, one
# producer of W, 4 product warps, 11 reducer warps; the rings' barriers; the
# K split's partial tiles
_F32_PROD, _F32_RED, _F32_BAR_BYTES, _F32_RED_BYTES = 4, 11, 512, 4 * 32 * 16 * 4
_F32_MAX_NI = 4  # product items a product warp: (4 roots, 128 columns) each
# roots a tile at most: at 6,144 roots (47 a block) tiles of 16 streamed x
# faster than one tile of 48 on the H100 (PERF.md)
_F32_MAX_TB = 16
# Shared memory the f32 kernel keeps within where x paces it: 196 KB, the
# largest carve-out below the maximum, leaves the L1 some 60 KB for the
# lines of x's 8-byte cp.async copies in flight; at 6,144 roots blocks
# above it ran 8-20 % slower on the H100, while at 512 roots, where W's
# stream paces a 4-root tile, a W ring twice as deep beyond it was 8 %
# faster (PERF.md)
_F32_L1_SMEM_BYTES = 196 * 1024
_F32_MAX_O = _F32_PROD * _F32_MAX_NI * 128  # one 4-root group's items at most


def f32_plan(b: int, f: int, d: int, o: int, x_ptr: int, n_sm: int = 132) -> dict:
    """Launch shape of the f32 kernel for ``x (b, f, d)`` f32 at address
    ``x_ptr`` and an f32 ``W (d, o)`` on a card of ``n_sm`` SMs: the
    persistent ``grid`` (``min(b, n_sm)`` blocks, each an even share of the
    roots), the roots per tile ``tb`` (a multiple of 4, at most 16: the
    largest share rounded up while the product's items of 4 roots and 128
    columns fit the 4 product warps, so a block owns one tile at the main
    path's 512 roots and three at the NCE step's 6,144), the x word ``v`` (2: float2,
    when ``d`` is even and x 8-byte aligned; else 1) and chunk width ``kc =
    32 v``, the x rows ``fb`` of a reducer's batch (``min(f, 32)``, fewer
    only where shared memory runs short), W's columns padded to a multiple of
    4 ``o_pad``, the K split ``ks`` (4 or 2 when there are 1 or 2 items, so
    every product warp works) and ``ni`` items a product warp, ``ms`` mean
    slots (enough that the 11 reducer warps never wait on a slot two uses
    back), the W ring of ``nwb`` buffers of ``kw`` rows (the most bytes,
    then the longest blocks, that keep the block within 196 KB, or failing
    that within the maximum; the maximum at once where a tile streams fewer
    x rows than W has columns) and the shared memory. A pure function of
    its arguments; raises for what the kernel does not take."""
    if b < 1 or f < 1 or d < 1 or o < 1:
        raise ValueError(f"mean_project f32 kernel needs B, F, D, O >= 1, got {(b, f, d, o)}")
    if o > _F32_MAX_O:
        raise ValueError(f"mean_project f32 kernel takes O <= {_F32_MAX_O}, got O={o}")
    if x_ptr % 4:
        raise ValueError("mean_project f32 kernel needs x 4-byte aligned")
    v = 2 if d % 2 == 0 and x_ptr % 8 == 0 else 1
    kc = 32 * v
    o_pad = _ceil(o, 4)
    ncg = -(-o_pad // 128)  # 128-column groups of the output
    grid = min(b, n_sm)
    tb = min(_ceil(-(-b // grid), 4), 4 * (_F32_PROD * _F32_MAX_NI // ncg), _F32_MAX_TB)
    items = (tb // 4) * ncg
    ks = 1 if items >= _F32_PROD else _F32_PROD // items
    ni = -(-items * ks // _F32_PROD)
    ms = -(-_F32_RED // tb) + 1
    mean_bytes = ms * tb * kc * 4
    red_bytes = _F32_RED_BYTES if ks > 1 else 0
    # a tile that streams fewer x rows than W has columns (B = 512: 100
    # rows against 128) is W's to pace: its W ring takes all the room
    limits = (_MAX_SMEM_BYTES,) if tb * f < o_pad else (_F32_L1_SMEM_BYTES, _MAX_SMEM_BYTES)
    for limit in limits:
        for fb in sorted({min(f, 32), 16, 8, 4, 2, 1}, reverse=True):
            if fb > min(f, 32):
                continue
            fixed = _F32_BAR_BYTES + _F32_RED * 2 * fb * kc * 4 + mean_bytes + red_bytes
            # the W ring: the most bytes in flight, then the longest blocks
            rings = [(nwb * kw, kw, nwb) for kw in (kc >> s for s in range(kc.bit_length()))
                     for nwb in (4, 3, 2) if fixed + nwb * kw * o_pad * 4 <= limit]
            if rings:
                _, kw, nwb = max(rings)
                return dict(v=v, kc=kc, fb=fb, o_pad=o_pad, tb=tb, grid=grid, ks=ks, ni=ni,
                            ms=ms, kw=kw, nwb=nwb, smem=fixed + nwb * kw * o_pad * 4)
    raise ValueError(f"mean_project f32 kernel: O={o} does not fit in shared memory")


def mean_project_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward: f32 mean rounded to ``w.dtype``,
    f32 product, rounded to ``w.dtype``."""
    meanx = fanout_sum_mean(x).to(w.dtype)
    return (meanx.float() @ w.float()).to(w.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _forward_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"mean_project runs on cuda or cpu, got {x.device}")
    require(w, "w", device=x.device, dtypes=(torch.bfloat16, torch.float32), ndim=2)
    require(x, "x", device=x.device, dtypes=tuple({w.dtype, torch.float32}), ndim=3)
    b, f, d = x.shape
    if f == 0:
        raise ValueError("mean_project needs a fanout of at least 1")
    if w.shape[0] != d:
        raise ValueError(f"w has {w.shape[0]} rows, x has width {d}")
    o = w.shape[1]
    lib = library("mean_project", _SIGNATURES)
    if w.dtype == torch.float32:
        out = torch.empty((b, o), dtype=x.dtype, device=x.device)
        if out.numel() == 0:
            return out
        plan = f32_plan(b, f, d, o, x.data_ptr(), _sm_count(x.device))
        if plan["o_pad"] != o or w.data_ptr() % 16:
            # the kernel copies W rows of o_pad columns from a 16-byte-aligned base
            w = torch.nn.functional.pad(w, (0, plan["o_pad"] - o))
        launch(lib.tsg_mean_project_f32, x.data_ptr(), w.data_ptr(), out.data_ptr(), b, f, d, o,
               plan["o_pad"], plan["v"], plan["fb"], plan["tb"], plan["grid"], plan["ms"],
               plan["kw"], plan["nwb"], plan["ni"], plan["smem"], device=x.device,
               kernel="mean_project")
        return out
    if b == 0 or o == 0:
        return torch.empty((b, o), dtype=w.dtype, device=x.device)
    plan = bf16_plan(b, f, d, o, x.data_ptr(), x.element_size(), _sm_count(x.device))
    o_pad = plan["o_pad"]
    if o_pad != o or w.data_ptr() % 16:
        # the kernel reads W rows of o_pad columns from a 16-byte-aligned base
        w = torch.nn.functional.pad(w, (0, o_pad - o))
    out = torch.empty((b, o_pad), dtype=w.dtype, device=x.device)
    launch(lib.tsg_mean_project_bf16, x.data_ptr(), w.data_ptr(), out.data_ptr(), b, f, d, o_pad,
           x.element_size(), plan["word"], plan["g_rows"], plan["n_wbufs"], plan["tb"],
           plan["grid"], plan["ksplit"], plan["smem"], device=x.device, kernel="mean_project")
    return out if o_pad == o else out[:, :o].contiguous()


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
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dw = x.mean(dim=1).to(w.dtype).t() @ g
        if ctx.needs_input_grad[0]:
            dx = ((g @ w.t()).to(x.dtype) / x.shape[1]).unsqueeze(1).expand_as(x)
        return dx, dw


def mean_project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (B, F, D)`` of ``w``'s dtype or f32, ``w (D, O)`` → ``(B, O)`` in
    ``w.dtype``."""
    return _MeanProject.apply(x, w)
