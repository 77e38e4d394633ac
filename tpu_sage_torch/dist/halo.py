"""Distributed row gather (halo exchange) over a node-sharded table
(counterpart of ``tpu_sage/dist/halo.py``).

Each rank holds the rows ``[r·m, (r+1)·m)`` of a table (features, adjacency
‖ degree, activations) and asks for rows by global id. Every function
returns, for the same shard-local tables and ids, what the JAX package's
``shard_map`` form returns:

- ``dist_gather`` (exact): the int32 ids are all-gathered
  (``all_gather_into_tensor``); each rank answers every rank's queries with
  one ``gather_rows(table, ids − offset, oob="zero")`` launch (ids outside
  its range give zero rows, JAX's ``where(owned, rows, 0)``); the answers go
  back with ``all_to_all_single``, and the requester sums the ``world``
  partial answers in rank order. Each id has one owner, so the sum is
  ``table[ids]`` bitwise.
- ``dist_gather_fanout_mean``: the same, but the owner pre-reduces its rows
  to per-root f32 partial means (``gather_fanout_mean_owned``) and ships
  ``(q/F, d)`` f32 instead of ``(q, d)`` rows; the requester sums the
  partials in rank order (JAX's ``psum_scatter`` sums in another order: the
  means agree within f32 rounding).
- ``dist_gather_ring_pipelined`` (with ``dist_gather_ring`` and
  ``dist_gather_ring_fanout_mean`` as its one-level forms): ids ‖ answers
  rotate to ``(r+1) % n`` and arrive from ``(r−1) % n``
  (``batch_isend_irecv``), hop-major over the levels, each rank filling the
  rows it owns as a buffer passes; the pre-reduced level accumulates the
  owners' partial means in the ring's order, as in JAX.
- ``dist_gather_bucketed``: local queries answered locally, remote ones
  routed by owner into ``(n, capacity)`` buckets with ``all_to_all_single``
  and answered back the same way; queries past the capacity get
  ``fallback_row`` (zeros) and are counted.
- ``CSRAdjRows``/``CSRPairRows``: virtual ``(m, w)`` adjacency tables built
  from a CSR shard on demand, which every exchange takes in place of a
  tensor; ``dist_sample_csr_owner_select`` moves the sampling hop's column
  pick to the owner and ships ``fanout + 1`` ints per query.

- ``dist_gather_2d`` (``hier2d``): over a 2-D ``(host, chip)`` layout
  (``mesh.Layout2D``), the ids all-gathered over the rank's host column,
  then over its chip row (the ``(C, H, q)`` queries), one owner answer of
  them all, then the answers reduced within the host (over the chip row)
  before across hosts (over the host column), each reduction an
  ``all_to_all_single`` and a sum in rank order. Bitwise ``dist_gather``;
  with ``fanout`` the owners' f32 partial means, summed in two stages.

Collectives move bf16 and int8 tensors as they are (NCCL and gloo both take
them). At world 1 every collective still runs (through NCCL on the card),
except the ring's rotation to the rank itself, which is the identity.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tpu_sage_torch.dist.mesh import rank, shard_offset, world
from tpu_sage_torch.kernels.gather import gather_rows
from tpu_sage_torch.kernels.gather_mean import gather_fanout_mean_owned
from tpu_sage_torch.kernels.select import select_columns, select_hop
from tpu_sage_torch.ops import row_gather
from tpu_sage_torch.sample.csr import gather_window_pair

_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """``(n·q, ...)``: every rank's ``x (q, ...)`` in rank order, over the
    ``n`` ranks of ``group`` (default: the world)."""
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    _all_gather(out, x.contiguous(), group=group)
    return out


def exchange(send: torch.Tensor, group=None) -> torch.Tensor:
    """``all_to_all_single`` in equal parts along dim 0: block ``s`` of
    ``send`` goes to rank ``s`` of ``group`` (default: the world); block
    ``s`` of the result came from rank ``s``."""
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send.contiguous(), group=group)
    return recv


def reduce_scatter(parts: torch.Tensor, group=None) -> torch.Tensor:
    """Block ``s`` of ``parts (n·k, ...)`` summed over the ``n`` ranks of
    ``group`` onto its rank ``s``, in rank order: ``(k, ...)``. gloo has
    no ``reduce_scatter``, so it is an exchange and a sum."""
    n = dist.get_world_size(group)
    return rank_sum(exchange(parts, group).view(n, parts.shape[0] // n, *parts.shape[1:]))


def rank_sum(parts: torch.Tensor) -> torch.Tensor:
    """Sum of ``parts (world, ...)`` over dim 0, in rank order."""
    acc = parts[0]
    for s in range(1, parts.shape[0]):
        acc = acc + parts[s]
    return acc


def owner_rows(table, local_ids: torch.Tensor) -> torch.Tensor:
    """``table[local_ids]`` with zero rows for ids outside ``[0, m)``: one
    ``gather_rows`` launch for a tensor; a virtual CSR table builds its rows."""
    if isinstance(table, CSRAdjRows):
        return table.rows(local_ids)
    return gather_rows(table, local_ids.to(torch.int32).contiguous(), oob="zero")


class CSRAdjRows:
    """Shard-local virtual ``(m, window+1)`` adjacency ‖ degree table built
    from CSR storage (``indptr (m+1,)``, ``indices (r, window)``): each row
    is the window hop's aligned window (the two covering rows of
    ``indices``, shifted by the offset with ``select_columns``) and the
    degree. The first ``deg`` slots equal the dense ``adj ‖ deg`` rows'."""

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor, degrees: torch.Tensor,
                 window: int):
        self.indptr = indptr
        self.indices = indices
        self.degrees = degrees
        self.window = window

    @property
    def shape(self):
        return (self.degrees.shape[0], self.window + 1)

    @property
    def dtype(self):
        return self.indices.dtype

    def _pair(self, local_ids: torch.Tensor):
        m = self.degrees.shape[0]
        ok = ((local_ids >= 0) & (local_ids < m))[:, None]
        flat = local_ids.clamp(0, m - 1).to(torch.int32).contiguous()
        pair, off, _ = gather_window_pair(self.indptr, self.indices, flat, self.window)
        return ok, flat, pair, off

    def rows(self, local_ids: torch.Tensor) -> torch.Tensor:
        ok, flat, pair, off = self._pair(local_ids)
        cols = off[:, None] + torch.arange(self.window, dtype=torch.int32, device=off.device)
        win = select_columns(pair, cols.contiguous())
        out = torch.cat([win, row_gather(self.degrees, flat)[:, None]], dim=1)
        return torch.where(ok, out, 0)


class CSRPairRows(CSRAdjRows):
    """The shipped CSR view: raw ``lo ‖ hi ‖ off ‖ deg`` rows,
    ``(m, 2·window + 2)``; the requester selects ``off + col``
    (``sample_level_distributed(pair_window=)``), ``window/fanout`` times
    less select work than aligning every row at the owner."""

    @property
    def shape(self):
        return (self.degrees.shape[0], 2 * self.window + 2)

    def rows(self, local_ids: torch.Tensor) -> torch.Tensor:
        ok, flat, pair, off = self._pair(local_ids)
        deg = row_gather(self.degrees, flat)
        out = torch.cat([pair, off[:, None].to(torch.int32), deg[:, None]], dim=1)
        return torch.where(ok, out, 0)


def dist_sample_csr_owner_select(
    indptr: torch.Tensor, indices: torch.Tensor, degrees: torch.Tensor, window: int,
    ids: torch.Tensor, u: torch.Tensor,
) -> torch.Tensor:
    """CSR sampling hop with the column pick at the owner: the requester's
    ``u (q, fanout)`` rides the ids' all-gather (bit-cast to int32, one
    collective), the owner picks ``min(trunc(u·deg), deg−1)`` of each owned
    query's row and answers ``fanout`` values ‖ the degree. Returns ``(q,
    fanout + 1)`` int32, the values bitwise those of the pair answers."""
    m = degrees.shape[0]
    offset = shard_offset(m)
    packed = torch.cat([ids.to(torch.int32)[:, None], u.contiguous().view(torch.int32)], dim=1)
    allp = all_gather_rows(packed)
    all_ids, all_u = allp[:, 0], allp[:, 1:].contiguous().view(torch.float32)
    local = all_ids - offset
    owned = ((local >= 0) & (local < m))[:, None]
    local_idx = local.clamp(0, m - 1).to(torch.int32).contiguous()
    r_deg = row_gather(degrees, local_idx)
    pair, off, _ = gather_window_pair(indptr, indices, local_idx, window)
    vals = select_hop(pair, r_deg, all_u, shift=off)
    return reduce_scatter(torch.where(owned, torch.cat([vals, r_deg[:, None]], dim=1), 0))


def dist_gather(local_table, ids: torch.Tensor) -> torch.Tensor:
    """Exact distributed gather: ``(q, w)`` rows for global ``ids (q,)``,
    each equal to ``global_table[ids]`` (zero rows for ids no rank owns)."""
    m = local_table.shape[0]
    all_ids = all_gather_rows(ids.to(torch.int32))
    return reduce_scatter(owner_rows(local_table, all_ids - shard_offset(m)))


def dist_gather_fanout_mean(local_table: torch.Tensor, ids: torch.Tensor,
                            fanout: int) -> torch.Tensor:
    """Halo gather + per-root fanout mean: ``(q/fanout, d)`` f32, the mean
    of ``global_table[ids]`` over each root's ``fanout`` rows (of an int8
    table's raw values; the caller applies its scale). Each owner ships its
    partial means, ``fanout×`` less than the rows."""
    m = local_table.shape[0]
    all_ids = all_gather_rows(ids.to(torch.int32))
    return reduce_scatter(gather_fanout_mean_owned(local_table, all_ids, fanout,
                                                   shard_offset(m)))


def dist_gather_2d(local_table, ids: torch.Tensor, layout,
                   fanout: Optional[int] = None) -> torch.Tensor:
    """Hierarchical exact gather over a ``(host, chip)`` layout
    (``mesh.Layout2D``; global shard ``host·n_chips + chip``): the ids are
    all-gathered over the host column, then over the chip row, so every
    rank holds the ``(C, H, q)`` queries; it answers those it owns (zero
    rows elsewhere) in one launch; the answers are reduced within the host
    (over the chip row) and then across hosts (over the host column), so
    each rank ends with its own ``(q, w)`` rows, bitwise ``dist_gather``'s.
    With ``fanout`` the owner answers per-root f32 partial means
    (``gather_fanout_mean_owned``) and ``(q/fanout, d)`` means come back."""
    m = local_table.shape[0]
    ids_h = all_gather_rows(ids.to(torch.int32), layout.outer_group)     # (H·q,)
    all_ids = all_gather_rows(ids_h, layout.inner_group)                  # (C·H·q,)
    if fanout is None:
        answers = owner_rows(local_table, all_ids - shard_offset(m))
    else:
        answers = gather_fanout_mean_owned(local_table, all_ids, fanout, shard_offset(m))
    return reduce_scatter(reduce_scatter(answers, layout.inner_group), layout.outer_group)


def _rotate(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Send each tensor to rank ``(r+1) % n`` and receive its counterpart
    from ``(r−1) % n``, all in one batch."""
    n, me = world(), rank()
    if n == 1:
        return tensors
    recvs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, recvs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), (me + 1) % n))
        ops.append(dist.P2POp(dist.irecv, r, (me - 1) % n))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recvs


def dist_gather_ring_pipelined(local_table, ids_list: Sequence[torch.Tensor],
                               last_fanout: Optional[int] = None) -> List[torch.Tensor]:
    """Ring exchange of several query sets against one sharded table,
    hop-major: each step rotates every level's ids ‖ answers, then fills
    every level. With ``last_fanout`` the last level's answers rotate
    pre-reduced to per-root f32 means (owners' partials added in the ring's
    order). Returns per-level answers, each equal to the per-level ring's."""
    m = local_table.shape[0]
    offset = shard_offset(m)
    n_levels = len(ids_list)

    def reduced(l):
        return last_fanout is not None and l == n_levels - 1

    def fill(buf_ids, buf_ans):
        local = buf_ids - offset
        owned = ((local >= 0) & (local < m))[:, None]
        return torch.where(owned, owner_rows(local_table, local), buf_ans)

    def contrib(buf_ids):
        return gather_fanout_mean_owned(local_table, buf_ids, last_fanout, offset)

    bufs = []
    for l, ids in enumerate(ids_list):
        ids = ids.to(torch.int32).contiguous()
        bufs.append([ids, contrib(ids) if reduced(l) else owner_rows(local_table, ids - offset)])
    for _ in range(world() - 1):
        moved = _rotate([t for b in bufs for t in b])
        for l, b in enumerate(bufs):
            b[0], b[1] = moved[2 * l], moved[2 * l + 1]
        for l, b in enumerate(bufs):
            b[1] = (b[1] + contrib(b[0])) if reduced(l) else fill(b[0], b[1])
    return _rotate([b[1] for b in bufs])


def dist_gather_ring(local_table, ids: torch.Tensor) -> torch.Tensor:
    """Ring-rotation exact gather: the one-level ``dist_gather_ring_pipelined``."""
    return dist_gather_ring_pipelined(local_table, [ids])[0]


def dist_gather_ring_fanout_mean(local_table: torch.Tensor, ids: torch.Tensor,
                                 fanout: int) -> torch.Tensor:
    """Ring counterpart of ``dist_gather_fanout_mean``: the one-level
    ``dist_gather_ring_pipelined`` with ``last_fanout``."""
    return dist_gather_ring_pipelined(local_table, [ids], last_fanout=fanout)[0]


def dist_gather_bucketed(
    local_table, ids: torch.Tensor, capacity: int,
    fallback_row: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-routed gather with a local bypass. Remote queries go to
    their owner in stable order, at most ``capacity`` per owner; the rest
    get ``fallback_row`` (zeros if None). Returns ``(rows (q, w),
    n_overflowed)`` (a 0-d int64 tensor)."""
    n, me = world(), rank()
    m = local_table.shape[0]
    q = ids.shape[0]
    ids = ids.to(torch.int32)
    offset = shard_offset(m)
    owner = torch.div(ids, m, rounding_mode="floor").clamp(0, n - 1).long()
    is_local = owner == me
    local_rows = owner_rows(local_table, (ids - offset).clamp(0, m - 1))

    # each remote query's position in its owner's bucket, in query order
    onehot = torch.nn.functional.one_hot(owner, n) * (~is_local)[:, None]
    pos = (torch.cumsum(onehot, 0) - onehot).gather(1, owner[:, None])[:, 0]
    overflowed = (pos >= capacity) & ~is_local
    n_overflow = overflowed.sum()

    send = torch.full((n * capacity,), -1, dtype=torch.int32, device=ids.device)
    keep = ~is_local & ~overflowed
    send[(owner * capacity + pos)[keep]] = ids[keep]
    recv = exchange(send)
    answers = owner_rows(local_table, torch.where(recv >= 0, recv - offset, -1))
    back = exchange(answers)
    slot = (owner * capacity + pos.clamp(max=capacity - 1)).to(torch.int32)
    gathered = gather_rows(back, slot.contiguous())
    if fallback_row is None:
        fallback_row = torch.zeros((), dtype=gathered.dtype, device=gathered.device)
    gathered = torch.where(overflowed[:, None], fallback_row, gathered)
    return torch.where(is_local[:, None], local_rows, gathered), n_overflow
