"""Process-group bring-up and teardown (counterpart of
``tpu_sage/dist/mesh.py``).

The JAX package builds a device mesh in one process; the port runs one
process per rank. ``init_process_group`` reads torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
or takes the rank, world size and an init method from the caller, and binds
rank ``r`` to ``cuda:LOCAL_RANK`` with NCCL, or to the CPU with gloo when
the caller asks for the CPU. NCCL refuses two ranks on one card, so a run on
the card has at most ``torch.cuda.device_count()`` ranks.

``spawn`` starts the ranks of one group from a parent process with
``torch.multiprocessing`` (start method ``spawn``) and a ``file://`` init
method in a fresh temporary directory, so concurrent groups never share a
port; a rank that raises fails the parent. A multi-host group (the
exporter's ``--coordinator``) spawns this host's ranks into a ``tcp://``
group whose other ranks other hosts start.

``Layout2D`` lays the world out as a 2-D ``(outer, inner)`` grid, row-major
(rank ``= outer·n_inner + inner``, the order of the JAX package's
``P((host, chip))`` and ``lax.axis_index((host, chip))``), with the two
subgroups of each rank: its row (the ranks that share its ``outer`` index)
and its column (those that share its ``inner`` index). The hierarchical
exchange reads it as ``(host, chip)``, tensor parallelism as ``(data,
model)``. ``host_layout`` is the group's own ``(host, chip)`` shape: one row
per host (torchrun's ``LOCAL_WORLD_SIZE`` ranks, or those one process
spawned).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist


def launched_by_torchrun() -> bool:
    """True when torchrun's environment names this process's rank."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


_HOST_RANKS: Optional[int] = None  # ranks per host of the running group
_LAYOUTS: dict = {}  # (n_outer, n_inner) -> Layout2D of the running group


def init_process_group(device: str | torch.device = "cuda", rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       init_method: Optional[str] = None, local_rank: Optional[int] = None,
                       local_world_size: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device.

    Without ``rank``/``world_size``/``init_method`` they come from torchrun's
    environment (``env://``). ``device`` ``"cuda"`` binds the rank to
    ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` defaults to ``local_rank``, then to
    ``rank``) under NCCL and raises without a card; ``"cpu"`` runs the rank
    on the CPU under gloo. ``local_world_size`` (torchrun's
    ``LOCAL_WORLD_SIZE``; default: the whole world) is the ranks per host."""
    global _HOST_RANKS
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_process_group(device='cuda') needs a CUDA device; "
                           "pass device='cpu' for the CPU")
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device}")
    if rank is None:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    if launched_by_torchrun():
        local = int(os.environ["LOCAL_RANK"])
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    else:
        local = rank if local_rank is None else local_rank
    _HOST_RANKS = local_world_size or world_size
    if kind == "cuda":
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} needs cuda:{local}, but only "
                               f"{torch.cuda.device_count()} cards are visible")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init_method, rank=rank,
                                world_size=world_size)
    else:
        dev = torch.device("cpu")
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world_size)
    return dev


def destroy_process_group() -> None:
    global _HOST_RANKS
    _LAYOUTS.clear()
    _HOST_RANKS = None
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> int:
    """Ranks in the group (1 when no group is up)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def shard_offset(shard_size: int) -> int:
    """First global node id owned by this rank (``tpu_sage/dist/halo.py:40``)."""
    return rank() * shard_size


def host_layout() -> Tuple[int, int]:
    """The group's ``(hosts, ranks per host)``: torchrun's
    ``LOCAL_WORLD_SIZE``, the ranks one process spawned, or ``(1, world)``."""
    n = world()
    local = _HOST_RANKS or n
    if n % local:
        raise ValueError(f"{n} ranks do not fill hosts of {local}")
    return n // local, local


class Layout2D:
    """The world as an ``(n_outer, n_inner)`` grid, row-major. ``inner_group``
    holds this rank's row (its ``n_inner`` ranks, in ``inner`` order),
    ``outer_group`` its column (``n_outer`` ranks, in ``outer`` order).
    Build it with ``layout_2d`` on every rank alike."""

    def __init__(self, n_outer: int, n_inner: int):
        n = world()
        if n_outer * n_inner != n:
            raise ValueError(f"a ({n_outer}, {n_inner}) layout needs {n_outer * n_inner} "
                             f"ranks; the group has {n}")
        self.shape = (n_outer, n_inner)
        self.outer, self.inner = divmod(rank(), n_inner)
        # dist.new_group is collective over the whole world: every rank
        # creates every row and every column, in the same order, and keeps
        # its own (a group spanning the world is the world's own)
        rows = [list(range(o * n_inner, (o + 1) * n_inner)) for o in range(n_outer)]
        cols = [list(range(i, n, n_inner)) for i in range(n_inner)]
        self.inner_group = [self._group(r, n) for r in rows][self.outer]
        self.outer_group = [self._group(c, n) for c in cols][self.inner]

    @staticmethod
    def _group(ranks, n):
        return dist.group.WORLD if len(ranks) == n else dist.new_group(ranks)


def layout_2d(n_outer: int, n_inner: int) -> Layout2D:
    """The ``(n_outer, n_inner)`` layout of the running group, made once
    (collectively, on every rank) and kept until the group is destroyed."""
    key = (int(n_outer), int(n_inner))
    if key not in _LAYOUTS:
        _LAYOUTS[key] = Layout2D(*key)
    return _LAYOUTS[key]


def _rank_main(local: int, fn: Callable, world_size: int, device: str, init_method: str,
               args: tuple, rank_base: int = 0, local_world_size: Optional[int] = None):
    init_process_group(device, rank=rank_base + local, world_size=world_size,
                       init_method=init_method, local_rank=local,
                       local_world_size=local_world_size)
    try:
        fn(*args)
    finally:
        destroy_process_group()


def spawn(fn: Callable, world_size: int, device: str = "cuda", args: tuple = (),
          store_dir: Optional[str] = None, *, init_method: Optional[str] = None,
          n_local: Optional[int] = None, rank_base: int = 0) -> None:
    """Run ``fn(*args)`` on ``world_size`` ranks, each a spawned process in
    the group, on ``device`` (each rank its own card) or the CPU. ``fn`` must
    be importable by name (spawned processes import it); it reads its rank
    from ``rank()``. The group's ``file://`` store lives in a fresh directory
    under ``store_dir`` (default: the system's temporary directory). Raises
    if a rank raises.

    Multi-host: with ``init_method`` (``tcp://host:port``) this process
    spawns ``n_local`` ranks, ``rank_base`` to ``rank_base + n_local − 1``,
    of a ``world_size`` group whose other ranks other processes start."""
    import torch.multiprocessing as mp

    n_local = world_size if n_local is None else n_local
    tmp = tempfile.mkdtemp(prefix="tsg_dist_", dir=store_dir)
    try:
        method = init_method or f"file://{os.path.join(tmp, 'store')}"
        mp.start_processes(_rank_main, args=(fn, world_size, device, method, args, rank_base,
                                             n_local),
                           nprocs=n_local, join=True, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_in_process(fn: Callable, device: str = "cuda", args: tuple = (), *, rank: int = 0,
                   world_size: int = 1, init_method: Optional[str] = None):
    """Run ``fn(*args)`` as one rank of a group in this process and return
    its result: by default the single rank of a world-1 group (its
    collectives still run, through NCCL on the card); with ``init_method``
    (``tcp://host:port``) rank ``rank`` of ``world_size`` ranks, one per
    process (a host of one rank)."""
    tmp = tempfile.mkdtemp(prefix="tsg_dist_")
    try:
        init_process_group(device, rank=rank, world_size=world_size,
                           init_method=init_method or f"file://{os.path.join(tmp, 'store')}",
                           local_rank=0 if init_method else rank,
                           local_world_size=1 if init_method else world_size)
        try:
            return fn(*args)
        finally:
            destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
