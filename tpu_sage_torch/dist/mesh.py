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
port; a rank that raises fails the parent.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist


def launched_by_torchrun() -> bool:
    """True when torchrun's environment names this process's rank."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def init_process_group(device: str | torch.device = "cuda", rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       init_method: Optional[str] = None) -> torch.device:
    """Join the process group and return this rank's device.

    Without ``rank``/``world_size``/``init_method`` they come from torchrun's
    environment (``env://``). ``device`` ``"cuda"`` binds the rank to
    ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` defaults to ``rank``) under NCCL and
    raises without a card; ``"cpu"`` runs the rank on the CPU under gloo."""
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_process_group(device='cuda') needs a CUDA device; "
                           "pass device='cpu' for the CPU")
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device}")
    if rank is None:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    local = int(os.environ.get("LOCAL_RANK", rank)) if launched_by_torchrun() else rank
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


def _rank_main(r: int, fn: Callable, world_size: int, device: str, store: str, args: tuple):
    init_process_group(device, rank=r, world_size=world_size, init_method=f"file://{store}")
    try:
        fn(*args)
    finally:
        destroy_process_group()


def spawn(fn: Callable, world_size: int, device: str = "cuda", args: tuple = (),
          store_dir: Optional[str] = None) -> None:
    """Run ``fn(*args)`` on ``world_size`` ranks, each a spawned process in
    the group, on ``device`` (each rank its own card) or the CPU. ``fn`` must
    be importable by name (spawned processes import it); it reads its rank
    from ``rank()``. The group's ``file://`` store lives in a fresh directory
    under ``store_dir`` (default: the system's temporary directory). Raises
    if a rank raises."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="tsg_dist_", dir=store_dir)
    try:
        mp.start_processes(_rank_main, args=(fn, world_size, device, os.path.join(tmp, "store"),
                                             args),
                           nprocs=world_size, join=True, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_in_process(fn: Callable, device: str = "cuda", args: tuple = ()):
    """Run ``fn(*args)`` as the single rank of a world-1 group in this
    process (the group's collectives still run, through NCCL on the card),
    and return its result."""
    tmp = tempfile.mkdtemp(prefix="tsg_dist_")
    try:
        init_process_group(device, rank=0, world_size=1,
                           init_method=f"file://{os.path.join(tmp, 'store')}")
        try:
            return fn(*args)
        finally:
            destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
