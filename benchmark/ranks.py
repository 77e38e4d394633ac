"""One rank a card: the launcher of a cell whose ``chips`` is more than one.

The calling process is rank 0. It starts ranks 1 … n−1, each a fresh
Python process (nothing is forked from a process that may hold a CUDA
context), and every rank joins one process group through the program's own
``tpu_sage_torch.dist.mesh.init_process_group``: NCCL on the card, rank r on
``cuda:r``; gloo on the CPU. Each rank runs ``fn(device, *args)`` and sends
what it returns to rank 0, which gets every rank's answer in rank order.

A watchdog thread in the launching process holds the group to one time
limit. When a rank other than 0 exits with a code other than 0, or the
limit passes, it ends every rank, waits for each, names the cause on
standard error and ends the launching process with ``FAILED``: rank 0 may
be blocked in a collective that will never complete, and nothing short of
ending its process frees it. When rank 0 raises, the launcher ends the
other ranks and raises on. A rank whose launcher is gone ends itself.
Ranks other than 0 write nothing to standard output, which carries the
result line; what they print goes to standard error.
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, List, Sequence

FAILED = 4         # exit code of a launcher whose group failed
POLL_S = 0.2       # how often the watchdog looks at the ranks
CLEANUP_S = 30.0   # how long rank 0 may take to leave the group once it has raised
GRACE_S = 5.0      # from a rank's SIGTERM to its SIGKILL
# a rank other than 0: take the launcher's import path from standard input,
# then the job (whose function is imported by name), and run the rank
BOOT = ("import pickle, sys; boot = pickle.load(sys.stdin.buffer); sys.path[:] = boot['path']; "
        "from benchmark import ranks; ranks.child(pickle.loads(boot['job']))")


def end(procs: Sequence[subprocess.Popen]) -> None:
    """Terminate every process of ``procs`` still running, kill any that
    outlives ``GRACE_S``, and wait for each."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    stop = time.monotonic() + GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(0.0, stop - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


class Watchdog(threading.Thread):
    """Ends the group when a rank fails or the limit passes (see the module's
    docstring)."""

    def __init__(self, procs: List[subprocess.Popen], limit_s: float, store: str):
        super().__init__(name="benchmark-ranks-watchdog", daemon=True)
        self.procs = procs
        self.deadline = time.monotonic() + limit_s
        self.store = store
        self.ending = False  # rank 0 raised and ends the others itself
        self.done = threading.Event()

    def run(self) -> None:
        while not self.done.wait(POLL_S):
            for r, p in enumerate(self.procs, start=1):
                code = p.poll()
                if code and not self.ending:
                    self.fail(f"rank {r} exited with code {code}")
            if time.monotonic() > self.deadline:
                self.fail("the group overran its time limit")

    def fail(self, why: str) -> None:
        print(f"benchmark: {why}; every rank ended, no result", file=sys.stderr, flush=True)
        end(self.procs)
        shutil.rmtree(self.store, ignore_errors=True)
        os._exit(FAILED)


def _join(job: dict, rank: int):
    """Join the group as ``rank``; returns this rank's device."""
    from tpu_sage_torch.dist import mesh

    return mesh.init_process_group(job["device"], rank=rank, world_size=job["world"],
                                   init_method=job["init"], local_rank=rank,
                                   local_world_size=job["world"])


def _answer(job: dict, device, gathered) -> None:
    import torch.distributed as dist

    dist.gather_object(job["fn"](device, *job["args"]), gathered, dst=0)


def _orphaned(parent: int) -> None:
    while True:
        time.sleep(1.0)
        if os.getppid() != parent:
            os._exit(FAILED)


def child(job: dict) -> None:
    """Rank ``job["rank"]`` (1 … n−1), in a process the launcher started."""
    from tpu_sage_torch.dist import mesh

    threading.Thread(target=_orphaned, args=(job["parent"],), daemon=True).start()
    device = _join(job, job["rank"])
    try:
        _answer(job, device, None)
    finally:
        mesh.destroy_process_group()


def run(fn: Callable, args: tuple, world: int, device_type: str, limit_s: float) -> list:
    """``fn(device, *args)`` on each of ``world`` ranks, this process rank
    0; every rank's return value, in rank order. ``fn`` must be importable
    by name, and ``args`` and what it returns picklable."""
    from tpu_sage_torch.dist import mesh

    if world < 2:
        raise ValueError(f"a group needs two ranks or more, not {world}")
    store = tempfile.mkdtemp(prefix="benchmark_ranks_")
    job = {"fn": fn, "args": args, "world": world,
           "device": device_type, "init": "file://" + os.path.join(store, "store"),
           "parent": os.getpid()}
    procs: List[subprocess.Popen] = []
    watchdog = Watchdog(procs, limit_s, store)
    try:
        for rank in range(1, world):
            p = subprocess.Popen([sys.executable, "-c", BOOT], stdin=subprocess.PIPE,
                                 stdout=2)
            procs.append(p)
            p.stdin.write(pickle.dumps({"path": list(sys.path),
                                        "job": pickle.dumps({**job, "rank": rank})}))
            p.stdin.close()
        watchdog.start()
        device = _join(job, 0)
        gathered = [None] * world
        try:
            _answer(job, device, gathered)
        except BaseException:
            watchdog.ending = True
            for rank, p in enumerate(procs, start=1):
                if p.poll():
                    print(f"benchmark: rank {rank} exited with code {p.returncode}",
                          file=sys.stderr, flush=True)
            end(procs)  # no rank waits on this one any more
            watchdog.deadline = min(watchdog.deadline, time.monotonic() + CLEANUP_S)
            raise
        finally:
            mesh.destroy_process_group()
        for rank, p in enumerate(procs, start=1):
            code = p.wait(timeout=max(0.0, watchdog.deadline - time.monotonic()))
            if code:
                raise RuntimeError(f"rank {rank} exited with code {code}")
        return gathered
    finally:
        watchdog.done.set()
        if watchdog.is_alive():
            watchdog.join()
        end(procs)
        shutil.rmtree(store, ignore_errors=True)
