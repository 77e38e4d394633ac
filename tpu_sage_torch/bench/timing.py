"""L2-cold kernel timing with CUDA events.

Before each timed call, and outside its event pair, a buffer of twice the
card's L2 (``torch.cuda.get_device_properties(0).L2_cache_size``) is written
and a second one of the same size is read, so the call finds its inputs in
device memory, as the main path does for everything bigger than L2, and a
time can be held against a bound at the memory's rate. The read leaves L2
holding clean lines, so the timed call does not pay for writing back the
flush's dirty ones. A device-side sleep after the flush lets the host
enqueue the call before the card reaches it, so host overhead stays out of
the interval.
"""

from __future__ import annotations

import torch

_FLUSH = {}


def l2_flush_buffers(device: int):
    """Two int32 buffers of twice the L2 of ``device`` each, allocated once."""
    bufs = _FLUSH.get(device)
    if bufs is None:
        l2 = torch.cuda.get_device_properties(device).L2_cache_size
        bufs = tuple(torch.zeros(2 * l2 // 4, dtype=torch.int32, device=f"cuda:{device}")
                     for _ in range(2))
        _FLUSH[device] = bufs
    return bufs


def flush_l2(device: int) -> None:
    write, read = l2_flush_buffers(device)
    write.fill_(1)
    read.amax()


def cuda_ms(fn, reps: int = 20) -> float:
    """Median L2-cold device time of ``fn()`` in ms over ``reps`` calls."""
    device = torch.cuda.current_device()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush_l2(device)
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]
