"""A short profiled stretch of steps after the measured window, and what
the per-layer readers take from it.

``torch.profiler`` records the host's operations and the CUDA runtime calls
(CUPTI) beside the device's kernels, copies and sets on one clock. The
stretch is timed on the host too; the profiler slows a host-bound step, so
readers divide device time by the untraced window's step time, never by
the stretch's.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Callable, List, Tuple

import numpy as np

STEP_SPAN = "benchmark.step"
MAX_ATTRIBUTED_GAPS = 400  # the longest idle gaps named by what the host was doing
TOP = 10


@dataclasses.dataclass
class Trace:
    steps: int
    window_s: float                               # host clock, the profiled stretch
    device_ops: List[Tuple[str, float, float]]    # (name, start_us, end_us) on the device
    host_ops: List[Tuple[str, float, float]]      # (name, start_us, end_us) on the host

    def busy_intervals(self) -> np.ndarray:
        """The union of the device's operations as sorted ``(start, end)`` µs."""
        if not self.device_ops:
            return np.zeros((0, 2))
        iv = np.array(sorted((s, e) for _, s, e in self.device_ops), dtype=np.float64)
        merged = [iv[0].copy()]
        for s, e in iv[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append(np.array([s, e]))
        return np.array(merged)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) * 1e-6 if len(iv) else 0.0

    def device_seconds(self, pattern) -> float:
        """Summed device time of the operations whose name matches ``pattern``."""
        return sum(e - s for n, s, e in self.device_ops if pattern.search(n)) * 1e-6

    def host_calls(self, pattern) -> int:
        return sum(1 for n, _, _ in self.host_ops if pattern.fullmatch(n))

    def top_device_ops(self) -> list:
        by_name = defaultdict(float)
        for n, s, e in self.device_ops:
            by_name[n] += (e - s) * 1e-6
        return sorted(([n, v] for n, v in by_name.items()), key=lambda x: -x[1])[:TOP]

    def idle_gaps(self) -> list:
        """The device's idle gaps inside the stretch, longest first, summed by
        the innermost host operation running at each gap's middle."""
        iv = self.busy_intervals()
        spans = [(s, e) for n, s, e in self.host_ops if n == STEP_SPAN]
        if len(iv) < 2 or not spans:
            return []
        lo = min(s for s, _ in spans)
        gaps = np.stack([iv[:-1, 1], iv[1:, 0]], axis=1)
        gaps = gaps[(gaps[:, 1] > gaps[:, 0]) & (gaps[:, 0] >= lo)]
        if lo < iv[0, 0]:
            gaps = np.concatenate([[[lo, iv[0, 0]]], gaps])
        gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:MAX_ATTRIBUTED_GAPS]
        names = [n for n, _, _ in self.host_ops]
        starts = np.array([s for _, s, _ in self.host_ops])
        ends = np.array([e for _, _, e in self.host_ops])
        by_name = defaultdict(float)
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = names[inside[np.argmax(starts[inside])]] if len(inside) else "(no host op)"
            by_name[name] += (g1 - g0) * 1e-6
        return sorted(([n, v] for n, v in by_name.items()), key=lambda x: -x[1])[:TOP]


def profile_steps(step: Callable[[], None], steps: int, sync: Callable[[], None],
                  cuda: bool) -> Trace:
    """Run ``steps`` steps under ``torch.profiler`` and read its events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            with record_function(STEP_SPAN):
                step()
        sync()
        window_s = time.perf_counter() - t0
    device_ops, host_ops = [], []
    events = prof.events()
    for ev in events:
        rec = (getattr(ev, "trace_name", None) or ev.name, float(ev.time_range.start),
               float(ev.time_range.end))
        if ev.device_type == DeviceType.CPU:
            host_ops.append(rec)
        elif not getattr(ev, "is_user_annotation", False):
            device_ops.append(rec)
    # a host span's mirror on the device timeline (record_function's annotation
    # around the kernels it launched) is not device work
    host_names = {n for n, _, _ in host_ops}
    device_ops = [op for op in device_ops if op[0] not in host_names]
    return Trace(steps=steps, window_s=window_s, device_ops=device_ops, host_ops=host_ops)
