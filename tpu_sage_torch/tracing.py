"""Spans and counters at the port's layer boundaries, on the profiler's clock.

A span records only while a ``torch.profiler`` profile records; the gate is
one read of ``torch.autograd.profiler._is_profiler_enabled``, which the
profiler sets on start and clears on stop. With the gate off, ``span``
returns one shared no-op context manager and ``count`` returns at once:
nothing is allocated, nothing reaches the dispatcher or the card.

With the gate on, a span

- enters PyTorch's C++ ``_RecordFunctionFast`` annotation named ``name``
  (about 2 µs a span under the profiler, against 15 for
  ``torch.profiler.record_function``), so it sits in the profiler's own
  trace, on the clock of the device's activities;
- takes its host start and end (``time.perf_counter_ns``);
- on a CUDA ``device``, records a pair of timing events from a reusable pool
  on the stream current on that device at entry;
- appends a ``Record`` holding its name, its parent's and its root's indices (the root is the outermost open span:
  one exact pass or one train step), its events and its counters.

``count(**values)`` adds to the counters of the innermost open span; a
caller whose counters cost work to compute checks ``enabled()`` first.
Nothing is read or written out on the hot path: ``summary()`` reads the events after
a synchronize. Kernel launch counts stay with ``kernels.launch_counts()``.
Spans are meant for one thread: the open spans are one stack.

The spans (``nn/full_graph.py``, ``train/trainer.py``)::

    tsg.exact.pass > tsg.exact.prep, tsg.exact.layer
    tsg.exact.layer > tsg.exact.table (the pools' projection),
        tsg.exact.gather, tsg.exact.reduce, tsg.exact.combine
    tsg.train.step (edges) > tsg.train.sample, tsg.train.forward,
        tsg.train.backward, tsg.train.optimizer
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


class Record:
    """One span: name, ``parent`` and ``root`` record indices (``parent`` None for a root, whose ``root`` is itself),
    host start and end in ns, the CUDA event pair or None, counters."""

    __slots__ = ("name", "parent", "root", "host_start_ns", "host_end_ns", "events", "counters")

    def __init__(self, name: str, parent: Optional[int], root: int, events):
        self.name, self.parent, self.root = name, parent, root
        self.host_start_ns = self.host_end_ns = 0
        self.events = events
        self.counters: Dict[str, float] = {}

    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) * 1e-6

    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's events on its stream, or None
        without events. Call after the stream has passed the end event."""
        return None if self.events is None else self.events[0].elapsed_time(self.events[1])


_ANNOTATION = torch._C._profiler._RecordFunctionFast
_RECORDS: List[Record] = []
_OPEN: List[int] = []          # indices of the open spans, innermost last
_EVENTS: list = []             # the pool of timing events, reused after reset()
_next_event = 0


def _event_pair():
    global _next_event
    while len(_EVENTS) < _next_event + 2:
        _EVENTS.append(torch.cuda.Event(enable_timing=True))
    pair = (_EVENTS[_next_event], _EVENTS[_next_event + 1])
    _next_event += 2
    return pair


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "device", "annotation", "record", "stream")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name, self.device = name, device

    def __enter__(self) -> Record:
        self.annotation = _ANNOTATION(self.name)
        self.annotation.__enter__()
        cuda = self.device is not None and self.device.type == "cuda"
        parent = _OPEN[-1] if _OPEN else None
        i = len(_RECORDS)
        rec = Record(self.name, parent, i if parent is None else _RECORDS[parent].root,
                     _event_pair() if cuda else None)
        _RECORDS.append(rec)
        _OPEN.append(i)
        self.record = rec
        rec.host_start_ns = time.perf_counter_ns()
        if cuda:
            # both events on the stream current at entry: one lookup a span
            self.stream = torch.cuda.current_stream(self.device)
            rec.events[0].record(self.stream)
        return rec

    def __exit__(self, *exc):
        rec = self.record
        if rec.events is not None:
            rec.events[1].record(self.stream)
        rec.host_end_ns = time.perf_counter_ns()
        _OPEN.pop()
        self.annotation.__exit__(*exc)
        return False


def enabled() -> bool:
    """Whether a ``torch.profiler`` profile records, so spans record too."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, device: Optional[torch.device] = None):
    """A span named ``name`` over the work it encloses on ``device`` (events
    only for a CUDA device). The shared no-op ``NO_SPAN`` while no profiler
    records."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return _Span(name, device)


def count(**values: float) -> None:
    """Add ``values`` to the innermost open span's counters; nothing while no
    profiler records or no span is open."""
    if not _autograd_profiler._is_profiler_enabled or not _OPEN:
        return
    counters = _RECORDS[_OPEN[-1]].counters
    for k, v in values.items():
        counters[k] = counters.get(k, 0) + v


def records() -> List[Record]:
    """Every record since the last ``reset()``, in the order the spans opened."""
    return _RECORDS


def reset() -> None:
    """Drop the records; their events go back to the pool."""
    global _next_event
    _RECORDS.clear()
    _OPEN.clear()
    _next_event = 0


def summary(roots: Optional[Iterable[int]] = None) -> Dict[str, dict]:
    """Per span name, over the closed records (of the given root indices
    only, if ``roots``): ``count``, ``device_ms``, ``self_device_ms`` (less
    the part its child spans cover), ``host_ms`` and the summed counters.
    The device numbers are None for spans without events. Synchronizes the
    card first when any record has events."""
    keep = set(roots) if roots is not None else None
    recs = [(i, r) for i, r in enumerate(_RECORDS)
            if r.host_end_ns and (keep is None or r.root in keep)]
    if any(r.events is not None for _, r in recs):
        torch.cuda.synchronize()
    device = {i: r.device_ms() for i, r in recs}
    children: Dict[int, float] = {}
    for i, r in recs:
        if r.parent is not None and device[i] is not None:
            children[r.parent] = children.get(r.parent, 0.0) + device[i]
    out: Dict[str, dict] = {}
    for i, r in recs:
        s = out.setdefault(r.name, {"count": 0, "device_ms": None, "self_device_ms": None,
                                    "host_ms": 0.0})
        s["count"] += 1
        s["host_ms"] += r.host_ms()
        if device[i] is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + device[i]
            s["self_device_ms"] = (s["self_device_ms"] or 0.0) + device[i] - children.get(i, 0.0)
        for k, v in r.counters.items():
            s[k] = s.get(k, 0) + v
    return out
