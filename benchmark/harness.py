"""The general harness: a cell found by its name, set up, measured, traced,
checked, and reported in one line.

Everything particular to a cell sits in files the harness finds by name:

- ``BENCHMARK.json`` names the cell's configuration and traffic, and the
  metrics it reports (an entry without ``workloads`` is every cell's);
- ``configs/<config>.json``: sizes, model settings, the reference module;
- ``traffic/<traffic>.json``: the driver kind and its parameters;
- ``drivers/<driver>.py``: the timed step over one entry of the program;
- ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``;
- ``limits/<cell>.json``: the limit of each number the check compares;
- ``deferred/<cell>.json``: a cell that runs but is not listed, with the
  entries that would list it and the reason it is not.

A run: set-up (inputs from the seed, the program's object, its first steps,
warm-up) → the measured window, a closed loop of steps for ``seconds`` that
ends in a synchronize → with ``trace`` a short profiled stretch → the peak
memory read → the program's state released → the comparison with the
reference.

A cell whose ``chips`` is n > 1 runs as n ranks, one process a card, in one
process group (``ranks.py``), in lockstep: rank 0 times the first two
warm-up steps and gives every rank the same counts of warm-up, window and
traced steps; each step ends in collectives with every rank, so rank 0's
window is the group's. Rank 0 reports one line for the group: the fullest
card's peak memory, rank 0's trace with every rank's beside it, and each
compared number at its worst over the ranks.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from benchmark import checks, counts, ranks
from benchmark.files import load_json, load_module
from benchmark.trace import Trace, profile_steps

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_sage")
WARM_SECONDS = 1.0  # warm-up after the first steps, also timing the step for the event pool
TRACE_SECONDS = 0.25  # how long the profiled stretch should be, in untraced step time
# a group's time limit: set-up, then ``seconds``, then the trace and the comparison
GROUP_SETUP_S = 150.0
GROUP_TAIL_S = 150.0
IMPORTED_AT = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - IMPORTED_AT


class Forbidden(RuntimeError):
    """A rank of a group loaded JAX or the JAX package."""

    def __init__(self, found: List[str]):
        super().__init__(f"the group loaded {found}")
        self.found = found


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole: ``tpu_sage_torch`` is not ``tpu_sage``."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def load_cell(name: str, root: str = ROOT) -> dict:
    """A cell's entry, configuration, traffic, metrics and limits, from its
    name, in the checkout at ``root``: a cell of ``BENCHMARK.json``, or a
    deferred one with the entries its file holds."""
    bench = load_json(root, "BENCHMARK.json")
    here = os.path.join(root, "benchmark")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        path = os.path.join(here, "deferred", f"{name}.json")
        if not os.path.isfile(path):
            raise KeyError(f"no workload {name!r} in BENCHMARK.json nor in deferred/")
        deferred = load_json(path)
        entry = deferred["workload"]
        bench = {key: bench[key] + deferred[key] for key in ("end_to_end", "per_layer")}

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {
        "name": name,
        "dir": here,
        "chips": int(entry["chips"]),
        "config": load_json(here, "configs", f"{entry['config']}.json"),
        "traffic": load_json(here, "traffic", f"{entry['traffic']}.json"),
        "end_to_end": mine(bench["end_to_end"]),
        "per_layer": mine(bench["per_layer"]),
        "limits": checks.load_limits(os.path.join(here, "limits", f"{name}.json")),
    }


def reader(bench_dir: str, metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return load_module(os.path.join(bench_dir, "metrics", f"{metric}.py")).read


def driver(bench_dir: str, kind: str):
    """The driver module ``drivers/<kind>.py``."""
    return load_module(os.path.join(bench_dir, "drivers", f"{kind}.py"))


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: str
    work_unit: str              # what ``work`` counts: "edges", "nodes"
    setup_s: float
    window_s: float
    steps: int
    work: float
    step_s: List[float]         # device-side gap between consecutive steps' ends
    host_s: List[float]         # host span of each step's call, no sync
    least: Dict[str, float]     # counts.py's FLOPs and bytes of one step
    dtype: str                  # the products' dtype, for the FLOPs peak
    peak: Optional[dict]        # peaks.json's row for this card, or None
    trace: Optional[Trace] = None     # rank 0's
    chips: int = 1                    # the cards whose work ``work`` and ``least`` count
    traces: Optional[List[Trace]] = None  # every rank's, in rank order

    @property
    def step_mean_s(self) -> float:
        return self.window_s / self.steps


class Window:
    """Step ends on the device (CUDA events, read after the window), or on
    the host clock where there is no card."""

    def __init__(self, cuda: bool, capacity: int):
        self.cuda = cuda
        self.events = [torch.cuda.Event(enable_timing=True) for _ in range(capacity + 1)] \
            if cuda else []
        self.host_ends: List[float] = []
        self.n = 0

    def mark(self) -> None:
        if self.cuda:
            if self.n >= len(self.events):
                self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[self.n].record()
        else:
            self.host_ends.append(time.perf_counter())
        self.n += 1

    def gaps_s(self) -> List[float]:
        if self.cuda:
            ev = self.events[:self.n]
            return [a.elapsed_time(b) * 1e-3 for a, b in zip(ev, ev[1:])]
        return [b - a for a, b in zip(self.host_ends, self.host_ends[1:])]


def power_limit_w() -> Optional[float]:
    """The card's power limit, from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: torch.device,
             program: Optional[dict] = None) -> dict:
    """One run of a cell; returns the result line as a dict. A cell on more
    than one card runs as a group of ranks, on ``device``'s type."""
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    if cuda:
        from tpu_sage_torch.kernels import _build
        _build.build()  # every kernel library at once; a no-op once built
    if spec["chips"] > 1:
        return _run_group(spec, seed, seconds, trace, device.type, program)
    session = driver(spec["dir"], spec["traffic"]["driver"]).Session(spec, seed, device, program)

    # warm-up, also the step time that sizes the event pool
    sync()
    t0, warm = time.perf_counter(), 0
    while warm < 2 or time.perf_counter() - t0 < WARM_SECONDS:
        session.step()
        warm += 1
        if warm % 4 == 0:
            sync()
    sync()
    warm_step_s = (time.perf_counter() - t0) / warm
    window = Window(cuda, int(2 * seconds / warm_step_s) + 64)

    host_s: List[float] = []
    setup_s = process_age_s()
    window.mark()
    t_start = time.perf_counter()
    while True:
        h0 = time.perf_counter()
        session.step()
        h1 = time.perf_counter()
        window.mark()
        host_s.append(h1 - h0)
        if h1 - t_start >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t_start
    steps = len(host_s)
    step_s = window.gaps_s()
    run = Run(cell=spec["name"], work_unit=session.work_unit,
              setup_s=setup_s, window_s=window_s, steps=steps,
              work=float(steps * session.work_per_step), step_s=step_s, host_s=host_s,
              least=session.least_counts(), dtype=session.peak_dtype,
              peak=counts.peaks(torch.cuda.get_device_name(device)) if cuda else None)
    if trace:
        k = max(3, min(100, int(TRACE_SECONDS / run.step_mean_s)))
        run.trace = profile_steps(session.step, k, sync, cuda)

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if cuda else 0}
    if trace:
        device_info.update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
    if cuda:
        device_info["power_limit_w"] = power_limit_w()

    nonfinite = session.nonfinite()  # of every step after set-up's first ones
    session.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    values = session.compare()
    return _report(spec, run, device_info, values, nonfinite)


def _run_group(spec: dict, seed: int, seconds: float, trace: bool, device_type: str,
               program: Optional[dict]) -> dict:
    """A run of a cell on ``spec["chips"]`` ranks (``_rank_run``), reported
    by rank 0 for the group."""
    n = spec["chips"]
    answers = ranks.run(_rank_run, (spec, seed, seconds, trace, program), n, device_type,
                        GROUP_SETUP_S + seconds + GROUP_TAIL_S)
    found = sorted({m for a in answers for m in a["forbidden"]})
    if found:
        raise Forbidden(found)
    lead = answers[0]
    cuda = device_type == "cuda"
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    run = Run(cell=spec["name"], work_unit=lead["work_unit"], setup_s=lead["setup_s"],
              window_s=lead["window_s"], steps=lead["steps"][1],
              work=float(lead["steps"][1] * lead["work_per_step"]), step_s=lead["step_s"],
              host_s=lead["host_s"], least=lead["least"], dtype=lead["dtype"],
              peak=counts.peaks(kind) if cuda else None, trace=lead["trace"], chips=n,
              traces=[a["trace"] for a in answers] if trace else None)
    memory = [a["memory_peak_bytes"] for a in answers]
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": n,
                   "memory_peak_bytes": max(memory), "memory_peak_bytes_by_rank": memory,
                   "steps_by_rank": [a["steps"] for a in answers]}
    if trace:
        device_info.update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s,
                           busy_s_by_rank=[t.busy_s() for t in run.traces],
                           window_s_by_rank=[t.window_s for t in run.traces])
    if cuda:
        device_info["power_limit_w"] = power_limit_w()
    values = checks.worst([a["values"] for a in answers])
    return _report(spec, run, device_info, values, sum(a["nonfinite"] for a in answers))


def _rank_run(device: torch.device, spec: dict, seed: int, seconds: float, trace: bool,
              program: Optional[dict]) -> dict:
    """One rank's part of a group's run. Every rank takes the counts of
    steps that rank 0 sets from the first two warm-up steps, so the
    collectives inside each step line up; rank 0 times the window."""
    import torch.distributed as dist

    cuda = device.type == "cuda"
    lead = dist.get_rank() == 0

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    session = driver(spec["dir"], spec["traffic"]["driver"]).Session(spec, seed, device, program)
    sync()
    t0 = time.perf_counter()
    for _ in range(2):
        session.step()
    sync()
    warm_step_s = (time.perf_counter() - t0) / 2
    plan = torch.tensor([max(0, math.ceil(WARM_SECONDS / warm_step_s) - 2),
                         max(1, math.ceil(seconds / warm_step_s)),
                         max(3, min(100, int(TRACE_SECONDS / warm_step_s)))],
                        dtype=torch.int64, device=device)
    dist.broadcast(plan, src=0)
    n_warm, n_window, n_trace = (int(c) for c in plan.tolist())
    for i in range(n_warm):
        session.step()
        if (i + 1) % 4 == 0:
            sync()
    window = Window(cuda, n_window + 1)
    host_s: List[float] = []
    if cuda:
        dist.barrier(device_ids=[device.index])
    else:
        dist.barrier()
    sync()
    setup_s = process_age_s()
    window.mark()
    t_start = time.perf_counter()
    for _ in range(n_window):
        h0 = time.perf_counter()
        session.step()
        h1 = time.perf_counter()
        window.mark()
        host_s.append(h1 - h0)
    sync()
    window_s = time.perf_counter() - t_start
    traced = profile_steps(session.step, n_trace, sync, cuda) if trace else None
    answer = {"steps": [2 + n_warm, n_window, n_trace if trace else 0], "trace": traced,
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if cuda else 0,
              "work_unit": session.work_unit, "work_per_step": session.work_per_step,
              "least": session.least_counts(), "dtype": session.peak_dtype,
              "nonfinite": session.nonfinite()}
    if lead:
        answer.update(setup_s=setup_s, window_s=window_s, step_s=window.gaps_s(), host_s=host_s)
    session.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    answer["values"] = session.compare()
    answer["forbidden"] = forbidden_modules()
    return answer


def _report(spec: dict, run: Run, device_info: dict, values: Dict[str, float],
            nonfinite: int) -> dict:
    """The result line of a run: the verdict on ``values`` and the failed
    steps, the cell's metrics read from ``run``, and ``checks`` last."""
    values["nonfinite_steps"] = float(nonfinite)
    verdict = checks.judge(values, spec["limits"])
    trace = run.trace is not None

    metrics = {}
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        v = reader(spec["dir"], m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": all(c["ok"] for c in verdict.values()), "attempted": run.steps,
              "failed": nonfinite, "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in verdict.items()}
    return result
