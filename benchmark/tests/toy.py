"""Cells cut to a size the CPU runs in seconds, for the benchmark's tests.
The widths, fanouts and batch shrink together; the code paths are the
cell's own. ``cells()`` are the cells of ``BENCHMARK.json`` and the
deferred ones (``deferred/<cell>.json``); a cell on more than one card runs
as gloo ranks on the CPU.

``copy_checkout`` copies the benchmark as a checkout holds it, for tests
that add files as a later PR would; ``wrapped`` runs a cell's exact pass in
such a copy under a fault, through a new driver file; ``run_apart`` runs a
cell in a fresh process, as ``benchmark.run`` does, for the runs whose
group the launcher may end with its process."""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

TOY_GRAPH = dict(n_nodes=3000, feat_dim=32, n_classes=5, degree=16)
TOY_MODEL = dict(n_train_samples=[5, 3], n_val_samples=[5, 3], output_dims=[16, 16],
                 agg_hidden_dim=24)
TRAIN = "reddit-sup.train-b512"
EXACT = "reddit-sup.exact-embed"
POOL = "reddit-maxpool.exact-embed"
PART = "reddit-sup.exact-embed.part4"
# a driver that runs its base's passes of the program inside a fault
# (``module:function``, a context manager) that its traffic names
WRAPPER = '''"""{base}'s passes, each inside the fault the traffic names."""

import importlib

from benchmark.files import load_module

base = load_module({path!r})


class Session(base.Session):
    def __init__(self, spec, *args, **kwargs):
        module, name = spec["traffic"]["fault"].split(":")
        self.fault = getattr(importlib.import_module(module), name)
        super().__init__(spec, *args, **kwargs)

    def _pass(self):
        with self.fault():
            return super()._pass()
'''
# ``harness.run_cell`` of the job on standard input, on the CPU, with some of
# the harness's settings changed; the result line on standard output
RUN_APART = """
import json, sys, torch
from benchmark import harness
job = json.load(sys.stdin)
for name, value in job["settings"].items():
    setattr(harness, name, value)
r = harness.run_cell(job["spec"], job["seed"], job["seconds"], job["trace"], torch.device("cpu"))
print(json.dumps(r))
"""


def toy(spec: dict) -> dict:
    spec = copy.deepcopy(spec)
    spec["config"]["graph"].update(TOY_GRAPH)
    spec["config"]["model"].update(TOY_MODEL)
    if "batch_size" in spec["traffic"]:
        spec["traffic"]["batch_size"] = 64
    if "chunk" in spec["traffic"]:
        spec["traffic"]["chunk"] = 512
    return spec


def toy_cell(name: str, root: str = harness.ROOT) -> dict:
    return toy(harness.load_cell(name, root))


def cells(root: str = harness.ROOT) -> list:
    listed = [w["name"] for w in harness.load_json(root, "BENCHMARK.json")["workloads"]]
    deferred = sorted(f[:-len(".json")] for f in os.listdir(os.path.join(root, "benchmark",
                                                                          "deferred")))
    return listed + deferred


def copy_checkout(tmp_path):
    """``BENCHMARK.json`` and ``benchmark/`` without its tests, under
    ``tmp_path/checkout``."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def wrapped(spec: dict, root, fault: str) -> dict:
    """``spec`` run from the copy at ``root`` by a new driver file that runs
    each pass of its driver inside ``fault``."""
    here = os.path.join(str(root), "benchmark")
    base = spec["traffic"]["driver"]
    with open(os.path.join(here, "drivers", f"{base}_wrapped.py"), "w") as f:
        f.write(WRAPPER.format(base=base, path=os.path.join(here, "drivers", f"{base}.py")))
    spec = copy.deepcopy(spec)
    spec["dir"] = here
    spec["traffic"].update(driver=f"{base}_wrapped", fault=fault)
    return spec


def run_apart(spec: dict, seed: int, seconds: float, trace: bool = False, timeout: float = 600,
              **settings) -> subprocess.CompletedProcess:
    """``harness.run_cell`` of ``spec`` on the CPU in a fresh process, with
    the harness's ``settings`` (module names) changed there."""
    job = {"spec": spec, "seed": seed, "seconds": seconds, "trace": trace, "settings": settings}
    return subprocess.run([sys.executable, "-c", RUN_APART], input=json.dumps(job),
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=timeout)
