"""The harness on the CPU at a toy size: the result line's schema, a cell
and a metric found from new files alone, the refusal without a card, and
the whole-name check for JAX and the JAX package."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests.toy import EXACT, TRAIN, cells, toy, toy_cell

CPU = torch.device("cpu")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", cells())
def test_result_line_schema(cell, trace):
    r = harness.run_cell(toy_cell(cell), 2**31 + 11, 0.3, bool(trace), CPU)
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    spec = harness.load_cell(cell)
    wanted = {m["name"]: m["unit"] for m in spec["per_layer" if trace else "end_to_end"]}
    for name, m in r["metrics"].items():
        assert m["unit"] == wanted[name] and isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert all(len(v) <= 10 for v in r["breakdown"].values())
    else:
        # the host-clock metrics exist without a card; device ones are left out
        assert "setup_s" in r["metrics"]
        assert any(n in r["metrics"] for n in ("train_edges_per_s", "infer_nodes_per_s"))
    assert set(r["checks"]) == set(spec["limits"])
    json.dumps(r)


def test_every_cell_reports_what_the_contract_asks():
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    for name in cells():
        spec = harness.load_cell(name)
        e2e = [m["name"] for m in spec["end_to_end"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec["per_layer"]
        for m in spec["per_layer"]:
            assert m["moves"] in e2e
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert os.path.isfile(os.path.join(spec["dir"], "metrics", f"{m['name']}.py"))
        assert os.path.isfile(os.path.join(spec["dir"], "drivers",
                                           f"{spec['traffic']['driver']}.py"))
    for entry in bench["workloads"] + bench["configs"] + bench["end_to_end"] + bench["per_layer"]:
        assert NAME.fullmatch(entry["name"])


def _copy_checkout(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def test_new_cell_and_metric_from_new_files_alone(tmp_path):
    root = _copy_checkout(tmp_path)
    here = root / "benchmark"
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    # a later PR: a traffic file, a metric reader, a limits file, and entries
    (here / "traffic" / "train-b256.json").write_text(json.dumps(
        {"driver": "train_sup", "batch_size": 256, "loop": "closed"}))
    (here / "metrics" / "steps_seen.train.py").write_text(
        "def read(run):\n    return float(run.steps)\n")
    shutil.copy(here / "limits" / f"{TRAIN}.json",
                here / "limits" / "reddit-sup.train-b256.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    train = json.loads((here / "deferred" / f"{TRAIN}.json").read_text())
    bench["workloads"].append({"name": "reddit-sup.train-b256", "config": "reddit-sage-mean-sup",
                               "traffic": "train-b256", "chips": 1, "why": "a smaller batch"})
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "train loops",
                               "moves": "train_edges_per_s",
                               "workloads": ["reddit-sup.train-b256"]})
    for m in train["end_to_end"]:  # the training metrics, listed for this cell
        bench["end_to_end"].append({**m, "bound": 0.25, "workloads": ["reddit-sup.train-b256"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())  # nothing edited

    spec = toy(harness.load_cell("reddit-sup.train-b256", str(root)))
    assert spec["dir"] == str(here)
    spec["traffic"]["batch_size"] = 32
    r = harness.run_cell(spec, 3, 0.3, True, CPU)
    assert r["correct"] and r["metrics"]["steps_seen.train"]["value"] > 0
    assert r["metrics"]["steps_seen.train"]["unit"] == "steps"


def test_runner_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        EXACT, "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_runner_refuses_without_the_program(tmp_path):
    root = _copy_checkout(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        EXACT, "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules(["tpu_sage_torch", "tpu_sage_torch.kernels", "torch",
                                      "jaxtyping", "flax_free"]) == []
    assert harness.forbidden_modules(["tpu_sage.nn", "jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "tpu_sage"]


def test_benchmark_sources_import_no_jax_nor_the_jax_package():
    for dirpath, _, names in os.walk(os.path.join(harness.ROOT, "benchmark")):
        for name in names:
            if not name.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, name)).read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                        [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for m in mods:
                    assert m.split(".", 1)[0] not in harness.FORBIDDEN, (name, m)


def test_a_run_loads_no_jax_nor_the_jax_package():
    code = (
        "import sys, torch\n"
        "from benchmark import harness, readings\n"
        "from benchmark.tests.toy import cells, toy_cell\n"
        "for c in cells():\n"
        "    harness.run_cell(toy_cell(c), 5, 0.1, True, torch.device('cpu'))\n"
        "print(harness.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
