"""tpu_sage_torch.bench.profile and bench.torch_baseline on the CPU: the
edges-per-step count is the JAX package's, and ``trace=True`` writes a
``torch.profiler`` Chrome trace (on the card it also records the CUDA
activity; ``chip_smoke.py`` checks it names the port's kernels)."""

import json
import os

import pytest

from tpu_sage.bench.profile import edges_per_batch as j_edges_per_batch
from tpu_sage_torch.bench import torch_baseline
from tpu_sage_torch.bench.profile import edges_per_batch, profile_steps


@pytest.mark.parametrize("batch,fanouts", [(512, (25, 10)), (512, (25,)), (64, (10, 5, 3)),
                                           (1024, (15, 10, 5, 2))])
def test_edges_per_batch_is_the_jax_packages(batch, fanouts):
    assert edges_per_batch(batch, fanouts) == j_edges_per_batch(batch, fanouts)
    assert edges_per_batch(512, (25, 10)) == 140_800


def test_trace_is_written_on_the_cpu(tmp_path):
    out = profile_steps(str(tmp_path), steps=2, batch_size=32, trace=True, n_nodes=600,
                        feat_dim=16, fanouts=(5, 3), device="cpu")
    assert out["trace_dir"] == str(tmp_path) and out["device"] == "cpu"
    assert out["ms_per_step"] > 0
    assert out["edges_per_sec"] == pytest.approx(edges_per_batch(32, (5, 3))
                                                 / (out["ms_per_step"] / 1e3))
    with open(os.path.join(str(tmp_path), "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    untraced = profile_steps(str(tmp_path / "none"), steps=1, batch_size=32, n_nodes=600,
                             feat_dim=16, fanouts=(5, 3), device="cpu")
    assert untraced["trace_dir"] is None and not os.path.exists(str(tmp_path / "none"))


def test_the_plain_baseline_runs_where_it_is_told_and_says_so():
    out = torch_baseline.run(n_nodes=400, feat_dim=16, n_classes=5, max_degree=8,
                             batch_size=16, fanouts=(5, 3), hidden=8, steps=2, warmup=1,
                             device="cpu")
    assert out["device"] == "cpu" and out["loss_finite"]
    assert out["edges_per_step"] == edges_per_batch(16, (5, 3))
    assert out["edges_per_sec"] == pytest.approx(out["edges_per_step"] * out["steps_per_sec"])
