"""The partitioned entry points under torchrun: ``python -m
torch.distributed.run --standalone --nproc_per_node 2 -m tpu_sage_torch.cli
--partitioned --device cpu`` trains 2 gloo ranks that take their rank from
torchrun's environment, writes a checkpoint from the first, and the
exporter's ``--partitioned`` under torchrun writes what the single-device
export writes from it."""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH = ["--synthetic", "sbm", "--synthetic-nodes", "300"]
MODEL = ["--n-train-samples", "4,3", "--n-val-samples", "4,3", "--output-dims", "16,16"]


def _torchrun(module, args, n=2):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", str(n), "-m", module, *args], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return [json.loads(l) for l in out.stdout.splitlines() if l.startswith("{")]


def test_torchrun_trains_two_ranks_and_exports(tmp_path):
    ckpt = tmp_path / "c.npz"
    recs = _torchrun("tpu_sage_torch.cli", GRAPH + MODEL + [
        "--batch-size", "32", "--epochs", "1", "--partitioned", "--device", "cpu",
        "--checkpoint-path", str(ckpt)])
    assert sum("config" in r for r in recs) == 1  # the first rank speaks
    assert {"n_shards": 2, "halo": "exact"} in recs
    epochs = [r for r in recs if "train_loss" in r]
    assert len(epochs) == 1 and epochs[0]["n_shards"] == 2
    assert np.isfinite(epochs[0]["train_loss"]) and 0.0 <= epochs[0]["val_metric"] <= 1.0
    assert {"checkpoint": str(ckpt)} in recs and ckpt.exists()

    from tpu_sage_torch.export import main as port_export

    common = GRAPH + ["--checkpoint", str(ckpt), "--checkpoint-config", "--chunk", "64",
                      "--logits", "--device", "cpu"]
    metas = _torchrun("tpu_sage_torch.export",
                      common + ["--out", str(tmp_path / "sharded.npy"), "--partitioned"])
    assert metas == [{"out": str(tmp_path / "sharded.npy"), "shape": [300, 7],
                      "kind": "logits", "from_step": metas[0]["from_step"], "process": 0}]
    assert port_export(common + ["--out", str(tmp_path / "single.npy")]) == 0
    a, b = np.load(tmp_path / "sharded.npy"), np.load(tmp_path / "single.npy")
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())
