"""The exporter's multi-host flags on the CPU: a checkpoint of partitioned
unsupervised training (``tpu_sage_torch.cli --partitioned --unsupervised``,
one rank), then ``tpu_sage_torch.export --partitioned --coordinator
127.0.0.1:<port> --num-processes 2 --process-id r`` in two processes, one
gloo rank each (a host of one rank), whose embeddings equal the
single-device export's; ``--num-processes 1`` is the plain export, bitwise.
Each process has its own timeout, and a timeout fails the test."""

import json
import os
import socket
import subprocess
import sys

import numpy as np

from tpu_sage_torch.cli import main as cli_main
from tpu_sage_torch.export import main as export_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH = ["--synthetic", "sbm", "--synthetic-nodes", "300"]
TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_export_of_a_partitioned_unsupervised_checkpoint(tmp_path, capsys):
    ckpt = str(tmp_path / "u.npz")
    assert cli_main(GRAPH + ["--n-train-samples", "4,3", "--n-val-samples", "4,3",
                             "--output-dims", "16,16", "--batch-size", "32", "--epochs", "2",
                             "--partitioned", "--unsupervised", "--walk-length", "2",
                             "--n-negatives", "4", "--no-eval", "--checkpoint-path", ckpt,
                             "--device", "cpu"]) == 0
    capsys.readouterr()
    common = GRAPH + ["--checkpoint", ckpt, "--checkpoint-config", "--chunk", "64",
                      "--device", "cpu"]
    assert export_main(common + ["--out", str(tmp_path / "single.npy")]) == 0

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpu_sage_torch.export", *common, "--out",
         str(tmp_path / "hosts.npy"), "--partitioned", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(pid)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in (1, 0)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)  # TimeoutExpired fails the test
            assert p.returncode == 0, out[-3000:] + err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    metas = [json.loads(line) for o in outs for line in o.splitlines() if line.startswith("{")]
    assert metas == [{"out": str(tmp_path / "hosts.npy"), "shape": [300, 32],
                      "kind": "embeddings", "from_step": metas[0]["from_step"], "process": 0}]
    a, b = np.load(tmp_path / "hosts.npy"), np.load(tmp_path / "single.npy")
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())

    one = str(tmp_path / "one.npy")
    assert export_main(common + ["--out", one, "--coordinator", f"127.0.0.1:{_free_port()}",
                                 "--num-processes", "1", "--process-id", "0"]) == 0
    np.testing.assert_array_equal(np.load(one), b)


def test_multi_host_flags_need_each_other(capsys):
    base = GRAPH + ["--checkpoint", "absent.npz", "--out", "x.npy", "--device", "cpu"]
    assert export_main(base + ["--num-processes", "2", "--process-id", "0"]) == 2
    assert export_main(base + ["--num-processes", "2", "--coordinator", "127.0.0.1:1",
                               "--process-id", "2"]) == 2
    assert "--num-processes > 1 needs --coordinator" in capsys.readouterr().err
