"""The port's serving export, ``python -m tpu_sage_torch.export`` (mirroring
``tests/test_export.py``): train with a CLI, then export full-graph
embeddings and logits, on the CPU.

One checkpoint is written by the port's CLI (bf16 compute), one by the JAX
package's (f32); each package's exporter reads both, and their ``.npy``
files agree within 1e-5 x max|out| (both exporters upload f32 features and
run f32 products, so only f32 rounding differs).
"""

import json

import numpy as np
import pytest
import torch

from tpu_sage.cli import main as jax_cli
from tpu_sage.export import main as jax_export
from tpu_sage_torch.cli import main as port_cli
from tpu_sage_torch.data.synthetic import sbm_problem
from tpu_sage_torch.export import main as port_export

MODEL = ["--n-train-samples", "4,3", "--n-val-samples", "4,3", "--output-dims", "16,16"]
GRAPH = ["--synthetic", "sbm", "--synthetic-nodes", "300"]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("export")
    ckpts = {"port": tmp / "port.npz", "jax": tmp / "jax.npz"}
    train = GRAPH + MODEL + ["--batch-size", "32", "--epochs", "2"]
    assert port_cli(train + ["--device", "cpu", "--compute-dtype", "bfloat16",
                             "--checkpoint-path", str(ckpts["port"])]) == 0
    assert jax_cli(train + ["--checkpoint-path", str(ckpts["jax"])]) == 0
    assert all(p.exists() for p in ckpts.values())
    return tmp, ckpts


def _run_export(ckpt, out, extra, capsys=None):
    argv = GRAPH + ["--checkpoint", str(ckpt), "--out", str(out), "--chunk", "64",
                    "--device", "cpu"] + MODEL + extra
    assert port_export(argv) == 0
    if capsys is not None:
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_export_embeddings_and_logits(checkpoints, capsys):
    tmp, ckpts = checkpoints
    emb_path = tmp / "emb.npy"
    meta = _run_export(ckpts["port"], emb_path, [], capsys)
    emb = np.load(emb_path)
    # 2-layer concat model: embedding width = 2 * output_dim
    assert emb.shape == (300, 32) and emb.dtype == np.float32 and np.isfinite(emb).all()
    assert meta["kind"] == "embeddings" and meta["from_step"] > 0 and meta["process"] == 0
    assert meta["shape"] == [300, 32]
    norms = np.linalg.norm(emb, axis=1)
    np.testing.assert_allclose(norms[norms > 0], 1.0, rtol=1e-3)

    logit_path = tmp / "logits.npy"
    _run_export(ckpts["port"], logit_path, ["--logits"])
    logits = np.load(logit_path)
    assert logits.shape == (300, 7) and np.isfinite(logits).all()
    # the trained head classifies the easy SBM val fold well
    problem = sbm_problem(n_nodes=300, seed=123)
    val = problem.folds["val"]
    acc = (logits[val].argmax(-1) == problem.store.targets[val]).mean()
    assert acc > 0.6, acc


def test_export_out_dtype_f16(checkpoints, capsys):
    """--out-dtype float16 casts on the device before the copy; values match
    the f32 export to f16 resolution."""
    tmp, ckpts = checkpoints
    f32_path, f16_path = tmp / "emb32.npy", tmp / "emb16.npy"
    _run_export(ckpts["port"], f32_path, [])
    _run_export(ckpts["port"], f16_path, ["--out-dtype", "float16"])
    a, b = np.load(f32_path), np.load(f16_path)
    assert b.dtype == np.float16 and b.shape == a.shape
    np.testing.assert_allclose(b.astype(np.float32), a, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("kind", [[], ["--logits"]], ids=["embeddings", "logits"])
def test_export_matches_jax(checkpoints, capsys, writer, kind):
    """Both exporters on one checkpoint, the model config read from the
    checkpoint (--checkpoint-config, no model flags)."""
    tmp, ckpts = checkpoints
    name = f"{writer}_{'logits' if kind else 'emb'}"
    ours, theirs = tmp / f"{name}_port.npy", tmp / f"{name}_jax.npy"
    common = GRAPH + ["--checkpoint", str(ckpts[writer]), "--chunk", "64",
                      "--checkpoint-config"] + kind
    assert port_export(common + ["--out", str(ours), "--device", "cpu"]) == 0
    assert jax_export(common + ["--out", str(theirs)]) == 0
    metas = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()[-2:]]
    assert metas[0]["shape"] == metas[1]["shape"]
    assert metas[0]["from_step"] == metas[1]["from_step"] > 0
    a, b = np.load(ours), np.load(theirs)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


def test_missing_checkpoint_clean_error(tmp_path):
    for extra in ([], ["--checkpoint-config"]):
        with pytest.raises(SystemExit) as ei:
            _run_export(tmp_path / "definitely_not_here.npz", tmp_path / "o.npy", extra)
        assert "checkpoint not found" in str(ei.value)


@pytest.mark.parametrize("kind", [[], ["--logits"]], ids=["embeddings", "logits"])
def test_partitioned_export_matches_single_device(checkpoints, capsys, kind):
    """``--partitioned`` exited 2 until ROADMAP Queue 1 item 14's supervised
    slice; at world 1 on the CPU it runs the node-sharded exact pass and
    writes what the single-device export writes (the exchanged rows are the
    table's rows, the chunks the same)."""
    tmp, ckpts = checkpoints
    common = GRAPH + ["--checkpoint", str(ckpts["port"]), "--chunk", "64",
                      "--checkpoint-config", "--device", "cpu"] + kind
    assert port_export(common + ["--out", str(tmp / "single.npy")]) == 0
    assert port_export(common + ["--out", str(tmp / "sharded.npy"), "--partitioned"]) == 0
    metas = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()[-2:]]
    assert metas[0]["shape"] == metas[1]["shape"] and metas[1]["process"] == 0
    np.testing.assert_array_equal(np.load(tmp / "sharded.npy"), np.load(tmp / "single.npy"))


@pytest.mark.parametrize("flag", [["--coordinator", "localhost:1234"],
                                  ["--num-processes", "2"], ["--process-id", "0"]],
                         ids=lambda f: f[0])
def test_unported_flags_exit_2(checkpoints, capsys, flag):
    """Each flag exited 2 naming ROADMAP Queue 1 item 14 until that item's
    last slice; now the three bring up a multi-host group, with the JAX
    package's meaning (tests/test_torch_dist_multihost.py runs two
    processes). Alone, ``--num-processes 2`` lacks the coordinator and the
    process id and exits 2; ``--coordinator`` or ``--process-id`` alone is
    one process (``init_multihost`` is a no-op), and the export is the plain
    one, bitwise."""
    tmp, ckpts = checkpoints
    common = GRAPH + ["--checkpoint", str(ckpts["port"]), "--chunk", "64",
                      "--checkpoint-config", "--device", "cpu"]
    assert port_export(common + ["--out", str(tmp / "plain.npy")]) == 0
    out = tmp / f"flag{flag[0]}.npy"
    rc = port_export(common + ["--out", str(out)] + flag)
    if flag[0] == "--num-processes":
        assert rc == 2 and "--num-processes > 1 needs --coordinator" in capsys.readouterr().err
    else:
        assert rc == 0
        np.testing.assert_array_equal(np.load(out), np.load(tmp / "plain.npy"))


def test_cuda_without_a_card_exits_2(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the refusal without one")
    argv = GRAPH + ["--checkpoint", str(tmp_path / "c.npz"), "--out", str(tmp_path / "o.npy")]
    assert port_export(argv) == 2
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("version", [(1, 0), (2, 0), (3, 0)])
def test_embedding_rows_read_from_every_npy_header_version(tmp_path, monkeypatch, version):
    """The prep-embedding table's row count comes from its ``.npy`` member's
    header, versions 1.0, 2.0 and 3.0 alike, without ``np.load``."""
    import io
    import zipfile

    from tpu_sage_torch import export

    path = tmp_path / "ckpt.npz"
    with zipfile.ZipFile(path, "w") as zf:
        for name, arr, v in (("params/agg_0/kernel.npy", np.zeros((3, 2), np.float32), (1, 0)),
                             ("params/prep/embedding.npy", np.zeros((7, 4), np.float32),
                              version)):
            buf = io.BytesIO()
            np.lib.format.write_array(buf, arr, version=v)
            zf.writestr(name, buf.getvalue())
    with zipfile.ZipFile(path) as zf:  # the magic string, then the version bytes
        assert zf.read("params/prep/embedding.npy")[6:8] == bytes(version)

    def no_load(*a, **k):
        raise AssertionError("np.load was called")

    monkeypatch.setattr(np, "load", no_load)
    assert export._npz_embedding_rows(str(path)) == 7
