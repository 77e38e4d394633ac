"""The port's CLI, ``python -m tpu_sage_torch.cli`` (mirroring
``tests/test_cli.py``): in-process ``main()`` with ``--device cpu``; the
partitioned flags run at world 1 (one CPU rank in this process); paths not
ported yet (``--partitioned --unsupervised``, ``--halo hier2d``) exit 2
naming their ROADMAP item."""

import json
import os

import numpy as np
import pytest
import torch

from tpu_sage.cli import main as jax_main
from tpu_sage_torch.cli import main, parse_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "golden_problem.h5")
TINY = ["--synthetic", "sbm", "--synthetic-nodes", "300", "--n-train-samples", "4,3",
        "--n-val-samples", "4,3", "--output-dims", "16,16", "--batch-size", "32",
        "--device", "cpu"]


def _capture(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return [json.loads(l) for l in out if l.startswith("{")]


def test_unknown_aggregator_exits_2(capsys):
    assert main(["--synthetic", "sbm", "--aggregator-class", "bogus", "--device", "cpu"]) == 2
    assert "unknown" in capsys.readouterr().err


def test_unported_aggregator_exits_2(capsys):
    """gcn exited 2 until ROADMAP Queue 1 item 8 ported it; now it trains."""
    assert main(TINY + ["--aggregator-class", "gcn", "--epochs", "1"]) == 0
    recs = _capture(capsys)
    assert recs[0]["config"]["aggregator_class"] == "gcn"
    assert any("train_loss" in r for r in recs)


def test_unknown_prep_exits_2(capsys):
    assert main(["--synthetic", "sbm", "--prep-class", "bogus", "--device", "cpu"]) == 2
    assert "unknown" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--aggregator-class", "max_pool"], ["--aggregator-class", "mean_pool"],
    ["--aggregator-class", "attention"], ["--aggregator-class", "lstm"],
    ["--prep-class", "linear"], ["--prep-class", "node_embedding"],
], ids=lambda f: f[1])
def test_every_aggregator_and_prep_trains(capsys, flags):
    assert main(TINY + flags + ["--epochs", "1", "--exact-val"]) == 0
    recs = _capture(capsys)
    assert recs[0]["config"][flags[0][2:].replace("-", "_")] == flags[1]
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    assert losses and all(l == l for l in losses)
    assert any("final_test_metric" in r for r in recs)


@pytest.mark.parametrize("preset,extra", [
    ("pubmed_maxpool.json", []),
    ("ppi_lstm.json", ["--synthetic-task", "multilabel_classification"]),
], ids=["pubmed_maxpool", "ppi_lstm"])
def test_presets_of_the_other_aggregators_train(capsys, preset, extra):
    """The two presets the port could not run before, unchanged but for the
    run's size (fanouts, widths, batch), on small synthetic stores."""
    argv = ["--config", os.path.join(REPO, "configs", preset), "--synthetic", "sbm",
            "--synthetic-nodes", "200", "--n-train-samples", "4,3", "--n-val-samples", "4,3",
            "--output-dims", "8,8", "--batch-size", "32", "--epochs", "1",
            "--device", "cpu"] + extra
    assert main(argv) == 0
    recs = _capture(capsys)
    cfg = recs[0]["config"]
    assert cfg["aggregator_class"] in ("max_pool", "lstm") and cfg["agg_hidden_dim"] in (512, 256)
    assert any("final_test_metric" in r for r in recs)


def test_mismatched_dims_exits_2():
    assert main(["--synthetic", "sbm", "--n-train-samples", "25,10", "--output-dims", "128",
                 "--device", "cpu"]) == 2


def test_unknown_schedule_exits_2():
    assert main(["--synthetic", "sbm", "--lr-schedule", "nope", "--device", "cpu"]) == 2


def test_missing_problem_file_clean_error():
    with pytest.raises(SystemExit) as ei:
        main(["--problem-path", "/tmp/definitely_not_here.h5", "--device", "cpu"])
    assert "problem file not found" in str(ei.value)


def test_missing_checkpoint_clean_error(tmp_path):
    from tpu_sage_torch.export import main as export_main

    with pytest.raises(SystemExit) as ei:
        export_main(["--synthetic", "sbm", "--synthetic-nodes", "300",
                     "--checkpoint", "/tmp/definitely_not_here.npz",
                     "--out", str(tmp_path / "o.npy"), "--device", "cpu",
                     "--n-train-samples", "4,3", "--n-val-samples", "4,3",
                     "--output-dims", "16,16"])
    assert "checkpoint not found" in str(ei.value)


def test_end_to_end_tiny(capsys):
    assert main(TINY + ["--epochs", "1"]) == 0
    recs = _capture(capsys)
    assert any("train_loss" in r for r in recs)
    assert any("final_test_metric" in r for r in recs)


def test_problem_path_trains(capsys):
    assert main(["--problem-path", GOLDEN, "--n-train-samples", "3,2", "--n-val-samples",
                 "3,2", "--output-dims", "8,8", "--batch-size", "16", "--epochs", "1",
                 "--device", "cpu"]) == 0
    recs = _capture(capsys)
    assert recs[0]["n_nodes"] == 64 and any("train_loss" in r for r in recs)


def test_config_preset_with_explicit_default_value(capsys, tmp_path):
    """A flag passed with its argparse-default value still overrides the
    preset; the echoed config equals the JAX package's for the same argv."""
    preset = tmp_path / "p.json"
    preset.write_text(json.dumps({
        "batch_size": 1024, "epochs": 7, "lr_schedule": "linear",
        "n_train_samples": [4, 3], "n_val_samples": [4, 3],
        "output_dims": [16, 16],
    }))
    argv = ["--config", str(preset), "--synthetic", "sbm", "--synthetic-nodes", "300",
            "--batch-size", "256", "--epochs", "1", "--no-eval", "--patience", "2",
            "--compute-dtype", "bfloat16", "--gather-chunks", "4"]
    assert main(argv + ["--device", "cpu"]) == 0
    cfg = _capture(capsys)[0]["config"]
    assert cfg["batch_size"] == 256     # explicit flag (== argparse default)
    assert cfg["epochs"] == 1           # explicit flag
    assert cfg["lr_schedule"] == "linear"  # preset value kept
    assert jax_main(argv) == 0
    assert _capture(capsys)[0]["config"] == cfg


def test_parse_ints():
    args = parse_args(["--synthetic", "sbm", "--n-train-samples", "5,3,2"])
    assert args.n_train_samples == "5,3,2"
    assert args.device == "cuda"


@pytest.mark.parametrize("flag,config", [
    (["--partitioned"], {}),
    (["--halo", "ring"], {"halo": "ring"}),
    (["--halo", "bucketed", "--halo-capacity-factor", "0.5"], {"halo_capacity_factor": 0.5}),
    (["--halo-chunks", "4"], {"halo_chunks": 4}),
    (["--halo", "measured", "--halo-measure-steps", "3"], {"halo_measure_steps": 3}),
    (["--reorder", "degree"], {}),
], ids=["partitioned", "halo", "halo-capacity-factor", "halo-chunks", "halo-measure-steps",
        "reorder"])
def test_partitioned_flag_runs_at_world_1(capsys, flag, config):
    """Each partitioned flag exited 2 until ROADMAP Queue 1 item 14's
    supervised slice; with ``--partitioned --device cpu`` it now trains one
    rank in this process: the flag reaches the config, the run logs one
    shard and the halo mode it resolved (``measured`` races nothing at one
    shard), a finite loss, the bucketed overflow count, the reorder line."""
    argv = TINY + ["--epochs", "1", "--partitioned"] + [f for f in flag if f != "--partitioned"]
    assert main(argv) == 0
    recs = _capture(capsys)
    for k, v in config.items():
        assert recs[0]["config"][k] == v
    head = next(r for r in recs if "n_shards" in r and "epoch" not in r)
    assert head["n_shards"] == 1
    assert head["halo"] == {"ring": "ring", "bucketed": "bucketed"}.get(
        flag[1] if len(flag) > 1 else "", "exact")
    epochs = [r for r in recs if "train_loss" in r]
    assert len(epochs) == 1 and np.isfinite(epochs[0]["train_loss"])
    assert ("halo_overflow" in epochs[0]) == (head["halo"] == "bucketed")
    if flag[0] == "--reorder":
        assert any(r.get("reorder") == "degree" and r["edge_cut_after"] == 0.0 for r in recs)


def test_partitioned_unsupervised_exits_2_naming_item_14(capsys):
    """Exited 2 naming ROADMAP Queue 1 item 14 until that item's last slice;
    now ``--partitioned --unsupervised`` trains the NCE objective on one
    rank in this process: one shard, the exact exchange, a finite NCE loss
    per epoch and the probe on the partitioned embeddings."""
    assert main(TINY + ["--epochs", "2", "--partitioned", "--unsupervised",
                        "--walk-length", "2", "--n-negatives", "4"]) == 0
    recs = _capture(capsys)
    assert {"n_shards": 1, "halo": "exact"} in recs
    epochs = [r for r in recs if "unsup_loss" in r]
    assert [r["epoch"] for r in epochs] == [0, 1] and all(r["n_shards"] == 1 for r in epochs)
    assert np.isfinite([r["unsup_loss"] for r in epochs]).all()
    assert 0.0 <= recs[-1]["probe_val_accuracy"] <= 1.0


def test_halo_hier2d_exits_2_naming_item_14(capsys):
    """Exited 2 naming ROADMAP Queue 1 item 14 until that item's last slice;
    now ``--halo hier2d`` trains over the group's (host, chip) layout, (1,
    1) for one rank in this process."""
    assert main(TINY + ["--epochs", "1", "--partitioned", "--halo", "hier2d"]) == 0
    recs = _capture(capsys)
    assert recs[0]["config"]["halo"] == "hier2d"
    assert {"n_shards": 1, "halo": "hier2d", "layout": [1, 1]} in recs
    epochs = [r for r in recs if "train_loss" in r]
    assert len(epochs) == 1 and np.isfinite(epochs[0]["train_loss"])


@pytest.mark.parametrize("flag", ["--unsupervised", "--fuse-first-layer"])
def test_training_flag_is_accepted_and_reaches_fit(monkeypatch, capsys, flag):
    """Refused until ROADMAP Queue 1 items 12 (``--unsupervised``) and 13
    (``--fuse-first-layer``) were ported. ``--unsupervised`` reaches
    ``fit_unsupervised`` with the walk length, negatives, probe interval,
    ``probe=not --no-eval`` and ``csr=--csr-adjacency``; ``--fuse-first-layer``
    reaches ``fit`` as ``fuse_first_layer`` in the config. Either run trains
    with a falling loss, and echoes the config the JAX package's CLI echoes
    for the same argv; with ``--device cuda`` and no card it exits 2."""
    from tpu_sage_torch.train import trainer, unsupervised

    seen = {}
    module, name = (unsupervised, "fit_unsupervised") if flag == "--unsupervised" \
        else (trainer, "fit")
    real = getattr(module, name)

    def spy(problem, config, *args, **kw):
        seen.update(config=config, args=args, **kw)
        return real(problem, config, *args, **kw)

    monkeypatch.setattr(module, name, spy)
    argv = TINY[:-2] + ["--epochs", "3", "--batch-size", "64", "--csr-adjacency", flag]
    if flag == "--unsupervised":
        argv += ["--walk-length", "2", "--n-negatives", "4", "--probe-every", "3"]
    assert main(argv + ["--device", "cpu"]) == 0
    recs = _capture(capsys)
    assert seen["csr"] is True and seen["device"] == "cpu"
    key = "train_loss"
    if flag == "--unsupervised":
        assert seen["args"][0] == unsupervised.UnsupConfig(walk_length=2, n_negatives=4,
                                                           probe_every=3)
        assert seen["probe"] is True
        assert any("probe_val_accuracy" in r for r in recs)
        key = "unsup_loss"
    else:
        assert seen["config"].fuse_first_layer is True
    losses = [r[key] for r in recs if key in r]
    assert len(losses) == 3 and losses[-1] < losses[0]
    cfg = recs[0]["config"]
    assert jax_main(argv + ["--no-eval"]) == 0
    assert _capture(capsys)[0]["config"] == cfg
    if not torch.cuda.is_available():  # the card is the default: without one, exit 2
        assert main(argv) == 2
        assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--csr-adjacency", "--feature-int8"])
def test_storage_flag_is_accepted_and_reaches_fit(monkeypatch, capsys, flag):
    """Refused until ROADMAP Queue 1 items 10 (``--feature-int8``) and 11
    (``--csr-adjacency``) were ported: the flag now reaches ``fit``, as
    ``csr=True`` or as ``feature_int8`` in the config, which the run echoes
    as the JAX package's CLI does for the same argv."""
    from tpu_sage_torch.train import trainer

    seen = {}
    real_fit = trainer.fit

    def spy(problem, config, **kw):
        seen.update(config=config, csr=kw["csr"])
        return real_fit(problem, config, **kw)

    monkeypatch.setattr(trainer, "fit", spy)
    argv = TINY[:-2] + ["--epochs", "1", "--no-eval", flag]  # TINY ends in --device cpu
    assert main(argv + ["--device", "cpu"]) == 0
    assert seen["csr"] is (flag == "--csr-adjacency")
    assert seen["config"].feature_int8 is (flag == "--feature-int8")
    cfg = _capture(capsys)[0]["config"]
    assert jax_main(argv) == 0
    assert _capture(capsys)[0]["config"] == cfg


def test_int8_csr_bf16_run_through_the_cli(capsys):
    """Both storage flags together, bf16, with exact validation: the full
    graph stays dense for it (the note), losses finite, val metric sane."""
    assert main(TINY + ["--epochs", "2", "--feature-int8", "--csr-adjacency",
                        "--compute-dtype", "bfloat16", "--exact-val"]) == 0
    recs = _capture(capsys)
    assert recs[0]["config"]["feature_int8"] is True
    assert any("densifies the FULL-graph adjacency" in r.get("note", "") for r in recs)
    epochs = [r for r in recs if "elapsed" in r]
    assert len(epochs) == 2 and all(np.isfinite(r["train_loss"]) for r in epochs)
    assert 0.0 <= epochs[-1]["val_metric"] <= 1.0


def test_cuda_without_a_card_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the refusal without one")
    assert main(["--synthetic", "sbm", "--epochs", "1"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_checkpoint_every_needs_a_path():
    assert main(TINY + ["--epochs", "1", "--checkpoint-every", "1"]) == 2


def test_save_best_resume_through_the_cli(tmp_path, capsys):
    """The serving path's training half: --save-best with --checkpoint-every
    and exact validation every --val-interval batches; a second, longer run
    resumes at the next epoch, compares against the stored best metric and
    ends with the final state in the .last file."""
    ck, logp = str(tmp_path / "m.npz"), str(tmp_path / "log.jsonl")
    argv = TINY + ["--checkpoint-path", ck, "--checkpoint-every", "1", "--save-best",
                   "--exact-val", "--val-interval", "2", "--log-path", logp]
    assert main(argv + ["--epochs", "2"]) == 0
    assert os.path.exists(ck) and os.path.exists(ck + ".last")
    capsys.readouterr()
    assert main(argv + ["--epochs", "3"]) == 0
    with open(logp) as f:
        recs = [json.loads(l) for l in f]
    resumed = [r for r in recs if "resumed_from" in r]
    # the later of the two files; at a tie (the last epoch was the best) the
    # best file, as in the JAX package
    assert len(resumed) == 1 and resumed[0]["resumed_from"] in (ck, ck + ".last")
    assert resumed[0]["start_epoch"] == 2
    after = recs[recs.index(resumed[0]):]
    assert [r["epoch"] for r in after if "elapsed" in r] == [2]
    assert any("batch_offset" in r for r in after)
    assert any("resumed_best_metric" in r for r in after)
    assert _capture(capsys)[-1] == {"checkpoint": ck + ".last"}
