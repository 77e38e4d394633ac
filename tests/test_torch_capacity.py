"""tpu_sage_torch.bench.capacity and the CLI's out-of-memory advice, on the CPU.

The model's fixed bytes must be the port's own device tensors' bytes (the
CPU graphs hold the same tensors the card would), ``max_nodes`` must invert
``resident_bytes``, every flag the advice names must parse in the port's
CLI, and the CLI must turn ``torch.cuda.OutOfMemoryError``, and nothing else,
into the advice and exit code 1 (the JAX package's
``tests/test_cli.py::test_oom_exits_with_capacity_advice``).
"""

import math
import re

import pytest
import torch

from tpu_sage_torch import cli
from tpu_sage_torch.bench import capacity
from tpu_sage_torch.data.problem import NodeProblem
from tpu_sage_torch.data.synthetic import bench_store

N, D, DEG = 600, 24, 16
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CLI_ARGS = ["--synthetic", "sbm", "--synthetic-nodes", "120", "--n-train-samples", "3,2",
            "--n-val-samples", "3,2", "--output-dims", "8,8", "--batch-size", "16",
            "--epochs", "1", "--device", "cpu"]


def _tensors(graph):
    for v in vars(graph).values():
        if isinstance(v, torch.Tensor):
            yield v
        elif hasattr(v, "q"):  # QuantizedFeats: its int8 rows and f32 scales
            yield v.q
            yield v.scale


@pytest.mark.parametrize("n_graphs", [1, 2])
@pytest.mark.parametrize("feature", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("adjacency", ["dense", "csr"])
def test_fixed_bytes_are_the_port_device_tensors(adjacency, feature, n_graphs):
    """One graph (the train-edge one) or two (``fit``'s train-edge and
    full-edge graphs, sharing one feature table), every row at full degree
    so ``avg_degree`` is the max degree."""
    problem = NodeProblem(bench_store(n_nodes=N, feat_dim=D, n_classes=5, max_degree=DEG,
                                      cache_dir="0"))
    int8 = feature == "int8"
    kw = dict(dtype=torch.bfloat16 if int8 else DTYPES[feature], device="cpu",
              csr=adjacency == "csr", quantize=int8)
    graphs = [problem.device_graph(train=t, **kw) for t in (True, False)[:n_graphs]]
    tensors = {id(t): t for g in graphs for t in _tensors(g)}
    held = sum(t.numel() * t.element_size() for t in tensors.values())
    cfg = capacity.CapacityConfig(feat_dim=D, max_degree=DEG, avg_degree=DEG, feature=feature,
                                  adjacency=adjacency, n_graphs=n_graphs)
    assert capacity.fixed_bytes(N, cfg) == held
    if n_graphs == 1:
        assert capacity.device_tensor_bytes(graphs[0]) == held


@pytest.mark.parametrize("cfg", [
    capacity.CapacityConfig(),
    capacity.CapacityConfig(feature="int8", n_graphs=2),
    capacity.CapacityConfig(feature="float32", mode="infer"),
    capacity.CapacityConfig(feat_dim=100, max_degree=64, avg_degree=40, adjacency="csr"),
], ids=["bf16-train", "int8-fit", "f32-infer", "csr-100"])
@pytest.mark.parametrize("hbm_gb", [24, 80])
def test_max_nodes_inverts_resident_bytes(cfg, hbm_gb):
    hbm = hbm_gb * 10**9
    n = capacity.max_nodes(cfg, hbm)
    budget = hbm - capacity.SLACK_BYTES
    assert n > 0
    assert capacity.resident_bytes(n, cfg) <= budget
    assert (capacity.resident_bytes(n + 1, cfg) > budget
            or capacity.csr_indices_len(n + 1, cfg) > capacity.INT32_LIMIT)
    if cfg.mode == "train" and cfg.avg_degree == cfg.max_degree:  # the CLI's configurations
        args = (cfg.feat_dim, cfg.max_degree, cfg.adjacency == "csr", cfg.feature,
                cfg.n_graphs, hbm)
        assert not capacity.over_budget(n, *args) and capacity.over_budget(n + 1, *args)


def test_max_nodes_is_zero_when_nothing_fits_and_csr_keeps_int32_offsets():
    cfg = capacity.CapacityConfig()
    assert capacity.max_nodes(cfg, capacity.SLACK_BYTES) == 0
    assert capacity.max_nodes(cfg, capacity.SLACK_BYTES - 1) == 0
    assert capacity.max_nodes(cfg, capacity.SLACK_BYTES + capacity.resident_bytes(1, cfg)) == 1
    csr = capacity.CapacityConfig(adjacency="csr")
    n = capacity.max_nodes(csr, 10**12)
    assert capacity.csr_indices_len(n, csr) <= capacity.INT32_LIMIT
    assert capacity.csr_indices_len(n + 1, csr) > capacity.INT32_LIMIT
    # the envelope at the H100 80GB's memory, the default without a card
    rows = capacity.capacity_table(capacity.HBM_BYTES)
    assert len(rows) == 24 and all(r["max_nodes"] > 0 for r in rows)


def test_every_flag_the_advice_names_parses_in_the_port_cli():
    advice = capacity.oom_advice(10**8, 602, 128, csr=False, feature="float32")
    flags = set(re.findall(r"--[a-z0-9-]+", advice))
    assert flags == {"--compute-dtype", "--csr-adjacency", "--feature-int8", "--partitioned"}
    assert "python -m tpu_sage_torch.bench.capacity" in advice
    for flag in flags:
        args = cli.parse_args(CLI_ARGS + [flag] + (["bfloat16"] if flag == "--compute-dtype"
                                                   else []))
        assert getattr(args, flag.lstrip("-").replace("-", "_")) in (True, "bfloat16")
    # what the run already uses is not advised
    lean = capacity.oom_advice(10**8, 602, 128, csr=True, feature="int8")
    assert set(re.findall(r"--[a-z0-9-]+", lean)) == {"--partitioned"}


def _oom(*_):
    raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")


@pytest.mark.parametrize("extra,storage", [
    ([], "float32 features, 2 resident graph(s)"),
    (["--no-eval"], "float32 features, 1 resident graph(s)"),
    (["--no-eval", "--val-interval", "5"], "float32 features, 2 resident graph(s)"),
    (["--compute-dtype", "bfloat16"], "bfloat16 features, 2 resident"),
    (["--feature-int8", "--csr-adjacency"], "csr adjacency, int8 features"),
], ids=["fit", "no-eval", "val-interval", "bf16", "int8-csr"])
def test_out_of_memory_exits_with_the_advice(monkeypatch, capsys, extra, storage):
    monkeypatch.setattr(cli, "_run_fit", _oom)
    assert cli.main(CLI_ARGS + extra) == 1
    err = capsys.readouterr().err
    assert err.startswith("error: graph does not fit device memory")
    assert "120 nodes x 64 feats" in err and storage in err
    assert "Traceback" not in err


def test_other_errors_propagate(monkeypatch):
    def other(*_):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(cli, "_run_fit", other)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        cli.main(CLI_ARGS)


def test_partitioned_advice_models_the_nodes_per_rank(monkeypatch, capsys):
    from tpu_sage_torch.data.synthetic import synthetic_problem
    from tpu_sage_torch.dist import mesh
    from tpu_sage_torch.train.trainer import TrainConfig

    monkeypatch.setattr(cli, "_run_fit", _oom)
    monkeypatch.setattr(mesh, "world", lambda: 4)
    args = cli.parse_args(CLI_ARGS + ["--partitioned", "--synthetic-nodes", "121"])
    problem = synthetic_problem("sbm", 121, 7, 64, seed=0)
    assert cli._fit_or_advise(args, problem, TrainConfig(), None) == 1
    assert f"{math.ceil(121 / 4)} nodes x 64 feats" in capsys.readouterr().err


def test_a_spawned_rank_out_of_memory_fails_the_run_with_exit_1(monkeypatch, capsys):
    """One rank per card, spawned: the rank's exit code 1 must fail the
    group and the CLI (a fake ``start_processes`` runs the ranks here, as
    the spawned processes would, and fails the group as torch's join does)."""
    import torch.multiprocessing as mp

    from tpu_sage_torch.dist import mesh

    def start_processes(fn, args, nprocs, join, start_method):
        for i in range(nprocs):
            try:
                fn(i, *args)
            except SystemExit as e:  # the spawned process's exit code
                raise mp.ProcessExitedException(
                    f"process {i} terminated with exit code {e.code}", i, 0, e.code)

    monkeypatch.setattr(mp, "start_processes", start_processes)
    monkeypatch.setattr(mesh, "init_process_group", lambda *a, **k: None)
    monkeypatch.setattr(mesh, "destroy_process_group", lambda: None)
    monkeypatch.setattr(cli, "cuda_missing", lambda device: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(cli, "_run_fit", _oom)
    argv = [a if a != "cpu" else "cuda" for a in CLI_ARGS] + ["--partitioned"]
    assert cli.main(argv) == 1
    err = capsys.readouterr().err
    assert err.startswith("error: graph does not fit device memory") and "Traceback" not in err
    # a rank that finishes returns 0 and the run exits 0
    monkeypatch.setattr(cli, "_run_fit", lambda *a: 0)
    assert cli.main(argv) == 0
