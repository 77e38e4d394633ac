"""The rank path on the CPU: a cell on n > 1 cards as n gloo ranks at a toy
size, in lockstep, with one result line for the group; a rank that fails
ends the run with no result and no process left; and (``chip``) the
four-rank cell on the cards present."""

import contextlib
import json
import os
import signal
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.toy import PART, copy_checkout, run_apart, toy_cell, wrapped

SEED = 2**31 + 23
FAILURES_AT = 6  # the failing rank's pass: two of set-up, two timed, then the window's
GROUP_SETTINGS = {"WARM_SECONDS": 0.0, "GROUP_SETUP_S": 30.0, "GROUP_TAIL_S": 10.0}


def _group(world):
    spec = toy_cell(PART)
    spec["chips"] = world
    return spec


@pytest.mark.parametrize("world,trace", [(2, False), (4, True)])
def test_one_line_for_the_group_in_lockstep(world, trace):
    p = run_apart(_group(world), SEED, 0.5, trace)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.splitlines()
    assert len(lines) == 1  # no rank but 0 writes to standard output
    r = json.loads(lines[0])
    assert r["correct"] is True and r["failed"] == 0
    device = r["device"]
    assert device["count"] == world
    assert len(device["memory_peak_bytes_by_rank"]) == world
    assert device["memory_peak_bytes"] == max(device["memory_peak_bytes_by_rank"])
    # every rank: the same warm-up, window and traced steps
    steps = device["steps_by_rank"]
    assert len(steps) == world and all(s == steps[0] for s in steps)
    warm, window, traced = steps[0]
    assert warm >= 2 and window == r["attempted"] >= 1
    assert traced == (max(3, traced) if trace else 0)
    if trace:
        for name in ("busy_s", "window_s"):
            assert len(device[f"{name}_by_rank"]) == world
            assert device[name] == device[f"{name}_by_rank"][0]
    assert set(r["checks"]) == {"embed_err", "nonfinite_steps"}


@pytest.mark.parametrize("world", [2, 4])
def test_the_checks_are_the_worst_over_the_ranks(tmp_path, world):
    """One rank's answer altered after the pass: the group's line is not
    correct, with that rank's error."""
    spec = wrapped(_group(world), copy_checkout(tmp_path), f"{__name__}:last_rank_altered")
    r = harness.run_cell(spec, SEED, 0.3, False, torch.device("cpu"))
    assert r["correct"] is False and r["checks"]["embed_err"]["value"] > 0.1


@contextlib.contextmanager
def last_rank_altered():
    """One node's embedding in the last rank's shard changed where the pass
    produces it."""
    from tpu_sage_torch.dist import mesh
    from tpu_sage_torch.nn import full_graph

    real = full_graph.embed_all_nodes_partitioned

    def altered(*a, **kw):
        out = real(*a, **kw)
        if mesh.rank() == mesh.world() - 1:
            out = out.clone()
            out[3] *= -1.0
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(full_graph, "embed_all_nodes_partitioned", altered)
        yield


_passes = 0  # of this process


@contextlib.contextmanager
def _failing(rank, act):
    """Rank ``rank``'s pass number ``FAILURES_AT`` runs ``act`` first; every
    rank names its process in the directory ``BENCH_TEST_PIDS``."""
    global _passes
    from tpu_sage_torch.dist import mesh

    _passes += 1
    open(os.path.join(os.environ["BENCH_TEST_PIDS"], str(os.getpid())), "w").close()
    if mesh.rank() == rank and _passes == FAILURES_AT:
        act()
    yield


def _raise():
    raise RuntimeError("a rank raised in the window")


def rank1_raises():
    return _failing(1, _raise)


def rank0_raises():
    return _failing(0, _raise)


def rank1_hangs():
    return _failing(1, lambda: time.sleep(3600))


def rank1_killed():
    return _failing(1, lambda: os.kill(os.getpid(), signal.SIGKILL))


@pytest.mark.parametrize("fault", ["rank1_raises", "rank0_raises", "rank1_hangs", "rank1_killed"])
def test_a_failing_rank_ends_the_run(tmp_path, monkeypatch, fault):
    """Mid-window: no result line, an exit code other than 0 within the
    group's time limit, and every rank's process gone."""
    pids = tmp_path / "pids"
    pids.mkdir()
    monkeypatch.setenv("BENCH_TEST_PIDS", str(pids))
    spec = wrapped(_group(4), copy_checkout(tmp_path), f"{__name__}:{fault}")
    t0 = time.monotonic()
    p = run_apart(spec, SEED, 3.0, **GROUP_SETTINGS)
    took = time.monotonic() - t0
    assert p.returncode != 0 and p.stdout == "", p.stderr[-3000:]
    limit = GROUP_SETTINGS["GROUP_SETUP_S"] + 3.0 + GROUP_SETTINGS["GROUP_TAIL_S"]
    assert took < limit + 30.0
    seen = [int(f) for f in os.listdir(pids)]
    assert len(seen) == 4
    for pid in seen:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


@pytest.mark.chip
@pytest.mark.parametrize("trace", [False, True])
def test_the_four_rank_cell_on_the_cards_present(card, trace):
    n = min(4, torch.cuda.device_count())
    if n < 2:
        pytest.skip("one card: a group needs two or more")
    spec = harness.load_cell(PART)
    spec["chips"] = n
    r = harness.run_cell(spec, SEED + int(trace), 3.0, trace, card)
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["embed_err"]["value"] <= spec["limits"]["embed_err"]
    device = r["device"]
    assert device["count"] == n and device["kind"] == torch.cuda.get_device_name(0)
    by_rank = device["memory_peak_bytes_by_rank"]
    assert len(by_rank) == n and device["memory_peak_bytes"] == max(by_rank) > 0
    assert len({tuple(s) for s in device["steps_by_rank"]}) == 1
    for name, m in r["metrics"].items():
        if m["unit"] == "%" and name != "device_idle_pct.infer":
            assert 0 < m["value"] <= 100.0, (name, m)
    if trace:
        assert 0 < device["busy_s"] <= device["window_s"]


def test_readings_of_a_group_from_the_module_run_by_path():
    """``python3 -m benchmark.readings`` runs the module as ``__main__``;
    its ranks still find the function they run."""
    from benchmark import files, readings

    script = files.load_module(readings.__file__)  # a module no rank can import by its name
    lines = script.readings(_group(2), [SEED, SEED + 1], ["program", "control"],
                            torch.device("cpu"))
    assert [(r["what"], r["seed"]) for r in lines] == [
        ("program", SEED), ("program", SEED + 1), ("control", SEED), ("control", SEED + 1)]
    assert all(r["cell"] == PART for r in lines)
    assert lines[0]["embed_err"] < 2e-4 < lines[2]["embed_err"]
