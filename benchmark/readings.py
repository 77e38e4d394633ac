"""The readings a cell's limits are set from, at the cell's own size, many
seeds in one process (set-up is most of the cost)::

    python3 -m benchmark.readings --workload reddit-sup.train-b512 \\
        --seeds 11,12,13 --what program,control,half_batch

For each seed and each kind of reading, one JSON line with the numbers the
check compares:

- ``program``: the sound program, as a run drives it (training: set-up and
  its first three steps; exact: one pass), compared with the reference;
- ``control``: the nearest lower precision in the program's place. For the
  bfloat16 training configuration it is the program's own int8 feature
  table (``feature_int8``); for the float32 exact pass it is the reference
  with every product's inputs rounded to TF32;
- ``program_tf32`` (exact only): the program with TF32 products allowed, a
  second witness of the control;
- ``half_batch`` (training only): the program with its loss taken over half
  of each batch, the other half left out.

The benchmark's own runs never run these; they are for setting and
re-checking the limits in ``limits/<cell>.json`` on the card. A cell on
more than one card reads in one group of ranks (``ranks.py``), every seed
in it, and each number of a line is its worst over the ranks.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from benchmark import checks, harness, ranks

TRAIN_WHAT = ("program", "control", "half_batch")
EXACT_WHAT = ("program", "control", "program_tf32")


@contextlib.contextmanager
def half_batch():
    """The program's loss over the first half of each batch only."""
    from tpu_sage_torch.train import losses

    full = losses.loss_lookup["classification"]
    losses.loss_lookup["classification"] = \
        lambda logits, t: full(logits[:logits.shape[0] // 2], t[:t.shape[0] // 2])
    try:
        yield
    finally:
        losses.loss_lookup["classification"] = full


READING_S = 120.0  # a group's time limit for each reading, beside its set-up


def reading(spec: dict, seed: int, what: str, device: torch.device) -> dict:
    """One reading of the numbers the check compares."""
    return readings(spec, [seed], [what], device)[0]


def readings(spec: dict, seeds, whats, device: torch.device) -> list:
    """``reading`` of each kind in ``whats`` for each seed, in that order: on
    one card one by one; on more, in one group of ranks, each number the
    worst over them."""
    heads = [{"cell": spec["name"], "what": what, "seed": seed} for what in whats for seed in seeds]
    if spec["chips"] == 1:
        values = [_values(spec, h["seed"], h["what"], device) for h in heads]
    else:
        # the ranks import the function by its module's name, also when this runs as a script
        from benchmark import readings as by_name

        per_rank = ranks.run(by_name._rank_values, (spec, heads), spec["chips"], device.type,
                             harness.GROUP_SETUP_S + READING_S * len(heads))
        values = [checks.worst(list(got)) for got in zip(*per_rank)]
    return [{**h, **v} for h, v in zip(heads, values)]


def _rank_values(device: torch.device, spec: dict, heads: list) -> list:
    out = []
    for h in heads:
        out.append(_values(spec, h["seed"], h["what"], device))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _values(spec: dict, seed: int, what: str, device: torch.device) -> dict:
    session_cls = harness.driver(spec["dir"], spec["traffic"]["driver"]).Session
    if session_cls.work_unit == "nodes":  # an exact pass
        session = session_cls(spec, seed, device)
        if what == "control":
            session.outputs = [session.reference("tf32")]
        else:
            torch.backends.cuda.matmul.allow_tf32 = what == "program_tf32"
            try:
                session.step()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
    elif what == "half_batch":
        with half_batch():
            session = session_cls(spec, seed, device)
    else:
        session = session_cls(spec, seed, device,
                              {"feature_int8": True} if what == "control" else None)
    session.release()
    return session.compare()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--what", default=None, help="comma-separated kinds of reading")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_cell(args.workload)
    exact = harness.driver(spec["dir"], spec["traffic"]["driver"]).Session.work_unit == "nodes"
    whats = args.what.split(",") if args.what else (EXACT_WHAT if exact else TRAIN_WHAT)
    device = torch.device("cuda", 0)
    from tpu_sage_torch.kernels import _build
    _build.build()
    seeds = [int(s) for s in args.seeds.split(",")]
    if spec["chips"] > 1:
        lines = readings(spec, seeds, whats, device)
    else:
        lines = (reading(spec, seed, what, device) for what in whats for seed in seeds)
    for values in lines:
        line = json.dumps(values)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
