"""The partitioned path through its entry points, on every visible card.

    python3 -m tpu_sage_torch.bench.partitioned [--nodes N] [--device cpu]

On the Reddit-shaped store (``--synthetic reddit-shaped``) at
``configs/ogbn_products_dist.json``'s width, one rank per visible card:

1. ``tpu_sage_torch.cli --partitioned`` with the preset's ``halo:
   measured`` (the race's ms/step of exact, ring and pipelined; the winner
   trains 2 epochs with exact validation and writes a checkpoint);
2. the CLI with ``--halo bucketed`` for one epoch (its overflow count);
3. ``tpu_sage_torch.export --partitioned`` from that checkpoint and the
   single-device export, and the largest difference of their logits.

Prints each run's records, the card's name and power limit, then one JSON
line: ``{"partitioned_entry_points": {...}}``. The ms/step of an epoch is its
``elapsed`` over the epoch's steps (host clock, training only). ``--device
cpu`` rehearses the runs on one CPU rank.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "ogbn_products_dist.json")


def _run(args, device):
    """Run ``python -m <args>``; return its JSON records, echoed."""
    cmd = [sys.executable, "-m", *args] + (["--device", "cpu"] if device == "cpu" else [])
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{' '.join(args[:1])} exited {out.returncode}:\n"
                           f"{out.stdout[-4000:]}\n{out.stderr[-8000:]}")
    recs = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    for rec in recs:
        if "config" not in rec:
            print(json.dumps(rec), flush=True)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=232_965)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    graph = ["--synthetic", "reddit-shaped", "--synthetic-nodes", str(args.nodes)]
    card = None
    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "partitioned.npz")
        fit = _run(["tpu_sage_torch.cli", "--config", CONFIG, *graph, "--partitioned",
                    "--epochs", "2", "--halo-measure-steps", "50", "--exact-val",
                    "--checkpoint-path", ck], args.device)
        bucketed = _run(["tpu_sage_torch.cli", "--config", CONFIG, *graph, "--partitioned",
                         "--epochs", "1", "--halo", "bucketed", "--no-eval"], args.device)
        outs = {}
        for label, extra in (("partitioned", ["--partitioned"]), ("single", [])):
            outs[label] = os.path.join(tmp, f"{label}.npy")
            _run(["tpu_sage_torch.export", *graph, "--checkpoint", ck, "--checkpoint-config",
                  "--logits", "--out", outs[label], *extra], args.device)
        a, b = np.load(outs["partitioned"]), np.load(outs["single"])
    with open(CONFIG) as f:
        batch = json.load(f)["batch_size"]
    steps = (args.nodes - 2 * int(args.nodes * 0.1)) // batch  # bench_store's train fold
    head = next(r for r in fit if "n_shards" in r and "epoch" not in r)
    epochs = [r for r in fit if "elapsed" in r]
    b_epochs = [r for r in bucketed if "elapsed" in r]
    if card:
        print("\n".join(card), flush=True)
    print(json.dumps({"partitioned_entry_points": {
        "cards": card, "n_shards": head["n_shards"], "halo": head["halo"],
        "halo_measured_ms_per_step": head.get("halo_measured_ms"),
        "steps_per_epoch": steps,
        "epoch_ms_per_step": [1e3 * r["elapsed"] / steps for r in epochs],
        "val_metric_exact": [r.get("val_metric") for r in epochs],
        "bucketed_ms_per_step": [1e3 * r["elapsed"] / steps for r in b_epochs],
        "bucketed_overflow": [r.get("halo_overflow") for r in b_epochs],
        "export_max_abs_diff": float(np.abs(a - b).max()),
        "export_scale": float(np.abs(b).max())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
