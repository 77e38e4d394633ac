"""Weak scaling of the partitioned training step (counterpart of
``tpu_sage/bench/scaling.py``).

    python3 -m tpu_sage_torch.bench.scaling --devices 1,2,4 [--device cpu]

For each rank count ``n`` (capped at the visible cards; one NCCL rank per
card, ``--device cpu`` one gloo rank per process) the node-sharded step of
``dist/train.py`` runs on ``bench_store(n_nodes=--nodes)`` (602 features,
mean, identity, fanouts (25, 10), dims (128, 128), exact exchange) with the
per-shard batch held at ``--batch-per-shard``, so the global batch grows
with ``n``. One warm-up step, then ``--steps`` timed on the host's clock,
ending in a synchronize. Prints one JSON line per count: ``n_devices``,
``edges_per_sec`` (``B·(f1 + f1·f2)`` sampled edges per step), ``ms_per_step``,
``batch_size``, ``efficiency`` against the one-shard run's edges/s per shard,
and the device's name (or ``cpu``). A CPU run validates the harness only:
its numbers are not device numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

FANOUTS = (25, 10)


def _rank(out: str, n_nodes: int, batch_per_shard: int, steps: int, feat_dim: int,
          seed: int) -> None:
    """One rank's run; the first writes ``out``."""
    import torch

    from tpu_sage_torch.data.synthetic import bench_store
    from tpu_sage_torch.dist.mesh import rank, world
    from tpu_sage_torch.dist.train import PartitionedTrainer
    from tpu_sage_torch.train.trainer import TrainConfig

    n = world()
    device = (torch.device("cuda", torch.cuda.current_device())
              if torch.distributed.get_backend() == "nccl" else torch.device("cpu"))
    store = bench_store(n_nodes=n_nodes, feat_dim=feat_dim, seed=seed)
    config = TrainConfig(batch_size=batch_per_shard * n, n_train_samples=FANOUTS,
                         n_val_samples=FANOUTS, output_dims=(128, 128), halo="exact")
    trainer, graph, fold_ids, fold_w = PartitionedTrainer.from_store(store, config, device)
    state = trainer.init_state()

    def sync(m):
        float(m["loss"])  # the loss is all-reduced: a sync on every rank

    state, m = trainer.train_step(state, graph, fold_ids, fold_w)
    sync(m)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = trainer.train_step(state, graph, fold_ids, fold_w)
    sync(m)
    dt = time.perf_counter() - t0
    if rank() == 0:
        edges = steps * config.batch_size * (FANOUTS[0] + FANOUTS[0] * FANOUTS[1])
        rec = {"n_devices": n, "edges_per_sec": edges / dt, "ms_per_step": dt / steps * 1e3,
               "batch_size": config.batch_size,
               "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                          else "cpu")}
        with open(out, "w") as f:
            json.dump(rec, f)


def measure(n_devices: int, n_nodes: int, batch_per_shard: int, steps: int,
            device: str = "cuda", feat_dim: int = 602, seed: int = 0) -> dict:
    """One count's record: ``n_devices`` ranks (spawned; one runs in this
    process)."""
    from tpu_sage_torch.dist import mesh

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        args = (out, n_nodes, batch_per_shard, steps, feat_dim, seed)
        if n_devices == 1:
            mesh.run_in_process(_rank, device, args)
        else:
            mesh.spawn(_rank, n_devices, device, args)
        with open(out) as f:
            return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--nodes", type=int, default=65536)
    ap.add_argument("--batch-per-shard", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: --device cuda needs a CUDA card; pass --device cpu")
    visible = torch.cuda.device_count() if args.device == "cuda" else None
    counts = [int(x) for x in args.devices.split(",")]
    if visible is not None:
        counts = sorted({min(c, visible) for c in counts})
    base = None
    for n in counts:
        r = measure(n, args.nodes, args.batch_per_shard, args.steps, args.device)
        if base is None:
            base = r["edges_per_sec"] / r["n_devices"]
        r["efficiency"] = r["edges_per_sec"] / (base * r["n_devices"])
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
