"""Profiling harness (counterpart of ``tpu_sage/bench/profile.py``).

Times the port's ``Trainer`` steps at the main path's configuration on a
Reddit-shaped ``bench_store`` and, with ``--trace``, records them with
``torch.profiler`` (CPU and CUDA activities) into a Chrome trace in the
trace directory, readable in Perfetto or ``chrome://tracing``. A traced
run also returns ``spans``, ``tpu_sage_torch.tracing.summary()`` of the
profiled steps: per span name (``tsg.train.step`` and its children
``tsg.train.sample``, ``.forward``, ``.backward``, ``.optimizer``) its
``count``, ``device_ms`` and ``self_device_ms`` (CUDA events; None on the
CPU), ``host_ms`` and summed counters (the step's ``edges``)::

    python -m tpu_sage_torch.bench.profile --trace --trace-dir build/trace \\
        --compute-dtype bfloat16
    python -m tpu_sage_torch.bench.profile --device cpu --n-nodes 2000 --steps 3
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time


def edges_per_batch(batch_size: int, fanouts) -> int:
    """Sampled edges aggregated per step: ``B·(f₁ + f₁·f₂ + …)``, the
    bench-harness definition, any tree depth."""
    total, level = 0, batch_size
    for f in fanouts:
        level *= int(f)
        total += level
    return total


def profile_steps(trace_dir: str, steps: int = 20, batch_size: int = 512,
                  compute_dtype: str = "float32", trace: bool = False,
                  n_nodes: int = None, feat_dim: int = 602, fanouts=(25, 10),
                  device: str = "cuda") -> dict:
    """``steps`` timed ``train_step``s on one batch after one untimed step,
    ending in ``torch.cuda.synchronize()`` on the card. ``trace=True``
    records them with ``torch.profiler`` and writes
    ``<trace_dir>/trace.json``. Returns ``ms_per_step``, ``trace_dir`` (None
    without a trace), ``edges_per_sec``, the device's name and ``spans``
    (the traced steps' ``tracing.summary()``; empty without a trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_sage_torch import tracing
    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.data.synthetic import bench_store
    from tpu_sage_torch.train.trainer import COMPUTE_DTYPES, TrainConfig, Trainer, build_model

    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("device cuda needs a CUDA card; pass device='cpu' for the CPU")
    store = (bench_store() if n_nodes is None
             else bench_store(n_nodes=n_nodes, feat_dim=feat_dim))
    problem = NodeProblem(store)
    fanouts = tuple(int(f) for f in fanouts)
    config = TrainConfig(batch_size=batch_size, n_train_samples=fanouts,
                         n_val_samples=fanouts, output_dims=(128, 128),
                         compute_dtype=compute_dtype)
    train_ids = problem.folds["train"]
    model = build_model(config, problem.n_nodes, problem.n_classes, problem.feats_dim)
    trainer = Trainer(model, config, len(train_ids) // batch_size, task=problem.task)
    graph = problem.device_graph(train=True, dtype=COMPUTE_DTYPES[compute_dtype],
                                 device=device)
    state = trainer.init_state(graph)
    ids = torch.as_tensor(train_ids[:batch_size], dtype=torch.int32, device=device)
    tgt = graph.targets[ids.long()]

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    state, _ = trainer.train_step(state, graph, ids, tgt)  # kernels built and loaded
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    tracing.reset()
    with profile(activities=activities) if trace else contextlib.nullcontext() as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = trainer.train_step(state, graph, ids, tgt)
        sync()
        dt = time.perf_counter() - t0
    if trace:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    if not torch.isfinite(m["loss"]).item():
        raise RuntimeError(f"non-finite loss {m['loss'].item()}")
    return {"ms_per_step": dt / steps * 1e3,
            "trace_dir": trace_dir if trace else None,
            "edges_per_sec": edges_per_batch(batch_size, fanouts) / (dt / steps),
            "device": torch.cuda.get_device_name(device) if on_card else "cpu",
            "spans": tracing.summary()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--trace-dir", default=os.path.join("build", "tpu_sage_torch", "trace"))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--trace", action="store_true", help="record a torch.profiler trace")
    ap.add_argument("--fanouts", default="25,10",
                    help="comma-separated per-layer fanouts (edges/s uses these)")
    ap.add_argument("--n-nodes", type=int, default=None,
                    help="bench_store nodes (default Reddit's 232,965)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    fanouts = tuple(int(f) for f in args.fanouts.split(","))
    print(json.dumps(profile_steps(args.trace_dir, args.steps, args.batch_size,
                                   args.compute_dtype, trace=args.trace,
                                   n_nodes=args.n_nodes, fanouts=fanouts,
                                   device=args.device)))


if __name__ == "__main__":
    main()
