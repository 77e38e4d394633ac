"""Step times of this checkout against another's, in turns on one card: the
training steps whose sampler launches differ between the two.

    python -m tpu_sage_torch.bench.step_ab --other DIR [--steps 30] [--rounds 1]
        [--paths partitioned,partitioned_csr,partitioned_nce,csr,csr_nce]

``DIR`` holds another checkout of the repository (unpacked with ``git
archive`` into a git-ignored directory). Each turn is a fresh process that
imports ``tpu_sage_torch`` from one checkout (its root first on
``sys.path``; each builds its own kernels into its own ``build/``) and runs,
on ``bench_store()``:

- ``partitioned``: ``configs/ogbn_products_dist.json``'s step (batch 1,024,
  exact exchange) at world 1, an NCCL group of one rank in the process;
- ``partitioned_csr``: the same on CSR shards (the column pick at the owner);
- ``partitioned_nce``: the partitioned NCE step (batch 512, walk length 3,
  10 negatives, exact exchange) at world 1;
- ``csr``: the main path's configuration (batch 512, fanouts (25, 10),
  (128, 128), bf16) on CSR adjacency, one device;
- ``csr_nce``: the NCE step at the same configuration on CSR adjacency;
- ``int8``, ``int8_nce`` (not run unless ``--paths`` names them): the main
  path's step and the NCE step on the int8 table (dense adjacency), whose
  deepest levels go through the int8 fanout mean.

Each path: 3 warm-up steps, ``--steps`` timed steps ending in
``torch.cuda.synchronize()`` (ms/step on the host's clock), then 3 steps
under ``torch.profiler`` for the kernel launches a step (the host's
``cudaLaunchKernel`` calls) and the device kernel time a step. The turns
run other, this, this, other per round; one JSON line reports every turn,
after the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PATHS = ("partitioned", "partitioned_csr", "partitioned_nce", "csr", "csr_nce", "int8",
         "int8_nce")
DEFAULT_PATHS = PATHS[:5]
WARMUP, PROFILED = 3, 3


def _profile(torch, step):
    """(host kernel launches, device kernel ms) per call of ``step``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            step()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    launches = sum(e.count for e in avgs if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                      "cudaLaunchKernelExC"))
    device_us = sum(e.self_device_time_total for e in avgs
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    return launches / PROFILED, device_us / 1e3 / PROFILED


def _timed(torch, step, steps):
    import time

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches, device_ms = _profile(torch, step)
    return {"ms_per_step": ms, "kernel_launches_per_step": launches,
            "device_kernel_ms_per_step": device_ms}


def _turn(steps: int, paths) -> dict:
    """One checkout's steps, in this process (its root already first on
    ``sys.path``)."""
    import numpy as np
    import torch

    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.data.synthetic import bench_store
    from tpu_sage_torch.dist import mesh
    from tpu_sage_torch.dist.train import PartitionedTrainer
    from tpu_sage_torch.dist.unsupervised import PartitionedUnsupervisedTrainer
    from tpu_sage_torch.train.trainer import TrainConfig, Trainer, build_model
    from tpu_sage_torch.train.unsupervised import (UnsupConfig, UnsupervisedTrainer,
                                                   unsup_gather_defaults)

    torch.backends.cuda.matmul.allow_tf32 = False
    store = bench_store()
    device = torch.device("cuda", 0)
    dist_cfg = TrainConfig.from_json("configs/ogbn_products_dist.json").replace(halo="exact")
    cfg = TrainConfig(batch_size=512, n_train_samples=(25, 10), n_val_samples=(25, 10),
                      output_dims=(128, 128), compute_dtype="bfloat16", lr_init=0.01, epochs=1)
    unsup = UnsupConfig(3, 10)
    out = {}

    def partitioned(cls, config, csr, *extra):
        tr, graph, fold_ids, fold_w = cls.from_store(store, config, *extra, device, csr=csr)
        state = tr.init_state()
        return _timed(torch, lambda: tr.train_step(state, graph, fold_ids, fold_w), steps)

    for path, args in (("partitioned", (PartitionedTrainer, dist_cfg, False)),
                       ("partitioned_csr", (PartitionedTrainer, dist_cfg, True)),
                       ("partitioned_nce", (PartitionedUnsupervisedTrainer,
                                            cfg.replace(halo="exact"), False, unsup))):
        if path in paths:
            out[path] = mesh.run_in_process(lambda a=args: partitioned(*a), "cuda")

    problem = NodeProblem(store)
    train_ids = np.random.default_rng(5).permutation(problem.folds["train"])
    batches = [torch.as_tensor(train_ids[i * 512:(i + 1) * 512], dtype=torch.int32,
                               device="cuda") for i in range(WARMUP + steps + PROFILED)]
    for path in ("csr", "csr_nce", "int8", "int8_nce"):
        if path not in paths:
            continue
        graph = problem.device_graph(train=True, dtype=torch.bfloat16, device="cuda",
                                     csr=path.startswith("csr"), quantize=path.startswith("int8"))
        if not path.endswith("nce"):
            model = build_model(cfg, problem.n_nodes, problem.n_classes, problem.feats_dim)
            trainer = Trainer(model, cfg, steps_per_epoch=len(train_ids) // 512)
        else:
            ncfg = unsup_gather_defaults(cfg)
            model = build_model(ncfg, problem.n_nodes, max(problem.n_classes, 2),
                                problem.feats_dim)
            trainer = UnsupervisedTrainer(model, ncfg, unsup,
                                          steps_per_epoch=len(train_ids) // 512)
        state, it = trainer.init_state(graph), iter(batches)

        def step(path=path, trainer=trainer, state=state, it=it, graph=graph):
            ids = next(it)
            if not path.endswith("nce"):
                return trainer.train_step(state, graph, ids, graph.targets[ids.long()])
            return trainer.train_step(state, graph, ids, None)

        out[path] = _timed(torch, step, steps)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", help="root of the other checkout")
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--paths", default=",".join(DEFAULT_PATHS),
                        help=f"comma-separated, of {', '.join(PATHS)}")
    parser.add_argument("--turn", help=argparse.SUPPRESS)  # run one turn from this root
    args = parser.parse_args(argv)
    paths = args.paths.split(",")
    unknown = sorted(set(paths) - set(PATHS))
    if unknown:
        parser.error(f"unknown paths {unknown}; choose from {list(PATHS)}")
    if args.turn:
        print(json.dumps(_turn(args.steps, paths)), flush=True)
        return 0
    if not args.other:
        parser.error("--other is required")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("step_ab needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    roots = {"other": os.path.abspath(args.other), "this": here}
    turns = []
    # each turn loads this file by path, with its checkout's root first on
    # sys.path, so the tpu_sage_torch it imports is that checkout's
    code = ("import importlib.util as u, sys; sys.path.insert(0, sys.argv[1]); "
            "s = u.spec_from_file_location('step_ab', sys.argv[2]); "
            "m = u.module_from_spec(s); s.loader.exec_module(m); "
            "sys.exit(m.main(['--turn', '1', '--steps', sys.argv[3], '--paths', sys.argv[4]]))")
    for _ in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            root = roots[side]
            r = subprocess.run([sys.executable, "-c", code, root, os.path.abspath(__file__),
                                str(args.steps), args.paths], cwd=root, capture_output=True,
                               text=True)
            if r.returncode != 0:
                raise SystemExit(f"the {side} turn failed:\n{r.stderr[-4000:]}")
            turns.append({"side": side, **json.loads(r.stdout.strip().splitlines()[-1])})
    print(smi)
    print(json.dumps({"step_ab": turns, "device": torch.cuda.get_device_name(0),
                      "paths": paths, "timing": "host clock over the timed steps, ending in "
                      "torch.cuda.synchronize(); launches and device ms from torch.profiler"}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
