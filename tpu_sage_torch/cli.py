"""CLI entry point (counterpart of ``tpu_sage/cli.py``), with the same flag
names.

Usage::

    python -m tpu_sage_torch.cli --problem-path data/cora/problem.h5 \\
        --aggregator-class mean --n-train-samples 25,10 --epochs 10

    # no dataset files? generate a synthetic problem; --device cpu runs on
    # the CPU with the kernels' plain versions
    python -m tpu_sage_torch.cli --synthetic sbm --epochs 10 --device cpu

    # node-sharded training over torch.distributed: one rank per visible
    # card, or under torchrun the ranks it launches (gloo on --device cpu)
    python -m tpu_sage_torch.cli --config configs/ogbn_products_dist.json \\
        --synthetic sbm --partitioned
    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m tpu_sage_torch.cli --synthetic sbm --partitioned --device cpu

    # the hierarchical exchange over a (host, chip) layout: torchrun's
    # --nnodes hosts of --nproc_per_node ranks each
    python -m torch.distributed.run --nnodes 2 --nproc_per_node 2 ... \\
        -m tpu_sage_torch.cli --synthetic sbm --partitioned --halo hier2d

The run is on the CUDA card unless ``--device cpu`` is given; without a card
``--device cuda`` exits 2, and nothing falls back to the CPU.
``--unsupervised`` trains with the NCE objective
(``train/unsupervised.py::fit_unsupervised``, the logistic probe unless
``--no-eval``); ``--fuse-first-layer`` projects the feature table once per
step (``nn/fused.py``). ``--partitioned`` trains node-sharded
(``dist/train.py::fit_partitioned``) with the ``--halo*`` exchange settings:
under torchrun its environment gives the ranks; otherwise the run spawns one
rank per visible card (start method ``spawn``; a single rank runs in this
process), and on ``--device cpu`` runs one rank. ``--partitioned
--unsupervised`` trains the NCE objective node-sharded
(``dist/unsupervised.py::fit_unsupervised_partitioned``); ``--halo hier2d``
exchanges over the group's ``(host, chip)`` layout, one row per host.
``--reorder`` relabels the nodes before partitioning, for as many shards as
the run has ranks. ``--gather-form``, ``--gather-form-deep`` and
``--gather-chunks`` go into the config and change nothing on the port. The
reference's capacity advice on running out of device memory is not ported
(ROADMAP Queue 1 item 15): the error propagates.
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_args(argv=None):
    # allow_abbrev=False: --config override detection scans the raw argv for
    # exact flag spellings, so an abbreviation must not parse silently
    ap = argparse.ArgumentParser(description="tpu_sage_torch trainer", allow_abbrev=False)
    ap.add_argument("--config", default=None,
                    help="TrainConfig preset json (see configs/); explicit "
                         "flags override preset values")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--problem-path", help="path to problem.h5")
    src.add_argument("--synthetic", choices=["sbm", "reddit-shaped"],
                     help="generate a synthetic problem instead of loading one")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to train (default cuda; cpu runs the kernels' "
                         "plain PyTorch versions)")
    ap.add_argument("--aggregator-class", default="mean",
                    help="mean|max_pool|mean_pool|lstm|attention|gcn")
    ap.add_argument("--prep-class", default="identity",
                    help="identity|linear|node_embedding")
    ap.add_argument("--n-train-samples", default="25,10")
    ap.add_argument("--n-val-samples", default="25,10")
    ap.add_argument("--output-dims", default="128,128")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--lr-init", type=float, default=0.01)
    ap.add_argument("--lr-schedule", default="constant",
                    help="constant|linear|cyclical|sgdr")
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--no-normalize", action="store_true",
                    help="skip final L2 normalization")
    ap.add_argument("--combine", default="concat", choices=["concat", "add"])
    ap.add_argument("--checkpoint-path", default=None,
                    help="save params+opt state here at end (and resume if present)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="also checkpoint to --checkpoint-path every N epochs "
                         "mid-run (a crash loses at most N epochs)")
    ap.add_argument("--no-eval", action="store_true", help="skip per-epoch validation")
    ap.add_argument("--patience", type=int, default=None,
                    help="early stopping: stop after N epochs without "
                         "val-metric improvement (default off)")
    ap.add_argument("--save-best", action="store_true",
                    help="write --checkpoint-path only on val improvement "
                         "(the file always holds the best-so-far state)")
    ap.add_argument("--exact-val", action="store_true",
                    help="validate with exact full-graph layer-wise inference")
    ap.add_argument("--exact-val-every", type=int, default=None,
                    help="run the exact full-graph validation every K epochs "
                         "(sampled in between; final epoch and test always "
                         "exact). Implies --exact-val; default 1")
    ap.add_argument("--val-interval", type=int, default=None,
                    help="also validate every N train batches (reference-style)")
    ap.add_argument("--partitioned", action="store_true",
                    help="node-sharded training over torch.distributed: one rank "
                         "per visible card (or torchrun's ranks; one on --device cpu)")
    ap.add_argument("--halo", default=None,
                    choices=["auto", "measured", "exact", "ring", "pipelined",
                             "bucketed", "hier2d"],
                    help="halo-exchange implementation for --partitioned (default "
                         "auto = exact; 'measured' races exact/ring/pipelined at "
                         "startup, exact/hier2d on a (host, chip) layout; hier2d "
                         "reduces within each host before across hosts)")
    ap.add_argument("--halo-capacity-factor", type=float, default=None,
                    help="bucketed-halo capacity factor (default 2.0)")
    ap.add_argument("--halo-chunks", type=int, default=None,
                    help="recorded in the config; the port does not split the "
                         "exchange")
    ap.add_argument("--halo-measure-steps", type=int, default=None,
                    help="steps per timed racing epoch for --halo measured "
                         "(default 20 on the CPU, 100 on the card)")
    ap.add_argument("--fuse-first-layer", action="store_true",
                    help="mean/identity: project the feature table once per "
                         "step and gather in output space")
    ap.add_argument("--gather-form", default=None,
                    choices=["masked", "plain", "masked_chunked"],
                    help="TPU gather lowering; recorded in the config, no "
                         "effect on the port")
    ap.add_argument("--gather-form-deep", default=None, choices=["masked", "plain"],
                    help="recorded in the config, no effect on the port")
    ap.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16"],
                    help="matmul/feature-table dtype (default float32; "
                         "bfloat16 halves the resident feature table and "
                         "the gathered bytes)")
    ap.add_argument("--gather-chunks", type=int, default=None,
                    help="recorded in the config, no effect on the port")
    ap.add_argument("--fuse-last", default=None, choices=["auto", "off", "all"],
                    help="deepest-level fused gather+summary (default auto)")
    ap.add_argument("--csr-adjacency", action="store_true",
                    help="store the adjacency as CSR on the device (nnz ids "
                         "instead of n*max_degree); exact validation keeps "
                         "the full graph dense")
    ap.add_argument("--feature-int8", action="store_true",
                    help="store node features int8 with per-column scales "
                         "(halves the resident table and the gathered bytes)")
    ap.add_argument("--reorder", default=None, choices=["degree", "locality"],
                    help="node reordering before partitioning: 'degree' balances "
                         "edges across shards, 'locality' co-locates communities")
    ap.add_argument("--unsupervised", action="store_true",
                    help="skip-gram negative-sampling objective over random walks")
    ap.add_argument("--walk-length", type=int, default=3)
    ap.add_argument("--n-negatives", type=int, default=10)
    ap.add_argument("--probe-every", type=int, default=0,
                    help="unsupervised: logistic-probe val accuracy every K "
                         "epochs (0 = after the last epoch only)")
    ap.add_argument("--debug-nans", action="store_true",
                    help="torch.autograd.set_detect_anomaly(True)")
    ap.add_argument("--log-path", default=None,
                    help="also append metric records to this JSONL file")
    ap.add_argument("--synthetic-nodes", type=int, default=2708)
    ap.add_argument("--synthetic-classes", type=int, default=7)
    ap.add_argument("--synthetic-feat-dim", type=int, default=64)
    ap.add_argument("--synthetic-task", default="classification")
    return ap.parse_args(argv)


def _parse_ints(s: str):
    return tuple(int(x) for x in s.split(",") if x.strip())


def cuda_missing(device: str) -> bool:
    """True, after printing why, when ``device`` is cuda and there is no card."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda needs a CUDA card (torch.cuda.is_available() is "
              "false); pass --device cpu to run on the CPU", file=sys.stderr)
        return True
    return False


def main(argv=None):
    raw_argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)

    fanouts = _parse_ints(args.n_train_samples)
    val_fanouts = _parse_ints(args.n_val_samples)
    output_dims = _parse_ints(args.output_dims)
    if not (len(fanouts) == len(val_fanouts) == len(output_dims)):
        print(
            f"error: --n-train-samples/--n-val-samples/--output-dims must have "
            f"matching lengths (got {len(fanouts)}/{len(val_fanouts)}/{len(output_dims)})",
            file=sys.stderr,
        )
        return 2
    # late imports keep --help fast
    import torch

    from tpu_sage_torch.nn.aggregators import aggregator_lookup
    from tpu_sage_torch.nn.preps import prep_lookup
    from tpu_sage_torch.train.lr import LRSchedule

    for name, known in (("--aggregator-class", aggregator_lookup),
                        ("--prep-class", prep_lookup)):
        val = getattr(args, name.strip("-").replace("-", "_"))
        if val not in known:
            print(f"error: {name} {val!r} unknown; choose from {sorted(known)}",
                  file=sys.stderr)
            return 2
    if args.lr_schedule not in LRSchedule.lookup:
        print(
            f"error: --lr-schedule {args.lr_schedule!r} unknown; "
            f"choose from {sorted(LRSchedule.lookup)}",
            file=sys.stderr,
        )
        return 2
    if cuda_missing(args.device):
        return 2
    if args.checkpoint_every > 0 and not args.checkpoint_path:
        print("error: --checkpoint-every requires --checkpoint-path", file=sys.stderr)
        return 2
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if args.partitioned:
        return run_ranks(_rank_main, args.device, (raw_argv,))
    return _run(args, raw_argv)


def run_ranks(fn, device: str, args: tuple, hosts=None) -> int:
    """Run ``fn(*args)`` on every rank of a process group: torchrun's (this
    process is one of them), else one rank per visible card spawned from
    here (a single rank runs in this process), or one CPU rank. ``hosts``
    ``(coordinator, n_processes, process_id)``: this host's ranks of a
    multi-host ``tcp://coordinator`` group, global rank ``process_id ·
    n_local + local``."""
    import torch

    from tpu_sage_torch.dist import mesh

    if mesh.launched_by_torchrun():
        mesh.init_process_group(device)
        try:
            return fn(*args)
        finally:
            mesh.destroy_process_group()
    n = torch.cuda.device_count() if device == "cuda" else 1
    if hosts is not None:
        coordinator, n_proc, pid = hosts
        method = f"tcp://{coordinator}"
        if n == 1:
            return mesh.run_in_process(fn, device, args, rank=pid, world_size=n_proc,
                                       init_method=method)
        mesh.spawn(fn, n_proc * n, device, args, init_method=method, n_local=n,
                   rank_base=pid * n)
        return 0
    if n == 1:
        return mesh.run_in_process(fn, device, args)
    mesh.spawn(fn, n, device, args)
    return 0


def _rank_main(raw_argv) -> int:
    """One rank of a ``--partitioned`` run, from the raw argv."""
    return _run(parse_args(raw_argv), raw_argv)


def _reorder(args, problem):
    """``--reorder``: relabel the nodes for as many shards as the run has
    ranks (one on a single device) and log the cross-shard edge fraction
    before and after."""
    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.dist.mesh import world
    from tpu_sage_torch.dist.partition import (degree_balanced_permutation,
                                               edge_cut_fraction, locality_permutation,
                                               reorder_store)

    st = problem.store
    n_shards = world()
    if args.reorder == "degree":
        perm = degree_balanced_permutation(st.degrees, n_shards)
    else:
        perm = locality_permutation(st.adj, st.degrees)
    st2 = reorder_store(st, perm)
    _say({"reorder": args.reorder,
          "edge_cut_before": round(edge_cut_fraction(st, n_shards), 4),
          "edge_cut_after": round(edge_cut_fraction(st2, n_shards), 4)})
    return NodeProblem(st2)


def _say(rec) -> None:
    """Print a JSON line, on the first rank only."""
    from tpu_sage_torch.dist.mesh import rank

    if rank() == 0:
        print(json.dumps(rec), flush=True)


def _run(args, raw_argv) -> int:
    """Build the problem and the config, then train (on every rank of a
    partitioned run)."""
    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.data.synthetic import synthetic_problem
    from tpu_sage_torch.dist.mesh import rank
    from tpu_sage_torch.train.trainer import TrainConfig

    fanouts = _parse_ints(args.n_train_samples)
    val_fanouts = _parse_ints(args.n_val_samples)
    output_dims = _parse_ints(args.output_dims)
    if args.synthetic:
        problem = synthetic_problem(args.synthetic, args.synthetic_nodes,
                                    args.synthetic_classes, args.synthetic_feat_dim,
                                    seed=args.seed, task=args.synthetic_task)
    else:
        problem = NodeProblem.from_h5(args.problem_path)
    if args.reorder:
        problem = _reorder(args, problem)

    flag_values = {
        "aggregator_class": args.aggregator_class,
        "prep_class": args.prep_class,
        "n_train_samples": fanouts,
        "n_val_samples": val_fanouts,
        "output_dims": output_dims,
        "batch_size": args.batch_size,
        "epochs": args.epochs,
        "lr_init": args.lr_init,
        "lr_schedule": args.lr_schedule,
        "weight_decay": args.weight_decay,
        "optimizer": args.optimizer,
        "seed": args.seed,
        "combine": args.combine,
        "normalize": not args.no_normalize,
    }
    # flags without a preset-overriding default: they apply whenever given
    given = {k: v for k, v in (("gather_form", args.gather_form),
                               ("gather_form_deep", args.gather_form_deep),
                               ("compute_dtype", args.compute_dtype),
                               ("gather_chunks", args.gather_chunks),
                               ("fuse_last", args.fuse_last),
                               ("exact_val_every", args.exact_val_every),
                               ("patience", args.patience),
                               ("halo", args.halo),
                               ("halo_capacity_factor", args.halo_capacity_factor),
                               ("halo_chunks", args.halo_chunks),
                               ("halo_measure_steps", args.halo_measure_steps))
             if v is not None}
    if args.exact_val or args.exact_val_every is not None:
        given["exact_val"] = True
    if args.save_best:
        given["save_best"] = True
    if args.feature_int8:
        given["feature_int8"] = True
    if args.fuse_first_layer:
        given["fuse_first_layer"] = True
    if args.config:
        # the preset is the base; flags PRESENT ON THE COMMAND LINE override
        # it (read from the raw argv, so a flag given at its default value
        # still counts as explicit)
        explicit = {a.split("=", 1)[0].lstrip("-").replace("-", "_")
                    for a in raw_argv if a.startswith("--")}
        override_keys = {
            "aggregator_class", "prep_class", "batch_size", "epochs", "lr_init",
            "lr_schedule", "weight_decay", "optimizer", "seed", "combine",
            "n_train_samples", "n_val_samples", "output_dims",
        }
        overrides = {k: flag_values[k] for k in override_keys & explicit}
        if args.no_normalize:
            overrides["normalize"] = False
        config = TrainConfig.from_json(args.config).replace(**overrides, **given)
    else:
        config = TrainConfig(**flag_values, **given)
    _say({
        "task": problem.task, "n_nodes": problem.n_nodes,
        "feat_dim": problem.feats_dim, "n_classes": problem.n_classes,
        "config": {k: (list(v) if isinstance(v, tuple) else v)
                   for k, v in config.__dict__.items()},
    })
    if not args.log_path or rank() != 0:
        return _run_fit(args, problem, config, None)
    with open(args.log_path, "a") as logf:
        def log(rec):
            print(json.dumps(rec), flush=True)
            logf.write(json.dumps(rec) + "\n")
            logf.flush()

        return _run_fit(args, problem, config, log)


def _run_fit(args, problem, config, log):
    """Training, supervised or (``--unsupervised``) with the NCE objective,
    on one device or (``--partitioned``) node-sharded on every rank, then
    the final checkpoint, written by the first rank (or, under --save-best,
    the final state in the ``.last`` sibling when --checkpoint-every is set:
    the best state is already in the path)."""
    from tpu_sage_torch.dist.mesh import rank
    from tpu_sage_torch.train.checkpoint import save_checkpoint

    if args.partitioned and args.unsupervised:
        from tpu_sage_torch.dist.unsupervised import fit_unsupervised_partitioned
        from tpu_sage_torch.train.unsupervised import UnsupConfig

        _, state, _ = fit_unsupervised_partitioned(
            problem.store, config,
            UnsupConfig(walk_length=args.walk_length, n_negatives=args.n_negatives,
                        probe_every=args.probe_every),
            log=log, resume_from=args.checkpoint_path, checkpoint_every=args.checkpoint_every,
            probe=not args.no_eval, csr=args.csr_adjacency, device=None)
    elif args.partitioned:
        from tpu_sage_torch.dist.train import fit_partitioned

        _, state, _ = fit_partitioned(
            problem.store, config, log=log, eval_every_epoch=not args.no_eval,
            resume_from=args.checkpoint_path, checkpoint_every=args.checkpoint_every,
            csr=args.csr_adjacency, device=None)
    elif args.unsupervised:
        from tpu_sage_torch.train.unsupervised import UnsupConfig, fit_unsupervised

        _, state, _ = fit_unsupervised(
            problem, config,
            UnsupConfig(walk_length=args.walk_length, n_negatives=args.n_negatives,
                        probe_every=args.probe_every),
            log=log,
            resume_from=args.checkpoint_path,
            checkpoint_every=args.checkpoint_every,
            probe=not args.no_eval,  # the paper's logistic probe on the embeddings
            csr=args.csr_adjacency,
            device=args.device,
        )
    else:
        from tpu_sage_torch.train.trainer import fit

        _, state, _ = fit(
            problem, config, eval_every_epoch=not args.no_eval,
            resume_from=args.checkpoint_path, log=log,
            val_interval_batches=args.val_interval,
            checkpoint_every=args.checkpoint_every,
            device=args.device,
            csr=args.csr_adjacency,
        )
    if args.checkpoint_path and rank() == 0:
        path = None
        if not args.save_best:
            path = args.checkpoint_path
        elif args.checkpoint_every > 0:
            path = args.checkpoint_path + ".last"
        if path:
            save_checkpoint(path, state, config=config)
            print(json.dumps({"checkpoint": path}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
