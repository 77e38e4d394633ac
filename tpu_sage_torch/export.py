"""Embedding / logits export for serving (counterpart of ``tpu_sage/export.py``).

    python -m tpu_sage_torch.export --problem-path p.h5 --checkpoint model.npz \\
        --out embeddings.npy [--logits] [--checkpoint-config] [--device cpu]

Loads a trained checkpoint (written by either package: the layout is
shared), runs exact layer-wise inference over every node
(``tpu_sage_torch.nn.full_graph``, no sampling variance) and writes an
``.npy`` the serving stack can mmap. The model flags must match the training
run, or pass the same ``--config`` preset, or ``--checkpoint-config``. The
features go to the device as f32 whatever dtype the model trained in, as in
the JAX package. Runs on the CUDA card unless ``--device cpu``.

``--partitioned`` runs the exact pass node-sharded
(``nn/full_graph.py::embed_all_nodes_partitioned``) on every rank of a
process group, as ``cli.py --partitioned`` starts them (torchrun's ranks, or
one per visible card, or one CPU rank); the first rank writes the same
``.npy`` the single-device export writes.

Multi-host (the JAX package's ``init_multihost``): pass ``--coordinator
host:port --num-processes N --process-id r`` on each of the ``N`` hosts'
processes. Each process brings up its host's ranks, one per visible card
(one on ``--device cpu``), in one ``tcp://host:port`` group, global rank
``r·n_local + local`` (so the hosts are the rows of ``mesh.host_layout``);
with ``--partitioned`` the ranks run the sharded pass, and process 0's first
rank writes the output. ``--num-processes 1`` (or unset) is a single
process: the flags change nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _npz_embedding_rows(path):
    """Row count of the checkpoint's 2-D prep-embedding table, read from the
    ``.npy`` member headers of the npz zip, so a large transductive table is
    not decompressed just to compare ``shape[0]``. Header versions 1.0, 2.0
    and 3.0 (2.0's layout, the header in UTF-8) are read in place; falls back
    to ``np.load`` if the archive layout is unexpected; None when no table
    matches."""
    import ast
    import struct
    import zipfile

    from numpy.lib import format as npf

    try:
        with zipfile.ZipFile(path) as zf:
            for name in zf.namelist():
                key = name[:-4] if name.endswith(".npy") else name
                if "prep" in key and "embedding" in key:
                    with zf.open(name) as f:
                        version = npf.read_magic(f)
                        if version == (1, 0):
                            shape, _, _ = npf.read_array_header_1_0(f)
                        elif version == (2, 0):
                            shape, _, _ = npf.read_array_header_2_0(f)
                        elif version == (3, 0):
                            (length,) = struct.unpack("<I", f.read(4))
                            shape = ast.literal_eval(f.read(length).decode("utf8"))["shape"]
                        else:  # a future .npy format: use the np.load fallback
                            raise ValueError("unknown npy header version")
                    if len(shape) == 2:
                        return int(shape[0])
    except (zipfile.BadZipFile, ValueError, KeyError, SyntaxError):
        with np.load(path) as data:
            for k in data.files:
                if "prep" in k and "embedding" in k and data[k].ndim == 2:
                    return int(data[k].shape[0])
    return None


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--problem-path")
    src.add_argument("--synthetic", choices=["sbm", "reddit-shaped"])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoint-config", action="store_true",
                    help="take the model config from the checkpoint's own "
                         "__config__ metadata instead of CLI flags (the safe "
                         "spelling for inference on another graph)")
    ap.add_argument("--logits", action="store_true",
                    help="export classifier logits instead of embeddings")
    ap.add_argument("--partitioned", action="store_true",
                    help="node-sharded exact inference over torch.distributed (one "
                         "rank per visible card, or torchrun's; one on --device cpu)")
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--out-dtype", default="float32", choices=["float32", "float16"],
                    help="dtype of the exported .npy; float16 halves the "
                         "device-to-host copy (cast on the device) and the file")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    # multi-host bring-up: pass all three on every host's process
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0, the group's rendezvous (tcp://)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="processes (hosts) in the export; 1 or unset: single-process")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's index, 0 .. --num-processes - 1")
    # model flags (must match training) when no --config is given
    ap.add_argument("--aggregator-class", default="mean")
    ap.add_argument("--prep-class", default="identity")
    ap.add_argument("--n-train-samples", default="25,10")
    ap.add_argument("--n-val-samples", default="25,10")
    ap.add_argument("--output-dims", default="128,128")
    ap.add_argument("--synthetic-nodes", type=int, default=2708)
    ap.add_argument("--synthetic-classes", type=int, default=7)
    ap.add_argument("--synthetic-feat-dim", type=int, default=64)
    ap.add_argument("--seed", type=int, default=123)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    hosts = None
    if (args.num_processes or 1) > 1:
        if args.coordinator is None or args.process_id is None or \
                not 0 <= args.process_id < args.num_processes:
            print("error: --num-processes > 1 needs --coordinator host:port and a "
                  "--process-id in [0, --num-processes)", file=sys.stderr)
            return 2
        hosts = (args.coordinator, args.num_processes, args.process_id)
    from tpu_sage_torch.cli import cuda_missing

    if cuda_missing(args.device):
        return 2
    if args.partitioned or hosts:
        from tpu_sage_torch.cli import run_ranks

        return run_ranks(_rank_main, args.device, (list(sys.argv[1:] if argv is None else argv),),
                         hosts=hosts)
    return _export(args)


def _rank_main(argv) -> int:
    """One rank of a ``--partitioned`` export."""
    return _export(parse_args(argv))


def _export(args) -> int:
    import torch

    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.data.synthetic import synthetic_problem
    from tpu_sage_torch.nn.full_graph import embed_all_nodes
    from tpu_sage_torch.train.checkpoint import load_checkpoint, read_checkpoint_config
    from tpu_sage_torch.train.trainer import TrainConfig, Trainer, build_model

    if args.checkpoint_config:
        stored = read_checkpoint_config(args.checkpoint)
        if stored is None:
            raise SystemExit(
                f"--checkpoint-config: {args.checkpoint} carries no __config__ "
                "metadata; pass --config or the model flags instead")
        config = TrainConfig.from_dict(stored, origin=args.checkpoint)
    elif args.config:
        config = TrainConfig.from_json(args.config)
    else:
        ints = lambda s: tuple(int(x) for x in s.split(","))  # noqa: E731
        config = TrainConfig(
            aggregator_class=args.aggregator_class,
            prep_class=args.prep_class,
            n_train_samples=ints(args.n_train_samples),
            n_val_samples=ints(args.n_val_samples),
            output_dims=ints(args.output_dims),
            seed=args.seed,
        )

    if args.synthetic:
        problem = synthetic_problem(args.synthetic, args.synthetic_nodes, args.synthetic_classes,
                                    args.synthetic_feat_dim, seed=args.seed)
    else:
        problem = NodeProblem.from_h5(args.problem_path)

    if config.prep_class == "node_embedding":
        # transductive prep: the learned table is keyed by training-graph
        # node id, so it cannot serve another graph
        if not os.path.exists(args.checkpoint):
            raise SystemExit(f"error: checkpoint not found: {args.checkpoint!r}")
        emb_rows = _npz_embedding_rows(args.checkpoint)
        if emb_rows is not None and emb_rows != problem.n_nodes:
            raise SystemExit(
                f"prep_class=node_embedding is TRANSDUCTIVE: the checkpoint's "
                f"embedding table covers {emb_rows} training-graph nodes but "
                f"the target graph has {problem.n_nodes}. Cross-graph "
                f"inference needs a graph-size-independent prep — retrain "
                f"with --prep-class identity or linear."
            )

    model = build_model(config, problem.n_nodes, problem.n_classes, problem.feats_dim)
    trainer = Trainer(model, config, steps_per_epoch=1, task=problem.task)
    if args.partitioned:
        # only this rank's shard of the full graph goes to the device (f32
        # features); the shards' outputs are gathered in the output dtype
        from tpu_sage_torch.dist.halo import all_gather_rows
        from tpu_sage_torch.dist.mesh import rank
        from tpu_sage_torch.dist.partition import shard_graph
        from tpu_sage_torch.nn.full_graph import embed_all_nodes_partitioned

        device = (torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda"
                  else torch.device("cpu"))
        graph, _ = shard_graph(problem.store, train=False, device=device)
        state = load_checkpoint(args.checkpoint, trainer.init_state(graph))
        out = embed_all_nodes_partitioned(model, graph, chunk=args.chunk,
                                          with_head=args.logits)
        if args.out_dtype != "float32":
            out = out.to(getattr(torch, args.out_dtype))
        out = all_gather_rows(out)[:problem.n_nodes]
    else:
        graph = problem.device_graph(train=False, device=args.device)  # f32 features
        state = load_checkpoint(args.checkpoint, trainer.init_state(graph))
        out = embed_all_nodes(model, graph, chunk=args.chunk, with_head=args.logits)
        if args.out_dtype != "float32":
            out = out.to(getattr(torch, args.out_dtype))  # on the device, before the copy
    from tpu_sage_torch.dist.mesh import rank

    process = rank()
    if process != 0:
        return 0
    arr = out.cpu().numpy()
    np.save(args.out, arr)
    print(json.dumps({
        "out": args.out, "shape": list(arr.shape),
        "kind": "logits" if args.logits else "embeddings",
        "from_step": state.step, "process": process,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
