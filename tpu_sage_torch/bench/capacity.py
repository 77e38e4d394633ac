"""Single-card device-memory capacity model: the largest graph one CUDA card
trains or serves (counterpart of ``tpu_sage/bench/capacity.py``, recalibrated
for the port on the H100).

``resident_bytes`` models what a run holds on the card and ``max_nodes``
inverts it for the largest node count at a given width. The fixed terms are
the port's own device tensors, byte for byte (``graph/graph_data.py``):

- features: ``n·d`` f32/bf16, or int8 ``n·d`` plus ``d`` f32 scales
  (``data/quantize.py::QuantizedFeats``), one table shared by the train and
  full graphs;
- per graph (``n_graphs``: 2 on ``fit``'s path, the train-edge and the
  full-edge graphs): the adjacency, dense ``n·max_degree`` int32 or CSR
  ``(n + 1)`` int32 offsets and ``nnz`` int32 ids padded for the window hop
  (to a multiple of the window plus two windows, the window being the true
  max degree); ``n`` int32 degrees; ``n`` int32 targets.

The transient terms and the slack were measured on the card
(``measure()``, a fresh process, ``python -m tpu_sage_torch.bench.capacity
--measure``):

- training: the supervised step's peak above its resident bytes
  (``torch.cuda.max_memory_allocated``), at the main path's shapes, as a
  factor of the sampled tree's rows ``B·(1 + f1 + f1·f2)·d`` in the compute
  dtype (an int8 table computes in bf16);
- exact inference: two ``n × out_width`` f32 activation tables, the
  exact pass's chunk of 4,096 nodes (``nn/full_graph.py``) of ``max_degree``
  gathered rows each, as a measured factor, and, for an int8 table, the
  table dequantized whole to bf16;
- slack: what the card holds outside the model: the CUDA context and the
  loaded libraries (``torch.cuda.mem_get_info`` against the allocator's
  reserve), and inside the allocator the parameters, Adam's moments, the
  cuBLAS workspace and the allocator's rounding.

``--probe --frac F`` builds a zero-filled graph directly on the card at F of
the modeled ``max_nodes``, runs 3 training steps (or one exact pass) over
its last rows, checks the kernels against their plain versions on those
rows, and reports the measured peak beside the modeled bytes; past the
limit it ends in the out-of-memory advice and exit code 1::

    python -m tpu_sage_torch.bench.capacity                 # the envelope
    python -m tpu_sage_torch.bench.capacity --measure       # re-measure the constants
    python -m tpu_sage_torch.bench.capacity --probe --frac 0.9 [--int8] [--mode infer]
    python -m tpu_sage_torch.bench.capacity --probe --frac 1.15   # exit 1 with the advice
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Optional

# Measured by measure() in a fresh process on one NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit (nvidia-smi --query-gpu=name,power.limit), torch
# 2.11.0+cu128 (PERF.md). A card of another size keeps these and uses
# its own total_memory.
MEASURED_ON = "NVIDIA H100 80GB HBM3, 700.00 W"
HBM_BYTES = 85_017_493_504        # that card's total_memory (the default without a card)
RUNTIME_BYTES = 787_283_968       # CUDA context and loaded libraries, outside the allocator
ALLOCATOR_BYTES = 372_710_484     # parameters, Adam, cuBLAS workspace, allocator rounding
SLACK_BYTES = RUNTIME_BYTES + ALLOCATOR_BYTES
TRAIN_TRANSIENT_FACTOR = 0.36758209350474264  # step peak / (tree rows x d x compute bytes)
INFER_CHUNK_FACTOR = 0.8779402317794851  # exact-pass chunk / (chunk x max_degree x row bytes)
EXACT_CHUNK = 4096                # nn/full_graph.py::embed_all_nodes's chunk
INT32_LIMIT = 2**31 - 1           # CSR offsets are int32 (sample/csr.py::csr_from_padded)


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    feat_dim: int = 602
    max_degree: int = 128
    avg_degree: int = 128         # CSR nnz/n (= max_degree when rows are full)
    batch_size: int = 512
    fanouts: tuple = (25, 10)
    feature: str = "bfloat16"     # "float32" | "bfloat16" | "int8"
    adjacency: str = "dense"      # "dense" | "csr"
    mode: str = "train"           # "train" | "infer"
    out_width: int = 256          # exact inference activation width (concat)
    n_graphs: int = 1             # 2 = the fit() path (train + full eval graph)


FEAT_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def csr_indices_len(n_nodes: int, cfg: CapacityConfig) -> int:
    """CSR ids on the card: ``nnz`` padded to a multiple of the window (the
    true max degree) plus two windows (``sample/csr.py::pad_indices_for_window``)."""
    nnz, window = n_nodes * cfg.avg_degree, max(1, cfg.max_degree)
    return nnz + (-nnz) % window + 2 * window


def fixed_bytes(n_nodes: int, cfg: CapacityConfig) -> int:
    """The resident device tensors: one feature table, and per graph its
    adjacency, degrees and targets."""
    n = n_nodes
    feats = n * cfg.feat_dim * FEAT_BYTES[cfg.feature]
    if cfg.feature == "int8":
        feats += cfg.feat_dim * 4
    if cfg.adjacency == "dense":
        adj = n * cfg.max_degree * 4
    else:
        adj = (n + 1) * 4 + csr_indices_len(n, cfg) * 4
    return feats + cfg.n_graphs * (adj + n * 4 + n * 4)


def transient_bytes(n_nodes: int, cfg: CapacityConfig) -> int:
    """The step's (or exact pass's) working memory above the resident bytes."""
    compute = max(FEAT_BYTES[cfg.feature], 2)  # an int8 table's rows come back in bf16
    if cfg.mode == "infer":
        row = max(cfg.feat_dim * compute, cfg.out_width * 4)
        out = 2 * n_nodes * cfg.out_width * 4
        out += int(INFER_CHUNK_FACTOR * EXACT_CHUNK * cfg.max_degree * row)
        if cfg.feature == "int8":
            out += n_nodes * cfg.feat_dim * 2
        return out
    f1, f2 = cfg.fanouts
    tree_rows = cfg.batch_size * (1 + f1 + f1 * f2)
    return int(TRAIN_TRANSIENT_FACTOR * tree_rows * cfg.feat_dim * compute)


def resident_bytes(n_nodes: int, cfg: CapacityConfig) -> int:
    """Modeled peak device bytes of the run's tensors (the slack apart)."""
    return fixed_bytes(n_nodes, cfg) + transient_bytes(n_nodes, cfg)


def device_hbm_bytes() -> int:
    """The card's own memory when one is present, else ``HBM_BYTES``."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return HBM_BYTES


def max_nodes(cfg: CapacityConfig, hbm_bytes: Optional[int] = None) -> int:
    """Largest n_nodes whose modeled residency fits ``hbm_bytes`` (default:
    the card's) less the measured slack. Returns 0 when nothing fits. CSR is
    also held to its int32 offsets (``nnz`` and its padding below 2^31)."""
    hbm = device_hbm_bytes() if hbm_bytes is None else hbm_bytes
    budget = hbm - SLACK_BYTES

    def fits(n: int) -> bool:
        if cfg.adjacency == "csr" and csr_indices_len(n, cfg) > INT32_LIMIT:
            return False
        return resident_bytes(n, cfg) <= budget

    if budget <= 0 or not fits(1):
        return 0
    lo, hi = 1, 2
    while fits(hi):
        lo, hi = hi, hi * 2
    while lo < hi - 1:
        mid = (lo + hi) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid
    return lo


def capacity_table(hbm_bytes: Optional[int] = None):
    """The envelope: max nodes per (storage × feature × mode) at two
    representative feature widths (Reddit's 602, OGBN-products' 100).
    float32 is the CLI's default storage; bfloat16 (--compute-dtype) is the
    main path's."""
    rows = []
    for feat_dim, max_deg in ((602, 128), (100, 64)):
        for adjacency in ("dense", "csr"):
            for feature in ("float32", "bfloat16", "int8"):
                for mode in ("train", "infer"):
                    cfg = CapacityConfig(
                        feat_dim=feat_dim, max_degree=max_deg,
                        avg_degree=max_deg, feature=feature,
                        adjacency=adjacency, mode=mode,
                    )
                    rows.append({
                        "feat_dim": feat_dim, "max_degree": max_deg,
                        "adjacency": adjacency, "feature": feature,
                        "mode": mode, "max_nodes": max_nodes(cfg, hbm_bytes),
                    })
    return rows


def _run_config(feat_dim: int, max_degree: int, csr: bool, feature: str,
                n_graphs: int) -> CapacityConfig:
    return CapacityConfig(feat_dim=feat_dim, max_degree=max_degree,
                          avg_degree=max_degree, feature=feature,
                          adjacency="csr" if csr else "dense", n_graphs=n_graphs)


def over_budget(n_nodes: int, feat_dim: int, max_degree: int,
                csr: bool, feature: str, n_graphs: int = 2,
                hbm_bytes: Optional[int] = None) -> bool:
    """Does the modeled training residency exceed the card's memory less the
    measured slack? ``feature`` is the run's on-device storage ("float32" |
    "bfloat16" | "int8"); ``n_graphs=2`` is ``fit``'s path."""
    hbm = device_hbm_bytes() if hbm_bytes is None else hbm_bytes
    cfg = _run_config(feat_dim, max_degree, csr, feature, n_graphs)
    return resident_bytes(n_nodes, cfg) > hbm - SLACK_BYTES


def oom_advice(n_nodes: int, feat_dim: int, max_degree: int,
               csr: bool, feature: str, n_graphs: int = 2) -> str:
    """What to do about a ``torch.cuda.OutOfMemoryError`` during the upload
    or training (the CLI prints it): the modeled bytes and the port's flags
    that shrink them."""
    tips = []
    if feature == "float32":
        tips.append("--compute-dtype bfloat16 (halves the feature table)")
    if not csr:
        tips.append("--csr-adjacency (adjacency at nnz instead of "
                    "n*max_degree ids)")
    if feature != "int8":
        tips.append("--feature-int8 (features at 1 byte/element + per-column "
                    "scales; lossy)")
    tips.append("--partitioned over more cards (node-sharded storage)")
    est = resident_bytes(n_nodes, _run_config(feat_dim, max_degree, csr, feature, n_graphs))
    return (
        f"graph does not fit device memory: ~{est / 1e9:.1f} GB modeled for "
        f"{n_nodes} nodes x {feat_dim} feats (max_degree {max_degree}, "
        f"{'csr' if csr else 'dense'} adjacency, {feature} features, "
        f"{n_graphs} resident graph(s)) plus {SLACK_BYTES / 1e9:.1f} GB of runtime "
        f"slack. Options: " + "; ".join(tips)
        + ". See `python -m tpu_sage_torch.bench.capacity` for the envelope."
    )


def device_tensor_bytes(graph) -> int:
    """Bytes of a ``DeviceGraph``'s or ``CSRDeviceGraph``'s tensors (a
    ``QuantizedFeats`` table: its int8 rows and f32 scales)."""
    import torch

    total = 0
    for field in dataclasses.fields(graph):
        v = getattr(graph, field.name)
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif v is not None and hasattr(v, "nbytes"):
            total += v.nbytes
    return total


# -- on the card ---------------------------------------------------------------------

def _train_setup(graph, n_classes: int, batch_size: int, dtype: str):
    from tpu_sage_torch.train.trainer import TrainConfig, Trainer, build_model

    feat_dim = graph.feats.shape[1]
    cfg = TrainConfig(batch_size=batch_size, n_train_samples=(25, 10),
                      n_val_samples=(25, 10), output_dims=(128, 128),
                      compute_dtype=dtype, epochs=1)
    model = build_model(cfg, graph.degrees.shape[0], n_classes, feat_dim)
    trainer = Trainer(model, cfg, 1)
    return trainer, trainer.init_state(graph)


def measure(device: str = "cuda") -> dict:
    """The slack and transient constants, measured in this process (run it
    fresh: an earlier CUDA context's caches and libraries would count) at
    the main path's shapes on the 232,965 × 602 ``bench_store`` in bf16:
    warm training steps, then the steps' peak above their start; one exact
    pass with logits, its peak above its start less the two activation
    tables."""
    import torch

    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.data.synthetic import bench_store
    from tpu_sage_torch.nn.full_graph import embed_all_nodes

    store = bench_store()
    problem = NodeProblem(store)
    graph = problem.device_graph(train=True, dtype=torch.bfloat16, device=device)
    graph_bytes = device_tensor_bytes(graph)
    trainer, state = _train_setup(graph, problem.n_classes, 512, "bfloat16")
    train_ids = problem.folds["train"]
    batches = [torch.as_tensor(train_ids[i * 512:(i + 1) * 512], dtype=torch.int32,
                               device=device) for i in range(8)]
    for ids in batches[:3]:
        state, _ = trainer.train_step(state, graph, ids, graph.targets[ids.long()])
    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    runtime = total - free - torch.cuda.memory_reserved()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for ids in batches[3:]:
        state, _ = trainer.train_step(state, graph, ids, graph.targets[ids.long()])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    rounding = torch.cuda.max_memory_reserved() - peak
    cfg = CapacityConfig()
    f1, f2 = cfg.fanouts
    tree = cfg.batch_size * (1 + f1 + f1 * f2) * store.feat_dim * 2
    train_factor = (peak - base) / tree

    base_i = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    embed_all_nodes(state.model, graph, chunk=EXACT_CHUNK, with_head=True)
    torch.cuda.synchronize()
    peak_i = torch.cuda.max_memory_allocated()
    acts = 2 * store.n_nodes * cfg.out_width * 4
    chunk = EXACT_CHUNK * store.adj.shape[1] * max(store.feat_dim * 2, cfg.out_width * 4)
    infer_factor = (peak_i - base_i - acts) / chunk
    allocator = base - graph_bytes + max(rounding, torch.cuda.max_memory_reserved() - peak_i)
    return {
        "device": torch.cuda.get_device_name(0),
        "total_memory": torch.cuda.get_device_properties(0).total_memory,
        "runtime_bytes": runtime, "allocator_bytes": allocator,
        "slack_bytes": runtime + allocator,
        "train_transient_bytes": peak - base, "train_transient_factor": train_factor,
        "infer_transient_bytes": peak_i - base_i, "infer_chunk_factor": infer_factor,
        "in_model": {"runtime_bytes": RUNTIME_BYTES, "allocator_bytes": ALLOCATOR_BYTES,
                     "train_transient_factor": TRAIN_TRANSIENT_FACTOR,
                     "infer_chunk_factor": INFER_CHUNK_FACTOR, "measured_on": MEASURED_ON},
    }


def zero_graph(n_nodes: int, cfg: CapacityConfig, far_rows: int, device: str = "cuda"):
    """A zero-filled graph made directly on the card (no host copy): every
    node's neighbors are node 0 at full degree, but the last ``far_rows``
    nodes, whose features are random and whose neighbors are each other, so
    a batch of them samples, gathers and means the table's last rows."""
    import torch

    from tpu_sage_torch.data.quantize import QuantizedFeats
    from tpu_sage_torch.graph.graph_data import CSRDeviceGraph, DeviceGraph

    n, d, deg_max = n_nodes, cfg.feat_dim, cfg.max_degree
    gen = torch.Generator(device=device).manual_seed(0)
    lo = n - far_rows
    far_nbrs = lo + torch.randint(0, far_rows, (far_rows, deg_max), generator=gen,
                                  device=device, dtype=torch.int32)
    degrees = torch.full((n,), deg_max, dtype=torch.int32, device=device)
    targets = torch.zeros((n,), dtype=torch.int32, device=device)
    if cfg.feature == "int8":
        q = torch.zeros((n, d), dtype=torch.int8, device=device)
        q[lo:] = torch.randint(-127, 128, (far_rows, d), generator=gen, device=device,
                               dtype=torch.int8)
        feats = QuantizedFeats(q, torch.full((d,), 0.01, device=device),
                               out_dtype=torch.bfloat16)
    else:
        dtype = torch.float32 if cfg.feature == "float32" else torch.bfloat16
        feats = torch.zeros((n, d), dtype=dtype, device=device)
        feats[lo:] = torch.randn((far_rows, d), generator=gen, device=device).to(dtype)
    if cfg.adjacency == "dense":
        adj = torch.zeros((n, deg_max), dtype=torch.int32, device=device)
        adj[lo:] = far_nbrs
        return DeviceGraph(adj=adj, degrees=degrees, feats=feats, targets=targets)
    indptr = torch.arange(n + 1, dtype=torch.int32, device=device) * deg_max
    indices = torch.zeros((csr_indices_len(n, cfg),), dtype=torch.int32, device=device)
    indices[lo * deg_max:n * deg_max] = far_nbrs.view(-1)
    return CSRDeviceGraph(indptr=indptr, indices=indices, degrees=degrees, feats=feats,
                          targets=targets, window=deg_max)


def far_row_checks(graph, ids, fanout: int = 10) -> dict:
    """The kernels that index the table, on its last rows, against their plain
    versions on the same tensors: ``{kernel: bitwise equal}``."""
    import torch

    from tpu_sage_torch.kernels import gather, gather_mean, sample_hop

    gen = torch.Generator(device=ids.device).manual_seed(1)
    u = torch.rand((ids.shape[0], fanout), generator=gen, device=ids.device)
    if hasattr(graph, "indptr"):
        hop = ("sample_hop_csr", sample_hop.sample_hop_csr, sample_hop.sample_hop_csr_reference,
               (graph.indptr, graph.indices, graph.degrees, ids, u))
    else:
        hop = ("sample_hop", sample_hop.sample_hop, sample_hop.sample_hop_reference,
               (graph.adj, graph.degrees, ids, u))
    nbrs = hop[1](*hop[3]).view(-1)
    feats = graph.feats
    if hasattr(feats, "q"):
        table = feats.q
        mean = ("gather_fanout_mean_int8", gather_mean.gather_fanout_mean_int8,
                gather_mean.gather_fanout_mean_int8_reference,
                (feats.q, feats.scale, nbrs, fanout, torch.bfloat16))
    else:
        table = feats
        mean = ("gather_fanout_mean", gather_mean.gather_fanout_mean,
                gather_mean.gather_fanout_mean_reference, (feats, nbrs, fanout))
    cases = [hop, ("gather_rows", gather.gather_rows, gather.gather_rows_reference,
                   (table, nbrs)), mean]
    return {name: bool(torch.equal(fn(*args), ref(*args))) for name, fn, ref, args in cases}


def probe(frac: float, cfg: CapacityConfig, hbm_bytes: Optional[int] = None,
          log=print) -> int:
    """Build a zero graph at ``frac`` of ``max_nodes(cfg)`` on the card and
    train 3 steps (or serve one exact pass) over its last rows. Returns 0 when
    it ran and every far-row check held, 2 when a check failed, and 1, after
    printing the advice, when the card ran out of memory."""
    import torch

    limit = max_nodes(cfg, hbm_bytes)
    n = int(limit * frac)
    modeled = resident_bytes(n, cfg)
    log(json.dumps({"probe": dataclasses.asdict(cfg), "frac": frac,
                    "modeled_max_nodes": limit, "probe_nodes": n,
                    "modeled_bytes": modeled, "slack_bytes": SLACK_BYTES,
                    "feature_elements": n * cfg.feat_dim,
                    "hbm_bytes": device_hbm_bytes() if hbm_bytes is None else hbm_bytes}))
    b = cfg.batch_size
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        graph = zero_graph(n, cfg, far_rows=b)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        resident = device_tensor_bytes(graph)
        ids = torch.arange(n - b, n, dtype=torch.int32, device="cuda")
        trainer, state = _train_setup(graph, 4, b, "bfloat16")
        rec = {"built_on_card_s": built, "resident_bytes": resident,
               "fixed_bytes_modeled": fixed_bytes(n, cfg)}
        if cfg.mode == "infer":
            from tpu_sage_torch.nn.full_graph import embed_all_nodes

            t1 = time.perf_counter()
            out = embed_all_nodes(state.model, graph, chunk=EXACT_CHUNK, with_head=True)
            torch.cuda.synchronize()
            rec.update(exact_pass_s=time.perf_counter() - t1,
                       finite=bool(torch.isfinite(out[-b:]).all().item()))
            del out
        else:
            times, losses = [], []
            for _ in range(3):
                t1 = time.perf_counter()
                state, m = trainer.train_step(state, graph, ids, graph.targets[ids.long()])
                losses.append(m["loss"].item())
                times.append((time.perf_counter() - t1) * 1e3)
            rec.update(train_step_ms=times, finite=all(map(math.isfinite, losses)))
        far = far_row_checks(graph, ids)
        torch.cuda.synchronize()
        free, total = torch.cuda.mem_get_info()
        rec.update(far_rows_bitwise=far,
                   peak_allocated=torch.cuda.max_memory_allocated(),
                   peak_reserved=torch.cuda.max_memory_reserved(),
                   outside_allocator_bytes=total - free - torch.cuda.memory_reserved(),
                   modeled_bytes=modeled, modeled_with_slack=modeled + SLACK_BYTES,
                   device=torch.cuda.get_device_name(0))
        rec["within_model"] = rec["peak_allocated"] <= modeled + ALLOCATOR_BYTES
        log(json.dumps({"probe_result": rec}))
        return 0 if all(far.values()) and rec["finite"] else 2
    except torch.cuda.OutOfMemoryError:
        print("error: " + oom_advice(n, cfg.feat_dim, cfg.max_degree, cfg.adjacency == "csr",
                                     cfg.feature, cfg.n_graphs), file=sys.stderr)
        return 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="device memory in GiB (default: the card's own, else "
                         f"{HBM_BYTES / 1024**3:.2f}, the H100 80GB's); the measured "
                         "slack is kept")
    ap.add_argument("--measure", action="store_true",
                    help="measure the slack and transient constants on the card "
                         "(run in a fresh process)")
    ap.add_argument("--probe", action="store_true",
                    help="train (or serve) a zero graph at --frac of max_nodes on the card")
    ap.add_argument("--frac", type=float, default=0.9)
    ap.add_argument("--mode", choices=["train", "infer"], default="train")
    ap.add_argument("--feat-dim", type=int, default=602)
    ap.add_argument("--max-degree", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--csr", action="store_true")
    ap.add_argument("--int8", action="store_true")
    args = ap.parse_args(argv)
    hbm = None if args.hbm_gb is None else int(args.hbm_gb * 1024**3)
    if args.measure or args.probe:
        import torch

        if not torch.cuda.is_available():
            print("error: --measure and --probe need a CUDA card", file=sys.stderr)
            return 2
    if args.measure:
        print(json.dumps({"measured": measure()}))
        return 0
    if args.probe:
        cfg = CapacityConfig(feat_dim=args.feat_dim, max_degree=args.max_degree,
                             avg_degree=args.max_degree,
                             feature="int8" if args.int8 else "bfloat16",
                             adjacency="csr" if args.csr else "dense", mode=args.mode,
                             batch_size=args.batch_size)
        return probe(args.frac, cfg, hbm)
    hbm = device_hbm_bytes() if hbm is None else hbm
    try:
        header = {"hbm_bytes": hbm, "slack_bytes": SLACK_BYTES, "measured_on": MEASURED_ON}
        if hbm <= SLACK_BYTES:
            header["note"] = ("device memory at or below the measured slack: nothing "
                              "fits; every max_nodes row is 0")
        print(json.dumps(header))
        for row in capacity_table(hbm):
            print(json.dumps(row))
    except BrokenPipeError:  # `... | head` is a normal way to read this
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
