#!/usr/bin/env python3
"""Smoke run of the tpu_sage_torch port on one CUDA card.

Run from the root of the checkout with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the CUDA sources of the eleven kernels from
   ``tpu_sage_torch/kernels/csrc`` with ``nvcc`` for ``sm_90a`` (one process
   per source, in parallel);
3. kernels: holds every kernel against its plain PyTorch version at the
   shapes its path gives it (both fused sampler hops, the feature gathers,
   deepest fanout mean, both layers' mean + projection and one at an x
   offset by 4 bytes, forward and backward; the packed sampler's gathers and
   its picks, ``select_hop`` beside the bare ``select_columns``; the degree
   and adjacency gathers the hops used to launch), and
   the ``gather_rows_blockspec`` foil at the six gather shapes, and times
   kernel, plain version and one PyTorch library call with CUDA events,
   L2-cold (``tpu_sage_torch.bench.timing``), and ``gather_rows`` at exact
   inference's three shapes (one 4,096-node chunk's 524,288 neighbor ids
   from f32 602-wide, f32 256-wide and bf16 602-wide tables), and both
   redesigned kernels where they once lost to their library call
   (``mean_project`` at 6,144 roots, on the preps' f32 rows at 512 and
   12,800 roots, at O = 64 and with an f32 W at the main path's layers and
   the f32 NCE step's 6,144 roots; ``gather_rows`` on int8
   602-byte rows, PPI-shaped 200-byte f32 rows and 1,024-byte f32 rows);
   then edge cases (every realignment shift of ``gather_rows``, 2- and
   4-byte, out-of-range ids, degree 0; the persistent ``mean_project``'s
   ragged last tile, x 4 and 8 bytes off alignment and W ring; ``select_hop``
   at degree 0 with and without ids, columns out of range, the pair view's
   shift, strided and offset rows and ragged B; the f32-W
   ``mean_project`` at ragged B, odd D, O = 41 and 100, x and W off
   alignment, F = 40, and its mean bitwise; the owner-masked fanout mean
   bitwise at roots with no owned id, owned -0.0 rows, ids at both ends of
   the owned range and tables at every offset) and the
   packed sampler (``sample_tree_packed``) at full width, bitwise against
   ``sample_tree`` with the same uniforms and with its own launch counts;
4. reference: one full-width forward (232,965 × 602 Reddit-shaped store,
   bf16, injected levels, the same flax-layout params) on the card against
   the same forward on the CPU with the plain versions, and three f32 train
   steps on a small store, card against CPU;
5. main path: ``Trainer`` on the full-width store, batch 512, fanouts
   (25, 10), dims (128, 128), bf16, mean/identity, lr 0.01 — warm-up, then
   with every launch counter at 0, 30 ``train_step``s and a short sampled
   eval; each kernel must launch its per-step count (the foil 0, in the
   eval too); prints ms/step and
   edges/s (edges/step = B·(f1 + f1·f2) = 140,800), then profiles 5 more
   steps with torch.profiler: device kernel time by name, the device busy
   share against the unprofiled ms/step, and kernel launches per step; then
   the same configuration in f32 (``TrainConfig``'s default
   ``compute_dtype``, the f32-W ``mean_project`` twice a step) for 30 steps
   with its launch counts held per step, ms/step, device ms/step and busy
   share (the ``f32_main_path`` line);
6. serving path: exact full-graph inference (``nn/full_graph.py``) on the
   card against the CPU on a 20,000-node full-width store and an SBM store
   with degree-0 nodes (f32 and bf16 tables, embeddings and logits); then,
   through the entry points, ``tpu_sage_torch.cli.main`` trains the
   232,965-node Reddit-shaped store with ``configs/reddit_mean.json`` for 2
   epochs (``--save-best --checkpoint-every 1 --exact-val --val-interval
   100``) and resumed to 3, which must start at epoch 2, and
   ``tpu_sage_torch.export.main`` writes f16 logits from the best file
   (232,965 × 41, finite, scoring the val fold as the best file's metric);
   each with the launch counters from 0: training launches every main-path
   kernel, the export ``gather_rows`` 2 × 57 times and nothing else; prints
   the ms per exact pass on the f32 and bf16 tables, nodes/s, the gathers'
   bound and a profile of one pass, after the card's name and power limit;
7. the other aggregators and preps: ``gather_rows`` and ``sample_hop``
   bitwise and timed at their new shapes (the deepest level gathered whole;
   Pubmed- and PPI-shaped trees' levels from f32 and bf16 tables, rows of
   2,000 / 1,000 / 200 / 100 bytes; exact inference's 128- and 512-wide f32
   rows; ``mean_project`` on the linear and node-embedding preps' f32 rows
   under a bf16 W); sampled bf16 logits card vs CPU for each new aggregator
   and prep; exact logits card vs CPU for gcn, the pools and attention on a
   20,000-node full-width store with degrees 0-128; then, with the launch
   counters from 0, training runs whose launches per step must be exact
   (gcn, max_pool, mean_pool and attention at phase 5's configuration,
   ``agg_hidden_dim`` 512, and gcn again on a Reddit-shaped SBM store, where
   it learns; ``configs/pubmed_maxpool.json`` and
   ``configs/ppi_lstm.json`` unchanged on SBM stand-ins of Pubmed and PPI;
   the linear and node-embedding preps), each with its loss finite and
   falling, a sampled val metric, ms/step, edges/s and busy share; and each
   new aggregator's exact pass on the f32 and bf16 tables (median of 3,
   nodes/s, busy share, kernel time by name);
8. storage: int8 features and CSR adjacency. The int8 fanout mean
   (``gather_fanout_mean_int8``, both modes, bf16 and f32 out, at 12,800
   roots × F = 10 × 602, each with its no-reuse floor; at its edges:
   fanouts 1-300 across the packed sums' chunk, widths 601, 603, 16 and 608,
   table bases 1-15 bytes off 16-byte alignment with their last rows, ids
   out of range, bytes at -128 and 127, extreme scales) and the CSR hop
   (``sample_hop_csr``, both hops on
   ``bench_store``'s CSR and on a Reddit-shaped SBM store's) bitwise against
   their plain versions and timed, and the same trees in one ``csr_tree``
   launch, bitwise the hops and timed; the reference's window-pair composition
   (``gather_rows`` and ``select_columns``) bitwise the fused CSR hop;
   fanouts above 32, degree-0 and tail rows, ids out of range; ``csr_tree``
   at its edges (degree 0, ids out of range, indices with and without window
   padding, ragged B, trees of 1-5 hops, walks of 1-4 and 6 hops); CSR trees
   bitwise the dense tree at full width for one generator state; the main
   path's configuration for 20 steps with ``feature_int8``, CSR and both,
   launches per step exact; the int8 model's sampled logits card against
   CPU; ``assortative_bench_store()`` trained by ``fit`` with exact
   validation in bf16 and in int8 (val metrics, resident table bytes;
   dense against CSR adjacency bytes on the SBM store); the CLI with
   ``--feature-int8 --csr-adjacency`` for one epoch at 232,965 nodes;
9. unsupervised training and the fused first layer: the kernels at the
   NCE tree's shapes (512 · (2 + 10) = 6,144 roots: the walk hop 512 × 1,
   dense and CSR; the CSR walk and the CSR NCE tree in one ``csr_tree``
   launch each; the tree's hops 6,144 × 25 and 153,600 × 10; its levels'
   gathers; the deepest fanout mean over 153,600 roots × 10 × 602, of the
   bf16 table and of the int8 one;
   ``mean_project`` at (6,144, 25, 602) and (6,144, 25, 256); the corpus
   rows) and at the fused first layer's (the projected 232,965 × 128 table's
   gathers and fanout means, the backward's 128,000 raw rows), against
   their plain versions and timed; one NCE loss and its gradients and one
   fused forward and its gradients (f32, bf16) card against CPU; the NCE
   step of ``scripts/bench_unsup.py`` (batch 512, walk length 3, 10
   negatives, 1,689,600 sampled edges per step) for UNSUP_STEPS steps with
   exact launches per step and a profile, then a few steps each with
   degree-smoothed negatives, CSR adjacency, a walk corpus and the int8
   table (``gather_fanout_mean_int8`` in place of ``gather_fanout_mean``);
   phase 5's
   configuration with ``fuse_first_layer`` beside phase 5's ms/step, with
   the whole-table product timed alone; ``fit_unsupervised`` on
   ``assortative_bench_store()`` with the probe (reported beside the
   feature-only probe and chance, not gated); the CLI with
   ``--unsupervised`` and a checkpoint, the export of its f16 embeddings,
   and the CLI with ``--fuse-first-layer``;
10. partitioned training over torch.distributed at the width of
   ``configs/ogbn_products_dist.json`` (mean, identity, (25, 10), (128,
   128), batch 1024, bf16) on ``bench_store()``: (a) the owner-side kernels
   at 4 owners' shapes (the owner-masked fanout mean over the deepest
   level's 256,000 ids for each owner, bf16 and int8, bitwise against its
   plain version, the partials' sum against one fanout mean; an owner's
   ``gather_rows(oob="zero")`` answers to 4·q ids; ``select_hop`` and the
   bare ``select_columns`` on the exchanged rows, ``select_hop`` on the CSR
   pair view's rows and at the owner) and the world-1 launch, timed; (c) at world 1 (an NCCL
   group of one rank in this process) one partitioned step's loss and
   gradients against the single-device step on the same levels; (b) one
   spawned NCCL rank per visible card runs DIST_STEPS steps each of the
   exact, ring, pipelined and bucketed exchanges and of CSR and int8
   shards, launches per step exact, with a profile, then the sampled and
   exact evaluations (the exact pass against the single-device one) and the
   replicas' fingerprints; (d) ``tpu_sage_torch.cli.main --partitioned``
   with the preset for 1 epoch with a checkpoint, resumed to 2, and
   ``tpu_sage_torch.export.main --partitioned`` against the single-device
   export;
11. the rest of the multi-GPU path on ``bench_store()``: (a) the kernels at
   its new shapes (the owner-masked fanout mean over the partitioned NCE
   step's 1,536,000 deepest ids at world 1 and as owner 1 of a (2, 2)
   layout; an owner's ``gather_rows(oob="zero")`` answers to a (2, 2)
   layout's ``(C, H, q)`` NCE level-1 ids; ``select_hop`` at the
   partitioned NCE step's walk hop and tree hops; ``mean_project`` on the two
   column slices of a model axis of 2, whose concatenation equals the whole
   product), timed; (b) at world 1 in this process: a partitioned NCE step
   against the single-device NCE step, a hier2d step at (1, 1) bitwise
   exact's, a tensor-parallel step at (1, 1) against the single-device step;
   (c) one spawned NCCL rank per visible card: NCE_STEPS partitioned NCE
   steps at ``scripts/bench_unsup_partitioned.py``'s configuration under
   exact, measured, hier2d, int8 shards, CSR shards and degree-smoothed
   negatives, launches per step exact, with a profile; ``embed_fold`` and
   the replicas' fingerprints; (d) hier2d supervised training at
   configs/ogbn_products_dist.json's width over (1, n) (or (2, n/2) from 4
   cards) and its exact evaluation against the single-device pass; (e)
   tensor-parallel steps at the main path's width over (n/m, m), m = 1 on
   one card (m = 2 with an even card count, on a 40-class Reddit-shaped SBM
   store); (f) the CLI's ``--partitioned --unsupervised`` (1 epoch with a
   checkpoint, resumed to 2) and ``--partitioned --halo hier2d``, the
   exporter's ``--partitioned`` embeddings of that checkpoint against the
   single-device export and ``--coordinator ... --num-processes 1`` bitwise
   it; (g) ``python3 -m tpu_sage_torch.bench.scaling`` up to the visible
   cards;
12. the auxiliary modules: (a) ``kernels.probe()`` (each kernel once in a
   subprocess against its plain version) returns True; (b) ``bench_store()``'s
   adjacency as an edge list (29.8 M edges, so the port's native C++ code
   runs) through ``data/convert.py``'s ``from_edgelist`` and
   ``save_problem_h5``, read back by ``NodeProblem.from_h5`` bitwise, then
   phase 5's configuration for TRAIN_STEPS steps on it with phase 5's
   launches per step, the loss finite and falling; (c)
   ``bench/profile.py::profile_steps`` at phase 5's configuration with a
   ``torch.profiler`` trace, its launches exact and its trace naming the
   main path's device kernels, beside phase 5's ms/step; (d) the
   plain-PyTorch step of ``bench/torch_baseline.py`` on the card, beside
   phase 5's edges/s; (e) ``bench/capacity.py`` in fresh processes: the
   measured slack and transient constants, the 0.9 probes (dense bf16 and
   int8 training, the bf16 exact pass) within their modeled bytes, with
   the kernels bitwise their plain versions on the last rows of tables
   above 2^31 elements, the 1.15 probe ending in the advice with exit code
   1, and the envelope;
13. prints each phase's wall time and the kernels line (the off-path cases
   among each kernel's cases, launches by path), then ``{"ok": true,
   "device": ...}`` last.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

BATCH, FANOUTS, DIMS = 512, (25, 10), (128, 128)
TRAIN_STEPS, WARMUP_STEPS, PROFILE_STEPS = 30, 3, 5
MEAN_PROJECT_TOL = (2.0 ** -7, 1e-4)  # rtol (one bf16 ulp), atol as a share of the output's scale
EVAL_NODES = 4096
SHIFT_ROWS = 4096  # rows of the small tables that check every realignment shift
EXACT_CHUNK = 4096  # exact inference's node chunk (the exporter's default)
SERVING_NODES = 232_965  # the serving path's Reddit-shaped store
CHECK_NODES = 20_000  # phase 6's card-against-CPU store, at full width and degree
EXACT_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}  # x max|out|, as tests/test_torch_full_graph.py
PASS_REPS = 3
# phase 7: the other aggregators and preps
NEW_AGGREGATORS = ("gcn", "max_pool", "mean_pool", "attention")
AGG_HIDDEN = 512  # agg_hidden_dim: the pools' MLP width, attention's key width
EMBEDDING_DIM = 64  # TrainConfig's embedding_dim: the linear prep's width, the embedding's
AGG_STEPS, PRESET_STEPS, PREP_STEPS = 20, 30, 5
# gcn trains on bench_store and on a Reddit-shaped SBM store: on
# bench_store's uniform random neighbors the root's own row reaches gcn's
# 2-layer embedding at 1/26^2 weight (gcn has no self branch) and its loss
# stays near ln 41, in the JAX package as in the port (tests/test_torch_train.py,
# test_gcn_stays_at_chance_on_bench_store_in_both_packages); on the SBM
# store, whose neighbors mostly share the root's class, it learns
REDDIT_SBM = dict(n_nodes=232_965, feat_dim=602, n_classes=41, avg_degree=12, max_degree=128,
                  seed=3)
# SBM stand-ins of the published graphs (Planetoid's Pubmed; GraphSAGE's PPI),
# at their node, feature and label counts; avg_degree draws that many edges
# per node, symmetrised: about 4.5 and 28.8 neighbors per node
PUBMED = dict(n_nodes=19_717, feat_dim=500, n_classes=3, avg_degree=2, max_degree=32, seed=5)
PPI = dict(n_nodes=56_944, feat_dim=50, n_classes=121, avg_degree=14, max_degree=64,
           task="multilabel_classification", seed=6)
SAMPLED_ROOTS = 32
SAMPLED_TOL = 3e-2  # x max|logit|, phase 4's bf16 limit
# phase 8: int8 feature storage and CSR adjacency
STORAGE_STEPS, QUALITY_EPOCHS = 20, 3
# phase 9: unsupervised training and the fused first layer; the walk and the
# negatives of scripts/bench_unsup.py:20-24
WALK_LENGTH, N_NEGATIVES, CORPUS_WALKS = 3, 10, 4
UNSUP_STEPS, UNSUP_VARIANT_STEPS, FUSED_STEPS = 20, 5, 20
# the JAX package's record on assortative_bench_store (RESULTS.md:498-500),
# accuracies only: a logistic probe on the raw features, and chance
FEATURE_ONLY_PROBE, CHANCE = 0.12, 0.024

# phase 10: partitioned training at configs/ogbn_products_dist.json's width
# (mean, identity, (25, 10), (128, 128), batch 1024, bf16, halo measured) on
# bench_store; the kernels at the shapes of 4 owners
DIST_CONFIG = "configs/ogbn_products_dist.json"
DIST_BATCH, DIST_OWNERS = 1024, 4
DIST_STEPS, DIST_WARMUP, DIST_PROFILE = 20, 3, 5
DIST_MODES = (("exact", {"halo": "exact"}, False), ("ring", {"halo": "ring"}, False),
              ("pipelined", {"halo": "pipelined"}, False),
              ("bucketed", {"halo": "bucketed"}, False), ("csr", {"halo": "exact"}, True),
              ("int8", {"halo": "exact", "feature_int8": True}, False))
OWNED_TOL = 1e-5  # x max|mean|: 4 owners' partial means summed against one fanout mean

# phase 11: the rest of the multi-GPU path. Partitioned NCE at
# scripts/bench_unsup_partitioned.py:23-28's configuration (mean, identity,
# batch 512, (25, 10), (128, 128), bf16, walk length 3, 10 negatives) on
# bench_store: (label, config, UnsupConfig, CSR shards)
NCE_MODES = (("exact", {"halo": "exact"}, {}, False),
             ("measured", {"halo": "measured"}, {}, False),
             ("hier2d", {"halo": "hier2d"}, {}, False),
             ("int8", {"halo": "exact", "feature_int8": True}, {}, False),
             ("csr", {"halo": "exact"}, {}, True),
             ("smoothed", {"halo": "exact"}, {"neg_power": 0.75}, False))
NCE_STEPS, NCE_WARMUP, TP_STEPS = 20, 3, 20
TP_CLASSES = 40  # the Reddit-shaped SBM store's classes under a model axis of 2 (41 is odd)

# Published peaks (NVIDIA data sheets, dense): bytes/s, bf16 tensor FLOP/s,
# f32 FLOP/s. The SXM part is the default; the PCIe part by name.
PEAKS = {
    "sxm": (3.35e12, 989e12, 67e12),
    "pcie": (2.0e12, 756e12, 51e12),
}
SOURCES = {
    "select_columns": ("tpu_sage_torch/kernels/csrc/select.cu",
                       "tpu_sage/kernels/select.py:29"),
    "sample_hop": ("tpu_sage_torch/kernels/csrc/select.cu",
                   "tpu_sage/kernels/select.py:29 with the hop gathers of "
                   "tpu_sage/sample/sampler.py:55-60"),
    "gather_rows": ("tpu_sage_torch/kernels/csrc/gather.cu",
                    "tpu_sage/kernels/gather.py:64"),
    "gather_rows_blockspec": ("tpu_sage_torch/kernels/csrc/gather.cu",
                              "tpu_sage/kernels/gather.py:135"),
    "gather_fanout_mean": ("tpu_sage_torch/kernels/csrc/gather_mean.cu",
                           "tpu_sage/kernels/gather_mean.py:93"),
    "mean_project": ("tpu_sage_torch/kernels/csrc/mean_project.cu",
                     "tpu_sage/kernels/mean_project.py:56"),
    "gather_fanout_mean_int8": ("tpu_sage_torch/kernels/csrc/gather_mean.cu",
                                "tpu_sage/kernels/gather_mean.py:93 on an int8 table "
                                "(tpu_sage/data/quantize.py:68, XLA in JAX)"),
    "sample_hop_csr": ("tpu_sage_torch/kernels/csrc/select.cu",
                       "tpu_sage/kernels/select.py:29 in the CSR hops of "
                       "tpu_sage/sample/csr.py:67,130"),
    "gather_fanout_mean_owned": ("tpu_sage_torch/kernels/csrc/gather_mean.cu",
                                 "tpu_sage/kernels/gather_mean.py:93 with the owner mask of "
                                 "tpu_sage/dist/halo.py:229-240 (dist_gather_fanout_mean, "
                                 "XLA in JAX)"),
    "select_hop": ("tpu_sage_torch/kernels/csrc/select.cu",
                   "tpu_sage/kernels/select.py:29 with the column arithmetic of "
                   "tpu_sage/dist/train.py:587-608, tpu_sage/dist/halo.py:135-180 and "
                   "tpu_sage/sample/sampler.py:111-132"),
    "csr_tree": ("tpu_sage_torch/kernels/csrc/select.cu",
                 "tpu_sage/kernels/select.py:29 in every hop of tpu_sage/sample/csr.py:178 "
                 "(sample_tree_csr) and of the CSR walk of tpu_sage/train/unsupervised.py:54"),
}


def per_step_launches(agg, prep, fuse_last, int8=False, csr=False, fuse_first=False):
    """Kernel launches of one training step (``encode`` with the fused
    sampler): 2 hops (``sample_hop``, or on CSR adjacency the whole tree in
    one ``csr_tree``); the levels' gathers (of int8 rows on an int8 table), the
    deepest level summarised by ``gather_fanout_mean`` (its int8 entry on an
    int8 table) when it is fused under mean or gcn (else gathered whole,
    fused or not); ``mean_project`` for each mean pairing of an unreduced
    neighborhood (2 when the deepest level is fused, else 3; a prep's f32
    rows under bf16 go through it too). With ``fuse_first`` (mean, identity,
    two layers): ``project_gather``'s two self levels gathered from the
    projected table, its two neighbor levels' fanout means there, the four
    levels' raw rows gathered in its backward, and layer 2's one
    ``mean_project``."""
    hops = {"sample_hop": 0 if csr else 2, "sample_hop_csr": 0, "csr_tree": int(csr),
            "select_columns": 0, "select_hop": 0}
    if fuse_first and agg == "mean" and prep == "identity":
        return {"gather_rows": 6, "gather_rows_blockspec": 0,
                "gather_fanout_mean": 2, "mean_project": 1, "gather_fanout_mean_int8": 0,
                "gather_fanout_mean_owned": 0, **hops}
    fused = prep == "identity" and fuse_last != "off" and (agg != "lstm" or fuse_last == "all")
    summary_kernel = fused and agg in ("mean", "gcn")
    mean_project = 0 if agg != "mean" else 2 if fused else 3
    return {"gather_rows": 2 if summary_kernel else 3, "gather_rows_blockspec": 0,
            "gather_fanout_mean": int(summary_kernel and not int8),
            "mean_project": mean_project,
            "gather_fanout_mean_int8": int(summary_kernel and int8),
            "gather_fanout_mean_owned": 0, **hops}


def dist_per_step(mode, world):
    """Kernel launches of one partitioned step (mean, identity) on each of
    ``world`` ranks: per exchange, the owner's answers (``gather_rows``;
    the ring fills once per rank it passes, the bucketed exchange gathers
    the local rows, the owner's answers and the returned slots); the two
    hops' column picks with their arithmetic (``select_hop``; on CSR shards
    at the owner, after four gathers each: degrees, indptr, the window
    pair); the deepest
    level's pre-reduced means at the owner (``gather_fanout_mean_owned``,
    once per rank a ring passes; bucketed routing gathers the rows and
    means them at the requester); ``mean_project`` for the two unreduced
    pairings."""
    per = {"exact": 1, "ring": world, "pipelined": world, "bucketed": 3, "csr": 1,
           "int8": 1, "hier2d": 1}[mode]
    hops = 8 if mode == "csr" else 2 * per
    deepest_rows = per if mode == "bucketed" else 0
    return {"select_columns": 0, "select_hop": 2, "sample_hop": 0,
            "gather_rows": hops + 2 * per + deepest_rows,
            "gather_rows_blockspec": 0, "gather_fanout_mean": 0, "mean_project": 2,
            "gather_fanout_mean_int8": 0, "sample_hop_csr": 0, "csr_tree": 0,
            "gather_fanout_mean_owned": 0 if mode == "bucketed" else per}


PER_STEP = per_step_launches("mean", "identity", "auto")  # the main path
# the main path's configuration on an int8 table and CSR adjacency (phase 8)
STORAGE_PER_STEP = per_step_launches("mean", "identity", "auto", int8=True, csr=True)
FUSED_PER_STEP = per_step_launches("mean", "identity", "auto", fuse_first=True)  # phase 9


def log(*args):
    print(*args, flush=True)


def ptxas_report(path):
    """'kernel<template arguments, mangled>: N registers, S B spilled' for each
    entry function of an nvcc -Xptxas -v log."""
    import re

    report, name, spill = [], "?", 0
    with open(path) as f:
        for ln in f:
            m = re.search(r"Compiling entry function '_Z(\w+)'", ln)
            if m:
                name = kernel_name(m.group(1))
            m = re.search(r"(\d+) bytes spill stores", ln)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                report.append(f"{name}: {m.group(1)} registers, {spill} B spilled")
    return report


def kernel_name(mangled):
    """The function's own name and its template arguments from an Itanium
    mangled name without its '_Z' (namespaces dropped)."""
    i, nested, name = 0, mangled.startswith("N"), "?"
    i += nested
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
        if not nested:
            break
    rest = mangled[i:]
    return name + (f"<{rest[1:rest.index('E')]}>" if rest.startswith("I") else "")


def phase_kernels(torch, np, graph, levels, peaks):
    """Phase 3: each kernel against its plain version at main-path shapes."""
    from tpu_sage_torch.kernels import (gather, gather_blockspec, gather_mean, mean_project,
                                        sample_hop, select)
    from tpu_sage_torch.sample.sampler import pack_adjacency

    bw, bf16_peak, f32_peak = peaks
    feats, adj, deg = graph.feats, graph.adj, graph.degrees
    n, max_degree = adj.shape
    l0, l1, l2 = levels
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = []

    def distinct(ids):
        return int(torch.unique(ids).numel())

    def add(kernel, case, kernel_fn, plain_fn, library_fn, nbytes, flops=0.0, peak=bf16_peak,
            tol=None, weight=1):
        cases.append(kernel_case(kernel, case, kernel_fn, plain_fn, library_fn, nbytes, flops,
                                 peak, tol, weight))

    # sampler hops, fused: hop 1 (512 ids x 25) and hop 2 (12,800 ids x 10)
    # on the train graph. Bytes: the ids, each distinct 32-byte degree sector,
    # each distinct 32-byte adjacency sector the picks hit, u and out. The
    # library yardstick is one advanced-indexing call adj[ids, cols] with the
    # columns precomputed: it leaves out the degree gather and the column
    # arithmetic that the kernel also does.
    hops = []
    for ids, f in ((l0, FANOUTS[0]), (l1, FANOUTS[1])):
        ids64 = ids.long()
        u = torch.rand((ids.shape[0], f), generator=gen, device="cuda")
        cols64 = sample_hop.hop_columns(u, deg[ids64].clamp_min(1)).long()
        adj_sectors = distinct((ids64[:, None] * max_degree + cols64) // 8)
        add("sample_hop", f"ids ({ids.shape[0]},), u {tuple(u.shape)}, adj {tuple(adj.shape)}",
            lambda i=ids, u=u: sample_hop.sample_hop(adj, deg, i, u),
            lambda i=ids, u=u: sample_hop.sample_hop_reference(adj, deg, i, u),
            lambda i=ids64, c=cols64: adj[i[:, None], c],
            4 * ids.shape[0] + 32 * distinct(ids64 // 8) + 32 * adj_sectors + 8 * u.numel())
        hops.append((ids, u))

    # the packed sampler's two hops on the gathered adjacency ‖ degree rows
    # (the adjacency part a view with a row stride of max_degree + 1):
    # select_hop (the packed hop's launch: the column arithmetic, the pick)
    # and the bare select_columns it replaced there (the columns
    # precomputed), at the same rows. Bytes of select_hop: u, the distinct
    # 32-byte sectors of the picks and of the degree words, out; of
    # select_columns: the picks' sectors, cols and out. The library
    # yardstick is one torch.gather with the columns precomputed.
    packed = pack_adjacency(adj, deg)
    for ids, u in hops:
        full = packed[ids.long()]
        rows, r_deg = full[:, :-1], full[:, -1]
        cols = sample_hop.hop_columns(u, deg[ids.long()].clamp_min(1)).contiguous()
        cols64 = cols.long()
        base = torch.arange(rows.shape[0], device="cuda")[:, None] * rows.stride(0)
        pick_words = (base + cols64).reshape(-1)
        sectors = distinct(pick_words // 8)
        add("select_hop", f"packed rows int32 {tuple(rows.shape)} (row stride "
            f"{rows.stride(0)}), degree column, u {tuple(u.shape)}",
            lambda r=rows, d_=r_deg, u=u: select.select_hop(r, d_, u),
            lambda r=rows, d_=r_deg, u=u: select.select_hop_reference(r, d_, u),
            lambda r=rows, c=cols64: torch.gather(r, 1, c),
            32 * distinct(torch.cat([pick_words, base[:, 0] + rows.shape[1]]) // 8)
            + 8 * u.numel())
        add("select_columns", f"rows int32 {tuple(rows.shape)} (row stride {rows.stride(0)}), "
            f"cols {tuple(cols.shape)}",
            lambda r=rows, c=cols: select.select_columns(r, c),
            lambda r=rows, c=cols: select.select_columns_reference(r, c),
            lambda r=rows, c=cols64: torch.gather(r, 1, c),
            32 * sectors + 8 * cols.numel())

    # gather: feature rows (the main path's two launches), the degree and
    # adjacency rows the hops gathered before sample_hop, at q = 512 and
    # 12,800; the one-row-per-block foil at the same six cases; and the
    # packed sampler's 516-byte rows
    deg2 = deg.view(-1, 1)
    for ids in (l0, l1):
        q, ids64, nd = ids.shape[0], ids.long(), distinct(ids)
        for name, tab, weight in (("degrees int32", deg2, 0), ("adjacency int32", adj, 0),
                                  ("feats bf16", feats, 1),
                                  ("packed adjacency ‖ degree int32", packed, 0)):
            row = tab.shape[1] * tab.element_size()
            for kernel, fn, ref in (
                    ("gather_rows", gather.gather_rows, gather.gather_rows_reference),
                    ("gather_rows_blockspec", gather_blockspec.gather_rows_blockspec,
                     gather_blockspec.gather_rows_blockspec_reference)):
                if kernel == "gather_rows_blockspec" and tab is packed:
                    continue
                add(kernel, f"{name} {tuple(tab.shape)} q={q}",
                    lambda t=tab, i=ids, k=fn: k(t, i),
                    lambda t=tab, i=ids, k=ref: k(t, i),
                    lambda t=tab, i=ids64: t[i],
                    4 * q + nd * row + q * row, weight=weight)

    # gather: exact inference's shapes (off the training step, weight 0): one
    # chunk's neighbor ids, q = 4,096 x 128, from an f32 (n, 602) table
    # (export, layer 0), an f32 (n, 256) one (layer 1) and a bf16 (n, 602)
    # one (fit's exact validation, layer 0)
    cols = torch.arange(max_degree, dtype=torch.int32, device="cuda")
    chunk_ids = torch.where(cols < deg[:EXACT_CHUNK, None], adj[:EXACT_CHUNK], -1).reshape(-1)
    q, nd = chunk_ids.shape[0], distinct(chunk_ids)
    feats32 = feats.float()
    hidden = torch.randn((n, 2 * DIMS[0]), generator=gen, device="cuda")
    for name, tab in (("exact layer 0 f32", feats32), ("exact layer 1 f32", hidden),
                      ("exact layer 0 bf16", feats)):
        row = tab.shape[1] * tab.element_size()
        add("gather_rows", f"{name} {tuple(tab.shape)} q={q}",
            lambda t=tab: gather.gather_rows(t, chunk_ids, "zero"),
            lambda t=tab: gather.gather_rows_reference(t, chunk_ids, "zero"),
            lambda t=tab: t[chunk_ids.long()],
            4 * q + nd * row + q * row, weight=0)

    # fanout mean: deepest level, 128,000 ids, F = 10 -> (12800, 602) f32
    f = FANOUTS[1]
    r, dcol = l2.shape[0] // f, feats.shape[1]
    l2_64 = l2.long()
    add("gather_fanout_mean", f"bf16 {tuple(feats.shape)} ids={l2.shape[0]} F={f}",
        lambda: gather_mean.gather_fanout_mean(feats, l2, f),
        lambda: gather_mean.gather_fanout_mean_reference(feats, l2, f),
        lambda: feats[l2_64].float().view(r, f, dcol).mean(1),
        4 * l2.shape[0] + distinct(l2) * dcol * 2 + r * dcol * 4,
        flops=l2.shape[0] * dcol, peak=f32_peak)

    # mean + projection: layer 0 x (512, 25, 602), layer 1 x (512, 25, 256),
    # and layer 0 again with x's base 4 bytes off 16-byte alignment (the
    # kernel's 4-byte cp.async instantiation; not a main-path launch, so it
    # does not count into the per-step sums). Tolerance: one bf16 ulp of each
    # output (rtol 2^-7) plus 1e-4 of the output's scale where sums cancel:
    # the mean is bitwise the plain version's, the f32 product's order of
    # summation differs.
    x0 = feats[l1.long()].view(BATCH, FANOUTS[0], dcol)
    x1 = torch.relu(torch.randn((BATCH, FANOUTS[0], 2 * DIMS[0]), generator=gen,
                                device="cuda")).to(torch.bfloat16)
    x0_off = torch.empty(x0.numel() + 2, dtype=x0.dtype, device="cuda")[2:].view(x0.shape)
    x0_off.copy_(x0)
    assert x0_off.data_ptr() % 16 == 4
    for label, x, weight in (("layer 0", x0, 1), ("layer 1", x1, 1),
                             ("layer 0, x 4 B off alignment", x0_off, 0)):
        b, fo, d = x.shape
        w = (torch.randn((d, DIMS[1]), generator=gen, device="cuda") / d ** 0.5).to(x.dtype)
        add("mean_project", f"{label} x bf16 {tuple(x.shape)}, W {tuple(w.shape)}",
            lambda x=x, w=w: mean_project.mean_project(x, w),
            lambda x=x, w=w: mean_project.mean_project_reference(x, w),
            lambda x=x, w=w: x.mean(1) @ w,
            x.numel() * 2 + w.numel() * 2 + b * DIMS[1] * 2,
            flops=2 * b * d * DIMS[1] + b * fo * d, tol=MEAN_PROJECT_TOL, weight=weight)

    cases += redesign_cases(torch, graph, levels, peaks, gen)
    results = time_cases(torch, cases, bw)

    # edge cases the main path never produces: out-of-range ids and columns,
    # an f32 table, a ragged batch with W chunks in a ring, and the
    # mean_project backward
    ids_oob = torch.tensor([-n - 5, -1, 0, 5, n - 1, n, n + 7], dtype=torch.int32, device="cuda")
    for oob in ("clamp", "zero"):
        if not torch.equal(gather.gather_rows(feats, ids_oob, oob),
                           gather.gather_rows_reference(feats, ids_oob, oob)):
            raise AssertionError(f"gather_rows oob={oob} differs from its plain version")
    if not torch.equal(gather_blockspec.gather_rows_blockspec(feats, ids_oob),
                       gather_blockspec.gather_rows_blockspec_reference(feats, ids_oob)):
        raise AssertionError("gather_rows_blockspec differs on out-of-range ids")
    check_gather_shifts(torch, gather, gen)
    check_sample_hop_edges(torch, sample_hop, gen)
    check_select_hop_edges(torch, select, gen)
    rows = adj[l0.long()]
    cols_oob = torch.randint(-3, rows.shape[1] + 3, (rows.shape[0], 25), generator=gen,
                             device="cuda", dtype=torch.int32)
    if not torch.equal(select.select_columns(rows, cols_oob),
                       select.select_columns_reference(rows, cols_oob)):
        raise AssertionError("select_columns differs on out-of-range columns")
    if not torch.equal(gather_mean.gather_fanout_mean(feats32, l2, f),
                       gather_mean.gather_fanout_mean_reference(feats32, l2, f)):
        raise AssertionError("gather_fanout_mean f32 differs from its plain version")
    del feats32, hidden
    xr = x0[:37, :10].contiguous()  # B = 37: a ragged last block; O = 256: W chunks in a ring
    wr = (torch.randn((dcol, 256), generator=gen, device="cuda") / dcol ** 0.5).to(xr.dtype)
    ref = mean_project.mean_project_reference(xr, wr)
    torch.testing.assert_close(mean_project.mean_project(xr, wr).float(), ref.float(),
                               rtol=MEAN_PROJECT_TOL[0],
                               atol=MEAN_PROJECT_TOL[1] * ref.float().abs().max().item())
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        x = x0.to(dtype)
        w = (torch.randn((dcol, DIMS[1]), generator=gen, device="cuda") / dcol ** 0.5).to(dtype)
        g = torch.randn((BATCH, DIMS[1]), generator=gen, device="cuda").to(dtype)
        grads = []
        for fwd in (mean_project.mean_project,
                    lambda a, b: (a.float().mean(1).to(a.dtype).float() @ b.float()).to(a.dtype)):
            xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
            out = fwd(xa, wa)
            out.backward(g)
            grads.append((out.detach().float(), xa.grad.float(), wa.grad.float()))
        for k, (a, b) in zip(("out", "dx", "dW"), zip(*grads)):
            torch.testing.assert_close(a, b, rtol=tol, atol=tol * b.abs().max().item(),
                                       msg=lambda m, k=k: f"mean_project {dtype} {k}: {m}")
    check_mean_project_tiles(torch, mean_project, feats, gen)
    check_mean_project_f32(torch, mean_project, gather_mean, feats, gen)
    check_owned_edges(torch, gather_mean, gen)
    torch.cuda.synchronize()
    log("  out-of-range ids/cols, every gather_rows realignment shift (bf16, f32, int8; 2- and "
        "4-byte; 8, 16 and 32 lanes a row; 16-byte words 2 a lane), sample_hop at degree 0 and "
        "u near 1, select_hop's edge cases (bitwise), f32 fanout mean (bitwise), ragged mean_project with a W ring, persistent "
        "mean_project tiles (ragged, x 4 and 8 B off, W ring), the f32-W mean_project's "
        "ragged cases and its mean bitwise, the owner-masked mean's edge cases (bitwise), "
        "mean_project backward (bf16, f32): ok")
    return results


def redesign_cases(torch, graph, levels, peaks, gen):
    """Phase 3, the shapes where ``mean_project`` and ``gather_rows`` lost to
    their library call before their redesign (weight 0: off the main path's
    step), against their plain versions: ``mean_project`` at the NCE step's
    layers (6,144 roots, row 5u), on the preps' f32 rows (512 x 25 and
    12,800 x 10, 64 and 666 wide, row 5x), at a model axis of 2's O = 64
    (row 5t) and with an f32 W (row 5f: the main path's two layers and the
    f32 NCE step's layer 0, 6,144 roots; its yardstick is the f32 product
    at "highest" precision); ``gather_rows`` on the int8 step's 602-byte rows
    (q = 512, 12,800, row 2i), on PPI-shaped 200-byte f32 rows (q = 64,000)
    and on exact inference's f32 rows 256 wide (q = 524,288, row 2x)."""
    from tpu_sage_torch.kernels import gather, mean_project

    bw, bf16_peak, f32_peak = peaks
    feats, adj, deg = graph.feats, graph.adj, graph.degrees
    n, dcol = feats.shape
    l0, l1, l2 = levels
    cases = []

    def add_mp(label, x, w, peak=bf16_peak, tol=MEAN_PROJECT_TOL):
        b, f, d = x.shape
        o = w.shape[1]
        cases.append(kernel_case(
            "mean_project", f"{label} x {str(x.dtype)[6:]} {tuple(x.shape)}, W "
            f"{str(w.dtype)[6:]} {tuple(w.shape)}",
            lambda x=x, w=w: mean_project.mean_project(x, w),
            lambda x=x, w=w: mean_project.mean_project_reference(x, w),
            lambda x=x, w=w: x.mean(1).to(w.dtype) @ w,
            x.numel() * x.element_size() + w.numel() * w.element_size()
            + b * o * w.element_size(),
            flops=2 * b * d * o + b * f * d, peak=peak, tol=tol, weight=0))

    def weight(d, o, dtype=torch.bfloat16):
        return (torch.randn((d, o), generator=gen, device="cuda") / d ** 0.5).to(dtype)

    ids_u = torch.randint(0, n, (6144 * FANOUTS[0],), generator=gen, device="cuda",
                          dtype=torch.int32)
    x0 = feats[l1.long()].view(BATCH, FANOUTS[0], dcol)
    x1 = torch.relu(torch.randn((BATCH, FANOUTS[0], 2 * DIMS[0]), generator=gen,
                                device="cuda")).to(torch.bfloat16)
    add_mp("NCE layer 0", feats[ids_u.long()].view(6144, FANOUTS[0], dcol), weight(dcol, 128))
    add_mp("NCE layer 1", torch.relu(torch.randn((6144, FANOUTS[0], 256), generator=gen,
                                                 device="cuda")).to(torch.bfloat16),
           weight(256, 128))
    prep_w = torch.randn((dcol, EMBEDDING_DIM), generator=gen, device="cuda") / dcol ** 0.5
    for ids, f in ((l1, FANOUTS[0]), (l2, FANOUTS[1])):
        rows = feats[ids.long()].float()
        emb = torch.randn((ids.shape[0], EMBEDDING_DIM), generator=gen, device="cuda")
        add_mp("linear prep", (rows @ prep_w).view(-1, f, EMBEDDING_DIM),
               weight(EMBEDDING_DIM, DIMS[0]))
        add_mp("node_embedding prep", torch.cat([rows, emb / EMBEDDING_DIM ** 0.5], 1).view(
            -1, f, dcol + EMBEDDING_DIM), weight(dcol + EMBEDDING_DIM, DIMS[0]))
        del rows, emb
    for label, x in (("TP layer 0", x0), ("TP layer 1", x1)):
        add_mp(label, x, weight(x.shape[2], DIMS[1] // 2))
    for label, x in (("f32 W layer 0", x0.float()), ("f32 W layer 1", x1.float()),
                     ("f32 W NCE layer 0", feats[ids_u.long()].view(6144, FANOUTS[0], dcol)
                      .float())):
        add_mp(label, x, weight(x.shape[2], DIMS[1], torch.float32), peak=f32_peak,
               tol=(1e-5, 1e-5))

    def add_gather(label, table, ids, oob="clamp"):
        q, row, ids64 = ids.shape[0], table.shape[1] * table.element_size(), ids.long()
        nd = int(torch.unique(ids).numel())
        cases.append(kernel_case(
            "gather_rows", f"{label} {str(table.dtype)[6:]} {tuple(table.shape)} q={q}",
            lambda t=table, i=ids: gather.gather_rows(t, i, oob),
            lambda t=table, i=ids: gather.gather_rows_reference(t, i, oob),
            lambda t=table, i=ids64: t[i], 4 * q + nd * row + q * row, weight=0))

    q8 = torch.randint(-128, 128, feats.shape, generator=gen, device="cuda", dtype=torch.int8)
    for ids in (l0, l1):
        add_gather("int8 step rows", q8, ids)
    ppi = torch.randn((PPI["n_nodes"], PPI["feat_dim"]), generator=gen, device="cuda")
    add_gather("PPI-shaped rows", ppi, torch.randint(
        0, PPI["n_nodes"], (256 * FANOUTS[0] * FANOUTS[1],), generator=gen, device="cuda",
        dtype=torch.int32), "zero")
    cols = torch.arange(adj.shape[1], dtype=torch.int32, device="cuda")
    chunk_ids = torch.where(cols < deg[:EXACT_CHUNK, None], adj[:EXACT_CHUNK], -1).reshape(-1)
    add_gather("exact layer 1 f32", torch.randn((n, 2 * DIMS[0]), generator=gen, device="cuda"),
               chunk_ids, "zero")
    return cases


def check_mean_project_tiles(torch, mean_project, feats, gen):
    """The persistent bf16 kernel where the timed cases do not go, within
    MEAN_PROJECT_TOL of its plain version: a ragged last tile (6,143 and
    6,145 roots: blocks of several tiles, the last one short), x 4 and 8
    bytes past 16-byte alignment (cp.async words of 4 and 8 bytes) at 6,144
    roots, W in a ring of chunk buffers (O = 256 at 6,144 roots), an odd D
    (601) and a B between 4·132 and 8·132."""
    n, d = feats.shape
    ids = torch.randint(0, n, (6145 * 10,), generator=gen, device="cuda", dtype=torch.int32)
    x = feats[ids.long()].view(6145, 10, d)
    base = torch.empty(x.numel() + 8, dtype=x.dtype, device="cuda")
    cases = [("ragged 6,143 roots", x[:6143], 128), ("ragged 6,145 roots", x, 128),
             ("W ring, O = 256", x[:6144], 256), ("odd D", x[:6144, :, :601].contiguous(), 128),
             ("B = 700", x[:700], 128)]
    for off in (2, 4):  # bf16 elements: 4 and 8 bytes
        xo = base[off:off + 6144 * 10 * d].view(6144, 10, d)
        xo.copy_(x[:6144])
        assert xo.data_ptr() % 16 == 2 * off
        cases.append((f"x {2 * off} B off alignment", xo, 128))
    for label, xc, o in cases:
        w = (torch.randn((xc.shape[2], o), generator=gen, device="cuda") / d ** 0.5).to(xc.dtype)
        plan = mean_project.bf16_plan(xc.shape[0], xc.shape[1], xc.shape[2], o, xc.data_ptr(),
                                      xc.element_size(), torch.cuda.get_device_properties(
                                          0).multi_processor_count)
        ref = mean_project.mean_project_reference(xc, w).float()
        torch.testing.assert_close(
            mean_project.mean_project(xc, w).float(), ref, rtol=MEAN_PROJECT_TOL[0],
            atol=MEAN_PROJECT_TOL[1] * ref.abs().max().item(),
            msg=lambda m, label=label, plan=plan: f"mean_project {label} (plan {plan}): {m}")


def check_mean_project_f32(torch, mean_project, gather_mean, feats, gen):
    """The f32-W kernel where the timed cases do not go, within (1e-5, 1e-5)
    of its plain version: B not a multiple of a tile (511, 700, 6,143, 1),
    an odd D (601: float words), O = 41 and 100 (W padded to a multiple of
    4), x 4 bytes past 8-byte alignment (float words), W 4 bytes past 16
    (copied to an aligned one), F = 40 (two reducer batches), D = 1 with
    O = 1,816 (the widest O the earlier kernel took: W in 4-row blocks) and
    D = 3,000; and its mean bitwise the plain version's (W = I, where each
    output is one mean times 1 plus zeros; signed zeros compared as +0)."""
    n, d = feats.shape
    ids = torch.randint(0, n, (6144 * FANOUTS[0],), generator=gen, device="cuda",
                        dtype=torch.int32)
    x = feats[ids.long()].view(6144, FANOUTS[0], d).float()
    x0 = x[:BATCH].contiguous()
    base = torch.empty(x0.numel() + 1, device="cuda")
    xo = base[1:].view(x0.shape)
    xo.copy_(x0)
    assert xo.data_ptr() % 8 == 4
    wo = torch.empty(d * DIMS[1] + 1, device="cuda")[1:].view(d, DIMS[1])
    wo.copy_(torch.randn((d, DIMS[1]), generator=gen, device="cuda") / d ** 0.5)
    cases = [("B = 511", x[:511], None), ("B = 700", x[:700], None), ("B = 6,143", x[:6143], None),
             ("B = 1", x[:1], None), ("odd D", x0[:, :, :601].contiguous(), None),
             ("O = 41", x0, 41), ("O = 100", x0, 100), ("x 4 B off", xo, None),
             ("W 4 B off", x0, wo), ("F = 40", x0[:, :20].repeat(1, 2, 1).contiguous(), None),
             ("D = 1, O = 1,816", x0[:64, :, :1].contiguous(), 1816),
             ("D = 3,000", torch.randn((100, 5, 3000), generator=gen, device="cuda"), 7)]
    for label, xc, o in cases:
        w = o if isinstance(o, torch.Tensor) else torch.randn(
            (xc.shape[2], o or DIMS[1]), generator=gen, device="cuda") / xc.shape[2] ** 0.5
        ref = mean_project.mean_project_reference(xc, w)
        torch.testing.assert_close(
            mean_project.mean_project(xc, w), ref, rtol=1e-5,
            atol=1e-5 * ref.abs().max().item(),
            msg=lambda m, label=label: f"mean_project f32 W, {label}: {m}")
    for label, xc in (("layer 0", x0), ("layer 1", torch.relu(torch.randn(
            (BATCH, FANOUTS[0], 2 * DIMS[0]), generator=gen, device="cuda")))):
        eye = torch.eye(xc.shape[2], device="cuda")
        if not torch.equal(mean_project.mean_project(xc, eye) + 0.0,
                           gather_mean.fanout_sum_mean(xc) + 0.0):
            raise AssertionError(f"mean_project f32 W {label}: the mean is not bitwise the "
                                 f"plain version's")


def check_owned_edges(torch, gather_mean, gen):
    """The owner-masked fanout mean bitwise its plain version where the timed
    cases do not go: a root with no owned id, owned rows holding -0.0 (a
    root of them only), ids at both ends of [lo, lo + m) and just outside,
    f32, bf16 and int8 tables of even and odd widths (602 and 601; 301 f32;
    2,000 f32 rows, which go in passes) whose base lies at every offset its
    element allows past 16 bytes, and fanouts of 1, 33 and 40."""
    n, lo, m, r = 4000, 1000, 1000, 2000
    vals = torch.randn((n, 602), generator=gen, device="cuda")
    vals[1100:1110] = -0.0
    ids = torch.randint(0, n, (r * 40,), generator=gen, device="cuda", dtype=torch.int32)
    ids[:10] = 5
    ids[10:20] = torch.tensor([lo, lo + m - 1, 1099, lo - 1, lo + m, 1100, 1101, 1102, 1103,
                               1104], device="cuda")
    ids[20:30] = torch.arange(1100, 1110, device="cuda")

    def q8(t):
        return t.mul(30).clamp(-127, 127).to(torch.int8)

    tables = [("bf16 602", vals.to(torch.bfloat16)), ("bf16 601", vals[:, :601].to(torch.bfloat16)),
              ("f32 602", vals), ("f32 301", vals[:, :301]), ("int8 602", q8(vals)),
              ("int8 601", q8(vals[:, :601])),
              ("f32 2000", torch.randn((n, 2000), generator=gen, device="cuda"))]
    for label, table in tables:
        size = table.element_size()
        for off in range(0, 16, size):
            buf = torch.empty(table.numel() + 16, dtype=table.dtype, device="cuda")
            t = buf[off // size:off // size + table.numel()].view(table.shape)
            t.copy_(table)
            local = t[lo:lo + m]
            for f in ((10, 1, 33, 40) if off == 0 else (10,)):
                idf = ids[:(ids.shape[0] // f) * f]
                got = gather_mean.gather_fanout_mean_owned(local, idf, f, lo)
                want = gather_mean.gather_fanout_mean_owned_reference(local, idf, f, lo)
                if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                    raise AssertionError(f"gather_fanout_mean_owned {label} table +{off} B, "
                                         f"F = {f}: differs from its plain version")


def kernel_case(kernel, case, kernel_fn, plain_fn, library_fn, nbytes, flops=0.0, peak=1.0,
                tol=None, weight=1, floor_bytes=None):
    """One timed case of ``kernel``: ``library_fn`` None where no one PyTorch
    call computes the same function; ``tol`` None asks for a bitwise match;
    ``weight`` is its launches in one training step of the main path;
    ``floor_bytes``, where the bound counts distinct rows that only an
    order-changing design could read once, the bytes of reading every id's
    row (the no-reuse floor)."""
    return dict(kernel=kernel, case=case, kernel_fn=kernel_fn, plain_fn=plain_fn,
                library_fn=library_fn, bytes=float(nbytes), flops=float(flops), peak=peak,
                tol=tol, weight=weight, floor_bytes=floor_bytes)


def time_cases(torch, cases, bw):
    """Each case's kernel against its plain version (bitwise, or within its
    ``tol``), then kernel, plain and library call timed L2-cold, and the
    bound: the case's bytes at ``bw`` or its operations at its peak."""
    from tpu_sage_torch.bench.timing import cuda_ms

    results = []
    for c in cases:
        out = c["kernel_fn"]()
        torch.cuda.synchronize()
        ref = c["plain_fn"]()
        torch.cuda.synchronize()
        err = (out.double() - ref.double()).abs().max().item()
        if c["tol"] is None:
            if not torch.equal(out, ref):
                raise AssertionError(f"{c['kernel']} [{c['case']}] differs from its plain "
                                     f"version (max abs err {err})")
        else:
            rtol, atol_of_scale = c["tol"]
            torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                                       atol=atol_of_scale * ref.float().abs().max().item())
        ms = cuda_ms(c["kernel_fn"])
        plain_ms = cuda_ms(c["plain_fn"])
        library_ms = None if c["library_fn"] is None else cuda_ms(c["library_fn"])
        bound_bytes = c["bytes"] / bw * 1e3
        bound_ops = c["flops"] / c["peak"] * 1e3
        res = dict(kernel=c["kernel"], case=c["case"], weight=c["weight"],
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(bound_bytes, bound_ops),
                   bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                   bytes=c["bytes"])
        floor = ""
        if c["floor_bytes"] is not None:
            res["no_reuse_floor_ms"] = c["floor_bytes"] / bw * 1e3
            floor = (f"  no-reuse floor {res['no_reuse_floor_ms']:.4f} "
                     f"({res['no_reuse_floor_ms'] / ms:.0%})")
        results.append(res)
        library = "none" if library_ms is None else f"{library_ms:.4f}"
        log(f"  {c['kernel']:<19} {c['case']:<52} err {err:.3g}  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f}  library {library}  bound {res['bound_ms']:.4f} "
            f"({res['bound_by']}){floor}")
    return results


def check_gather_shifts(torch, gather, gen):
    """gather_rows bitwise at every realignment shift: bf16, f32 and int8
    tables of 1,204-byte rows, int8 rows of 602 bytes (2-byte realignment)
    and of 601 (the 1-byte word form), f32 rows of 200 bytes (16 lanes a
    row) and of 1,024 (16-byte words, 2 a lane), bf16 rows of 136 bytes (16
    lanes), whose base and whose output's base each lie at every offset
    past a 16-byte boundary their element allows (4-byte steps for f32, 2
    for the others), with ids naming the table's first and last rows and
    ids out of range in both forms. The bytes around the output must stay
    as they were."""
    n = SHIFT_ROWS
    ids = torch.cat([torch.tensor([0, n - 1, -n - 5, -1, n, n + 7], device="cuda"),
                     torch.randint(0, n, (506,), generator=gen, device="cuda")]).int()
    q = ids.shape[0]
    for dtype, width in ((torch.bfloat16, 602), (torch.float32, 301), (torch.int8, 1204),
                         (torch.int8, 601), (torch.int8, 602), (torch.float32, 50),
                         (torch.float32, 256), (torch.bfloat16, 68)):
        size = torch.tensor([], dtype=dtype).element_size()
        pad = 16 // size
        if dtype == torch.int8:
            src = torch.randint(-128, 128, (n * width + pad,), generator=gen, device="cuda",
                                dtype=torch.int8)
        else:
            src = torch.randn((n * width + pad,), generator=gen, device="cuda").to(dtype)
        buf = torch.empty((q * width + pad,), dtype=dtype, device="cuda")
        offsets = range(0, 16, max(size, 2))
        for t_off in offsets:
            table = src[t_off // size:t_off // size + n * width].view(n, width)
            for o_off in offsets:
                out = buf[o_off // size:o_off // size + q * width].view(q, width)
                assert table.data_ptr() % 16 == t_off and out.data_ptr() % 16 == o_off
                for oob in ("clamp", "zero"):
                    buf.fill_(7)
                    gather.gather_rows_into(table, ids, out, oob)
                    around = torch.cat([buf[:o_off // size], buf[o_off // size + q * width:]])
                    if not (torch.equal(out, gather.gather_rows_reference(table, ids, oob))
                            and bool((around == 7).all())):
                        raise AssertionError(
                            f"gather_rows {dtype} ({n}, {width}) table +{t_off} B, out "
                            f"+{o_off} B, oob={oob} (plan "
                            f"{gather.gather_plan(width * size, t_off, o_off)}): differs from "
                            f"its plain version or wrote outside its output")


def check_sample_hop_edges(torch, sample_hop, gen):
    """sample_hop bitwise against its plain version where the train graph
    never goes: degree 0 (column 0, the self pad), degree 1, degrees above the
    row width (a column >= D gives 0), u = 0 and u one ulp below 1, and ids
    out of range (the plain form)."""
    n, d, b, k = 1000, 128, 4096, 25
    adj = torch.randint(0, n, (n, d), generator=gen, device="cuda", dtype=torch.int32)
    deg = torch.randint(0, d + 9, (n,), generator=gen, device="cuda", dtype=torch.int32)
    deg[:50], deg[50:100] = 0, 1
    ids = torch.randint(-n - 3, n + 3, (b,), generator=gen, device="cuda", dtype=torch.int32)
    u = torch.rand((b, k), generator=gen, device="cuda")
    u[:, 0], u[:, 1] = 0.0, 1.0 - 2.0 ** -24
    if not torch.equal(sample_hop.sample_hop(adj, deg, ids, u),
                       sample_hop.sample_hop_reference(adj, deg, ids, u)):
        raise AssertionError("sample_hop differs from its plain version at its edge cases")


def check_select_hop_edges(torch, select, gen):
    """select_hop bitwise against its plain version where no path's rows go:
    degree 0 with and without ids (the self-loop, or column 0), degrees
    above the row width and negative, columns out of range both ways, the
    pair view's shift (negative, past the row, near 2^31 where the int32 sum
    wraps), rows as strided and offset views with the degree and shift
    columns read in place or as tensors of their own, u at 0 and one ulp
    below 1, ragged B (one row, 37 rows, 4,097 rows) and K = 1."""
    n, d = 5000, 40
    table = torch.randint(-3, n, (n, d + 7), generator=gen, device="cuda", dtype=torch.int32)
    table[:, d + 1] = torch.randint(-2, d + 12, (n,), generator=gen, device="cuda",
                                    dtype=torch.int32)
    table[::13, d + 1] = 0
    table[:, d] = torch.randint(-6, 2 * d, (n,), generator=gen, device="cuda",
                                dtype=torch.int32)
    table[::29, d] = 2**31 - 3
    for b, k in ((1, 10), (37, 25), (4097, 10), (4097, 1)):
        ids = torch.randint(-n, 2 * n, (b,), generator=gen, device="cuda", dtype=torch.int32)
        full = table[torch.randint(0, n, (b,), generator=gen, device="cuda")]
        off = torch.empty((b, d + 9), dtype=torch.int32, device="cuda")[:, 2:]
        off.copy_(full)  # rows 8 bytes past the allocation's start, row stride d + 9
        u = torch.rand((b, k), generator=gen, device="cuda")
        u[:, 0] = 0.0
        if k > 1:
            u[:, 1] = 1.0 - 2.0 ** -24
        for rows in (full, off):
            view, r_deg, shift = rows[:, :d], rows[:, d + 1], rows[:, d]
            for sh in (None, shift, shift.clone()):
                for i in (None, ids):
                    for dg in (r_deg, r_deg.clone()):
                        got = select.select_hop(view, dg, u, shift=sh, ids=i)
                        want = select.select_hop_reference(view, dg, u, shift=sh, ids=i)
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"select_hop differs from its plain version: B {b}, K {k}, "
                                f"row stride {rows.stride(0)}, shift {sh is not None}, ids "
                                f"{i is not None}")


def check_packed_sampler(torch, graph, roots):
    """sample_tree_packed at full width against sample_tree with the same
    per-hop uniforms, bitwise, each with its own launch counts: the fused
    hop launches sample_hop once per hop; the packed hop one gather_rows of
    516-byte rows and one select_hop."""
    from tpu_sage_torch import kernels
    from tpu_sage_torch.sample.sampler import pack_adjacency, sample_tree, sample_tree_packed

    gen = torch.Generator(device="cuda").manual_seed(13)
    us, q = [], roots.shape[0]
    for f in FANOUTS:
        us.append(torch.rand((q, f), generator=gen, device="cuda"))
        q *= f
    packed = pack_adjacency(graph.adj, graph.degrees)
    want = {name: 0 for name in kernels.KERNEL_MODULES}
    trees, counts = [], []
    for fn, args in ((sample_tree, (graph.adj, graph.degrees)), (sample_tree_packed, (packed,))):
        kernels.reset_launch_counts()
        trees.append(fn(*args, roots, FANOUTS, us=us))
        torch.cuda.synchronize()
        counts.append(kernels.launch_counts())
    hops = len(FANOUTS)
    if counts != [{**want, "sample_hop": hops},
                  {**want, "gather_rows": hops, "select_hop": hops}]:
        raise AssertionError(f"sampler launch counts {counts}")
    for level, (a, b) in enumerate(zip(*trees)):
        if not torch.equal(a, b):
            raise AssertionError(f"sample_tree_packed differs from sample_tree at level {level}")
    log(f"  sample_tree_packed {[tuple(t.shape) for t in trees[1]]} bitwise equal to "
        f"sample_tree; launches per tree: fused {counts[0]}, packed {counts[1]}")


def phase_reference(torch, np, store, levels_cuda):
    """Phase 4: full-width bf16 forward card vs CPU, and a small f32 train
    parity run card vs CPU."""
    from tpu_sage_torch.data.synthetic import sbm_problem
    from tpu_sage_torch.nn.params import flax_params, load_flax_params
    from tpu_sage_torch.train.trainer import TrainConfig, Trainer, build_model

    cfg = TrainConfig(batch_size=BATCH, n_train_samples=FANOUTS, n_val_samples=FANOUTS,
                      output_dims=DIMS, compute_dtype="bfloat16", seed=11)
    src = build_model(cfg, store.n_nodes, store.n_classes, store.feat_dim)
    src.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    tree = flax_params(src)
    outs = {}
    for dev in ("cuda", "cpu"):
        model = load_flax_params(build_model(cfg, store.n_nodes, store.n_classes,
                                             store.feat_dim), tree).to(dev)
        feats = torch.from_numpy(store.feats).to(device=dev, dtype=torch.bfloat16)
        with torch.no_grad():
            outs[dev] = model([l.to(dev) for l in levels_cuda], feats).float().cpu()
        del feats
    scale = outs["cpu"].abs().max().item()
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    if not (torch.isfinite(outs["cuda"]).all() and err <= 3e-2 * scale):
        raise AssertionError(f"full-width logits: card vs CPU max abs err {err} "
                             f"> 3e-2 x {scale}")
    log(f"  full-width bf16 forward {tuple(outs['cuda'].shape)}: max abs err {err:.4g} "
        f"(limit 3e-2 x max|logit| = {3e-2 * scale:.4g})")

    problem = sbm_problem(n_nodes=800, n_classes=5, feat_dim=32)
    small = TrainConfig(batch_size=64, n_train_samples=(10, 5), n_val_samples=(10, 5),
                        output_dims=(32, 32), lr_init=0.01)
    rng = np.random.default_rng(3)
    losses = {}
    for dev in ("cuda", "cpu"):
        graph = problem.device_graph(train=True, device=dev)
        model = build_model(small, problem.n_nodes, problem.n_classes, problem.feats_dim)
        trainer = Trainer(model, small, steps_per_epoch=10, task=problem.task)
        state = trainer.init_state(graph)
        rng = np.random.default_rng(3)
        losses[dev] = []
        for _ in range(3):
            ids = rng.integers(0, problem.n_nodes, 64)
            lv = [ids, rng.integers(0, problem.n_nodes, 640), rng.integers(0, problem.n_nodes, 3200)]
            lv = [torch.as_tensor(a, dtype=torch.int32, device=dev) for a in lv]
            state, m = trainer.train_step(state, graph, lv[0], graph.targets[lv[0].long()],
                                          levels=lv)
            losses[dev].append(float(m["loss"]))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    log(f"  small f32 train steps card {losses['cuda']} vs CPU {losses['cpu']}: ok (rtol 1e-4)")


def phase_main_path(torch, np, problem):
    """Phase 5: the trainer on the full-width store, counters from 0.
    Returns the launch counts and the ms/step."""
    from tpu_sage_torch import kernels
    from tpu_sage_torch.train.trainer import TrainConfig, Trainer, build_model

    cfg = TrainConfig(batch_size=BATCH, n_train_samples=FANOUTS, n_val_samples=FANOUTS,
                      output_dims=DIMS, compute_dtype="bfloat16", lr_init=0.01, epochs=1)
    train_ids = problem.folds["train"]
    model = build_model(cfg, problem.n_nodes, problem.n_classes, problem.feats_dim)
    trainer = Trainer(model, cfg, steps_per_epoch=len(train_ids) // BATCH, task=problem.task)
    graph = problem.device_graph(train=True, dtype=torch.bfloat16, device="cuda")
    state = trainer.init_state(graph)
    perm = np.random.default_rng(5).permutation(train_ids)
    batches = [torch.as_tensor(perm[i * BATCH:(i + 1) * BATCH], dtype=torch.int32, device="cuda")
               for i in range(WARMUP_STEPS + TRAIN_STEPS)]
    for ids in batches[:WARMUP_STEPS]:
        state, _ = trainer.train_step(state, graph, ids, graph.targets[ids.long()])
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = []
    for ids in batches[WARMUP_STEPS:]:
        state, m = trainer.train_step(state, graph, ids, graph.targets[ids.long()])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    train_counts = kernels.launch_counts()
    val_ids = problem.folds["val"][:EVAL_NODES]
    graph_full = problem.device_graph(train=False, dtype=torch.bfloat16, device="cuda")
    val = trainer.evaluate(graph_full, val_ids, problem.store.targets[val_ids],
                           torch.Generator(device="cuda").manual_seed(cfg.seed + 1))
    counts = kernels.launch_counts()

    losses = torch.stack(losses).float().cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses}")
    first, last = losses[:5].mean(), losses[-5:].mean()
    if not last < first:
        raise AssertionError(f"loss did not fall: first 5 steps {first}, last 5 {last}")
    for name, per_step in PER_STEP.items():
        if train_counts[name] != per_step * TRAIN_STEPS:
            raise AssertionError(f"{name}: {train_counts[name]} launches in {TRAIN_STEPS} "
                                 f"steps, expected {per_step} per step")
        if per_step == 0 and counts[name] != 0:
            raise AssertionError(f"{name}: the sampled eval launched it {counts[name]} times")
        if per_step > 0 and counts[name] <= train_counts[name]:
            raise AssertionError(f"{name}: the sampled eval launched it no time")
    if not 0.0 <= val <= 1.0:
        raise AssertionError(f"val accuracy out of range: {val}")
    ms_step = dt / TRAIN_STEPS * 1e3
    edges = BATCH * (FANOUTS[0] + FANOUTS[0] * FANOUTS[1])
    log(f"  {TRAIN_STEPS} steps: loss first-5 mean {first:.4f} -> last-5 mean {last:.4f}; "
        f"sampled val accuracy on {len(val_ids)} nodes {val:.4f}")
    log(f"  launches in {TRAIN_STEPS} train steps {train_counts}; with the eval {counts}")
    log(json.dumps({"main_path": {"ms_per_step": ms_step,
                                  "edges_per_s": edges * TRAIN_STEPS / dt,
                                  "edges_per_step": edges, "steps": TRAIN_STEPS,
                                  "loss_first5": float(first), "loss_last5": float(last),
                                  "val_accuracy": val}}))
    profile_steps(torch, trainer, state, graph, batches[:PROFILE_STEPS], ms_step)
    return counts, ms_step


def phase_main_path_f32(torch, np, problem):
    """Phase 5 (b): the main path's configuration with ``compute_dtype``
    float32, ``TrainConfig``'s default: the f32 table (561 MB), TRAIN_STEPS
    steps with the launch counts from 0 held per step exactly (the main
    path's; ``mean_project`` takes the f32-W kernel twice a step), the loss
    finite and falling, ms/step, device ms/step, busy share and launches per
    step. Returns the launch counts (train and eval)."""
    from tpu_sage_torch.train.trainer import TrainConfig

    cfg = TrainConfig(batch_size=BATCH, n_train_samples=FANOUTS, n_val_samples=FANOUTS,
                      output_dims=DIMS, compute_dtype="float32", lr_init=0.01, epochs=1)
    rec, counts = train_run(torch, np, "main path, f32", problem, cfg, TRAIN_STEPS, WARMUP_STEPS)
    log(json.dumps({"f32_main_path": {k: rec[k] for k in (
        "ms_per_step", "edges_per_s", "device_kernel_ms_per_step", "device_busy_share",
        "kernel_launches_per_step", "launches_per_step", "loss_first", "loss_last",
        "val_accuracy")}}))
    return counts


def device_profile(torch, fn, calls):
    """Device kernel time by name over ``calls`` calls of ``fn`` under
    torch.profiler: ``([(name, ms per call, launches per call)] sorted by
    time, host kernel launches per call)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / calls, e.count // calls)
                      for e in avgs if e.device_type == DeviceType.CUDA
                      and not e.is_user_annotation),  # ranges such as Optimizer.step
                     key=lambda k: -k[1])
    launches = sum(e.count for e in avgs if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                      "cudaLaunchKernelExC")) / calls
    return kernels, launches


def profile_steps(torch, trainer, state, graph, batches, ms_step):
    """Where a step's time goes: device kernel time by name over a few steps
    under torch.profiler, against the unprofiled ms/step above."""
    it = iter(batches)

    def step():
        ids = next(it)
        trainer.train_step(state, graph, ids, graph.targets[ids.long()])

    kernels, launches = device_profile(torch, step, len(batches))
    device_ms = sum(k[1] for k in kernels)
    if device_ms == 0.0:
        log("  profile: the profiler recorded no device time; device busy share not measured")
        return
    log(json.dumps({"step_profile": {
        "steps": len(batches), "device_kernel_ms_per_step": device_ms,
        "unprofiled_ms_per_step": ms_step, "device_busy_share": device_ms / ms_step,
        "kernel_launches_per_step": launches,
        "top_kernels_ms_per_step": [[k[0][:80], k[1], k[2]] for k in kernels[:12]]}}))


def check_exact_card_vs_cpu(torch, np):
    """Phase 6 (a): exact inference on the card against the CPU's plain
    path, f32 and bf16 tables, embeddings and logits (the CPU's logits: its
    embeddings through the same head), on a full-width store and on an SBM
    store with degree-0 nodes and a ragged last chunk."""
    import copy

    from tpu_sage_torch.data.synthetic import bench_store, sbm_store
    from tpu_sage_torch.nn.full_graph import _dense, embed_all_nodes
    from tpu_sage_torch.train.trainer import COMPUTE_DTYPES, TrainConfig, build_model

    sbm = sbm_store(n_nodes=5000, n_classes=7, feat_dim=64, seed=4)
    isolated = np.arange(0, sbm.n_nodes, 97)
    sbm.degrees[isolated] = 0
    sbm.adj[isolated] = isolated[:, None]
    for label, store in ((f"bench_store {CHECK_NODES} x 602, degree 128",
                          bench_store(n_nodes=CHECK_NODES, seed=1, cache_dir="0")),
                         (f"sbm 5,000 x 64, {len(isolated)} degree-0 nodes", sbm)):
        for dtype_name, dtype in COMPUTE_DTYPES.items():
            cfg = TrainConfig(n_train_samples=FANOUTS, n_val_samples=FANOUTS, output_dims=DIMS,
                              compute_dtype=dtype_name)
            model = build_model(cfg, store.n_nodes, store.n_classes, store.feat_dim)
            model.reset_parameters(torch.Generator().manual_seed(6))
            emb = embed_all_nodes(model, store.to_device(train=False, dtype=dtype, device="cpu"),
                                  chunk=EXACT_CHUNK)
            with torch.inference_mode():
                logits = _dense(emb, model.fc.kernel, model.fc.bias)
            card = copy.deepcopy(model).to("cuda")
            graph = store.to_device(train=False, dtype=dtype, device="cuda")
            for what, want, with_head in (("embeddings", emb, False), ("logits", logits, True)):
                got = embed_all_nodes(card, graph, chunk=EXACT_CHUNK, with_head=with_head).cpu()
                limit = EXACT_TOL[dtype_name] * want.abs().max().item()
                err = (got - want).abs().max().item()
                if not (bool(torch.isfinite(got).all()) and err <= limit):
                    raise AssertionError(f"exact {what}, {label}, {dtype_name} table: card vs "
                                         f"CPU max abs err {err} > {limit}")
                log(f"  exact {what:<10} {label}, {dtype_name} table {tuple(got.shape)}: card vs "
                    f"CPU max abs err {err:.3g} (limit {limit:.3g})")


def exact_chunk_ids(torch, graph):
    """``(ids, distinct rows)`` of each exact-inference chunk's masked
    neighbor ids (id -1 past a node's degree)."""
    cols = torch.arange(graph.adj.shape[1], dtype=torch.int32, device=graph.adj.device)
    out = []
    for start in range(0, graph.adj.shape[0], EXACT_CHUNK):
        ids = torch.where(cols < graph.degrees[start:start + EXACT_CHUNK, None],
                          graph.adj[start:start + EXACT_CHUNK], -1).reshape(-1)
        out.append((ids.numel(), int(torch.unique(ids).numel())))
    return out


def time_exact_pass(torch, model, graph, row_bytes, bw):
    """One exact pass (logits) on the card: the median of PASS_REPS host-clock
    runs after a warm-up, nodes/s, the gathers' bound (``row_bytes``: the
    bytes of the row each layer gathers per neighbor; the ids, each distinct
    row read once, each row written) and a profile of one more pass."""
    from tpu_sage_torch.nn.full_graph import embed_all_nodes

    run = lambda: embed_all_nodes(model, graph, chunk=EXACT_CHUNK, with_head=True)  # noqa: E731
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(PASS_REPS):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = sorted(times)[len(times) // 2]
    kern, launches = device_profile(torch, run, 1)
    gather_bytes = sum(4 * q + nd * row + q * row
                       for q, nd in exact_chunk_ids(torch, graph) for row in row_bytes)
    device_ms = sum(k[1] for k in kern)
    return {"ms": ms, "ms_runs": times, "nodes_per_s": graph.adj.shape[0] / ms * 1e3,
            "gather_bound_ms": gather_bytes / bw * 1e3, "device_kernel_ms": device_ms,
            "device_busy_share": device_ms / ms, "kernel_launches": launches,
            "top_kernels_ms": [[k[0][:80], k[1], k[2]] for k in kern[:6]]}


def phase_serving(torch, np, smi, peaks):
    """Phase 6: the serving path. (a) exact inference, card against CPU;
    (b) the CLI trains at full width with checkpoints, exact validation and
    a resume; (c) the exporter writes f16 logits from the best file; (d) the
    launch counts of (b) and of (c), each from 0; (e) the time of an exact
    pass on each table. Returns the launch counts of (b) and (c)."""
    import tempfile

    check_exact_card_vs_cpu(torch, np)
    with tempfile.TemporaryDirectory() as tmp:
        return serving_path(torch, np, smi, peaks, tmp)


def serving_path(torch, np, smi, peaks, tmp):
    """Phase 6 (b)-(e), with the checkpoints and the export in ``tmp``. The
    CLI caches its Reddit-shaped store where ``bench_store`` does by default
    (``build/tpu_sage_torch/bench_cache``), and the exporter loads it there."""
    import os

    from tpu_sage_torch import cli, export, kernels
    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.data.synthetic import bench_store
    from tpu_sage_torch.train.checkpoint import read_best_metric
    from tpu_sage_torch.train.trainer import (COMPUTE_DTYPES, TrainConfig, build_model,
                                              fold_metric_np)

    # (b) train through the CLI: 2 epochs, then resumed to 3
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                          "reddit_mean.json")
    ck, logp = os.path.join(tmp, "model.npz"), os.path.join(tmp, "fit.jsonl")
    argv = ["--config", config, "--synthetic", "reddit-shaped",
            "--synthetic-nodes", str(SERVING_NODES), "--checkpoint-path", ck,
            "--checkpoint-every", "1", "--save-best", "--exact-val", "--val-interval", "100",
            "--log-path", logp]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for epochs in (2, 3):
        if cli.main(argv + ["--epochs", str(epochs)]) != 0:
            raise AssertionError(f"the CLI run to {epochs} epochs failed")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = kernels.launch_counts()
    with open(logp) as f:
        recs = [json.loads(line) for line in f]
    resumed = [i for i, r in enumerate(recs) if "resumed_from" in r]
    if len(resumed) != 1 or recs[resumed[0]]["start_epoch"] != 2:
        raise AssertionError(f"the second CLI run did not resume at epoch 2: {resumed}")
    epochs = [[r["epoch"] for r in part if "elapsed" in r]
              for part in (recs[:resumed[0]], recs[resumed[0]:])]
    vals = [r["val_metric"] for r in recs if "val_metric" in r]
    if epochs != [[0, 1], [2]] or not vals or not all(0.0 <= v <= 1.0 for v in vals):
        raise AssertionError(f"CLI epochs {epochs}, val metrics {vals}")
    for name, n in fit_counts.items():
        if (n == 0) != (PER_STEP[name] == 0):
            raise AssertionError(f"CLI training launched {name} {n} times")
    log(f"  CLI: 2 epochs, then resumed at epoch 2 from {recs[resumed[0]]['resumed_from']!r}; "
        f"exact val metrics {[round(v, 4) for v in vals]}; launches {fit_counts}")

    # (c) export f16 logits from the best file, (d) its launches
    out = os.path.join(tmp, "logits.npy")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    if export.main(["--synthetic", "reddit-shaped", "--synthetic-nodes", str(SERVING_NODES),
                    "--checkpoint", ck, "--out", out, "--checkpoint-config", "--logits",
                    "--out-dtype", "float16"]) != 0:
        raise AssertionError("the export failed")
    export_s = time.perf_counter() - t0
    export_counts = kernels.launch_counts()
    n_chunks = -(-SERVING_NODES // EXACT_CHUNK)
    if export_counts != {**{k: 0 for k in export_counts}, "gather_rows": 2 * n_chunks}:
        raise AssertionError(f"export launches {export_counts}, expected gather_rows "
                             f"2 x {n_chunks} and nothing else")
    arr = np.load(out)
    if arr.shape != (SERVING_NODES, 41) or arr.dtype != np.float16 or not np.isfinite(arr).all():
        raise AssertionError(f"exported logits {arr.shape} {arr.dtype}, finite "
                             f"{bool(np.isfinite(arr).all())}")
    # the exported logits score the val fold as the best epoch's exact
    # validation did (bf16 table there, f32 here, f16 out: a few argmax ties)
    problem = NodeProblem(bench_store(n_nodes=SERVING_NODES, seed=123))
    val_ids = problem.folds["val"]
    acc = fold_metric_np(problem.task, arr[val_ids].astype(np.float32),
                         problem.store.targets[val_ids])
    best = read_best_metric(ck)
    if abs(acc - best) > 0.01:
        raise AssertionError(f"exported logits' val accuracy {acc} vs the best file's {best}")
    log(f"  export {arr.shape} {arr.dtype} in {export_s:.2f} s: val accuracy {acc:.4f} "
        f"(best file {best:.4f}); launches {export_counts}")

    # (e) one exact pass (logits) per table: the export's f32, fit's bf16
    cfg = TrainConfig.from_json(config)
    model = build_model(cfg, problem.n_nodes, problem.n_classes, problem.feats_dim).to("cuda")
    model.reset_parameters(torch.Generator().manual_seed(6))
    passes = {}
    for label, dtype_name in (("export_f32_table", "float32"), ("fit_bf16_table", "bfloat16")):
        graph = problem.device_graph(train=False, dtype=COMPUTE_DTYPES[dtype_name],
                                     device="cuda")
        row = graph.feats.shape[1] * graph.feats.element_size()
        passes[label] = time_exact_pass(torch, model, graph, (row, 2 * DIMS[1] * 4), peaks[0])
    log(smi)
    log(json.dumps({"serving_path": {
        "nodes": problem.n_nodes, "chunk": EXACT_CHUNK, "chunks_per_layer": n_chunks,
        "gather_rows_launches_per_pass": 2 * n_chunks, "exact_pass": passes,
        "export_wall_s": export_s, "cli_fit_wall_s_both_runs": fit_s}}))
    return {"cli_fit": fit_counts, "export": export_counts}


def train_run(torch, np, label, problem, cfg, steps, warmup, csr=False):
    """``steps`` timed ``train_step``s of ``cfg`` on ``problem`` (after
    ``warmup``; ``csr``: on CSR adjacency, ``cfg.feature_int8``: on the int8
    table), the launch counts from 0 checked per step exactly, the loss
    finite and falling, a sampled val metric, and a profile of PROFILE_STEPS
    more steps. Returns the run's record and its launch counts (train and
    eval)."""
    from tpu_sage_torch import kernels
    from tpu_sage_torch.train.trainer import COMPUTE_DTYPES, Trainer, build_model

    b = cfg.batch_size
    train_ids = problem.folds["train"]
    if len(train_ids) < (warmup + steps + PROFILE_STEPS) * b:
        raise AssertionError(f"{label}: train fold too small for the run")
    dtype = COMPUTE_DTYPES[cfg.compute_dtype]
    model = build_model(cfg, problem.n_nodes, problem.n_classes, problem.feats_dim)
    trainer = Trainer(model, cfg, steps_per_epoch=len(train_ids) // b, task=problem.task)
    storage = dict(dtype=dtype, device="cuda", csr=csr, quantize=cfg.feature_int8)
    graph = problem.device_graph(train=True, **storage)
    state = trainer.init_state(graph)
    perm = np.random.default_rng(5).permutation(train_ids)
    batches = [torch.as_tensor(perm[i * b:(i + 1) * b], dtype=torch.int32, device="cuda")
               for i in range(warmup + steps + PROFILE_STEPS)]
    for ids in batches[:warmup]:
        state, _ = trainer.train_step(state, graph, ids, graph.targets[ids.long()])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = []
    for ids in batches[warmup:warmup + steps]:
        state, m = trainer.train_step(state, graph, ids, graph.targets[ids.long()])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    train_counts = kernels.launch_counts()
    want = per_step_launches(cfg.aggregator_class, cfg.prep_class, cfg.fuse_last,
                             int8=cfg.feature_int8, csr=csr, fuse_first=cfg.fuse_first_layer)
    if train_counts != {k: n * steps for k, n in want.items()}:
        raise AssertionError(f"{label}: launches in {steps} steps {train_counts}, expected "
                             f"{want} per step")
    losses = torch.stack(losses).float().cpu().numpy()
    third = max(1, steps // 3)
    first, last = losses[:third].mean(), losses[-third:].mean()
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"{label}: losses {losses} not finite and falling")
    val_ids = problem.folds["val"][:EVAL_NODES]
    val = trainer.evaluate(problem.device_graph(train=False, **storage),
                           val_ids, problem.store.targets[val_ids],
                           torch.Generator(device="cuda").manual_seed(cfg.seed + 1))
    if not 0.0 <= val <= 1.0:
        raise AssertionError(f"{label}: val metric {val}")
    counts = kernels.launch_counts()
    it = iter(batches[warmup + steps:])

    def step():
        ids = next(it)
        trainer.train_step(state, graph, ids, graph.targets[ids.long()])

    kern, launches = device_profile(torch, step, PROFILE_STEPS)
    ms_step = dt / steps * 1e3
    edges = b * (cfg.n_train_samples[0] + cfg.n_train_samples[0] * cfg.n_train_samples[1])
    device_ms = sum(k[1] for k in kern)
    rec = {"run": label, "aggregator": cfg.aggregator_class, "prep": cfg.prep_class,
           "compute_dtype": cfg.compute_dtype, "feature_int8": cfg.feature_int8, "csr": csr,
           "batch": b, "fanouts": list(cfg.n_train_samples),
           "steps": steps, "ms_per_step": ms_step, "edges_per_s": edges * steps / dt,
           "loss_first": float(first), "loss_last": float(last),
           f"val_{'f1' if problem.task == 'multilabel_classification' else 'accuracy'}": val,
           "launches_per_step": want, "device_kernel_ms_per_step": device_ms,
           "device_busy_share": device_ms / ms_step if device_ms else None,
           "kernel_launches_per_step": launches,
           "top_kernels_ms_per_step": [[k[0][:80], k[1], k[2]] for k in kern[:5]]}
    log(json.dumps({"aggregator_run": rec}))
    return rec, counts


def aggregator_config(agg, prep="identity", **kw):
    """The Reddit-width training configuration of phase 5 with another
    aggregator or prep (``agg_hidden_dim`` 512, ``fuse_last="auto"``)."""
    from tpu_sage_torch.train.trainer import TrainConfig

    return TrainConfig(batch_size=BATCH, n_train_samples=FANOUTS, n_val_samples=FANOUTS,
                       output_dims=DIMS, compute_dtype="bfloat16", lr_init=0.01, epochs=1,
                       aggregator_class=agg, prep_class=prep, agg_hidden_dim=AGG_HIDDEN, **kw)


def new_shape_cases(torch, graph, levels, stand_ins, peaks):
    """Phase 7 (a): the kernels at this phase's new shapes, bitwise against
    their plain versions and timed (weight 0: off the main path's step):
    the deepest level gathered whole (q = 128,000 rows of 1,204 bytes); on
    the Pubmed- and PPI-shaped stores, both sampler hops of a batch-256
    tree and its deepest level's gather from the f32 and bf16 tables (rows
    of 2,000 / 1,000 and 200 / 100 bytes); exact inference's gcn layer-1
    rows (f32 128-wide, 512 bytes) and the pools' projected rows (f32
    512-wide, 2,048 bytes) for one 4,096-node chunk; and ``mean_project``
    on the f32 rows of the linear (64 wide) and node-embedding (602 + 64
    wide) preps under a bf16 W, both layer-0 pairings of an unfused tree
    (roots: x (512, 25, D); level 1: x (12,800, 10, D)), within
    MEAN_PROJECT_TOL of its plain version."""
    from tpu_sage_torch.kernels import gather, mean_project, sample_hop

    cases = []

    def add_gather(case, table, ids):
        q, row, ids64 = ids.shape[0], table.shape[1] * table.element_size(), ids.long()
        nd = int(torch.unique(ids).numel())
        cases.append(kernel_case(
            "gather_rows", f"{case} {str(table.dtype)[6:]} {tuple(table.shape)} q={q}",
            lambda t=table, i=ids: gather.gather_rows(t, i, "zero"),
            lambda t=table, i=ids: gather.gather_rows_reference(t, i, "zero"),
            lambda t=table, i=ids64: t[i], 4 * q + nd * row + q * row, weight=0))

    add_gather("deepest level whole", graph.feats, levels[2])
    gen = torch.Generator(device="cuda").manual_seed(17)
    for label in ("Pubmed-shaped", "PPI-shaped"):
        problem = stand_ins[label]
        g = problem.device_graph(train=True, device="cuda")
        ids = torch.as_tensor(problem.folds["train"][:256], dtype=torch.int32, device="cuda")
        for f in FANOUTS:
            u = torch.rand((ids.shape[0], f), generator=gen, device="cuda")
            ids64 = ids.long()
            cols64 = sample_hop.hop_columns(u, g.degrees[ids64].clamp_min(1)).long()
            sectors = int(torch.unique((ids64[:, None] * g.adj.shape[1] + cols64) // 8).numel())
            cases.append(kernel_case(
                "sample_hop", f"{label} ids ({ids.shape[0]},), u {tuple(u.shape)}, "
                f"adj {tuple(g.adj.shape)}",
                lambda i=ids, u=u, g=g: sample_hop.sample_hop(g.adj, g.degrees, i, u),
                lambda i=ids, u=u, g=g: sample_hop.sample_hop_reference(g.adj, g.degrees, i,
                                                                        u),
                lambda i=ids64, c=cols64, g=g: g.adj[i[:, None], c],
                4 * ids.shape[0] + 32 * int(torch.unique(ids64 // 8).numel()) + 32 * sectors
                + 8 * u.numel(), weight=0))
            ids = sample_hop.sample_hop(g.adj, g.degrees, ids, u).reshape(-1)
        for dtype in (torch.float32, torch.bfloat16):
            add_gather(f"{label} deepest level", problem.device_graph(
                train=True, dtype=dtype, device="cuda").feats, ids)
    n = graph.adj.shape[0]
    cols = torch.arange(graph.adj.shape[1], dtype=torch.int32, device="cuda")
    chunk_ids = torch.where(cols < graph.degrees[:EXACT_CHUNK, None],
                            graph.adj[:EXACT_CHUNK], -1).reshape(-1)
    for case, width in (("exact gcn layer 1", DIMS[1]), ("exact pool mlp rows", AGG_HIDDEN)):
        add_gather(case, torch.relu(torch.randn((n, width), generator=gen, device="cuda")),
                   chunk_ids)

    feat_dim = graph.feats.shape[1]
    prep_w = torch.randn((feat_dim, EMBEDDING_DIM), generator=gen, device="cuda") / feat_dim ** 0.5
    for prep in ("linear", "node_embedding"):
        for ids, fanout in ((levels[1], FANOUTS[0]), (levels[2], FANOUTS[1])):
            rows = graph.feats[ids.long()].float()
            emb = torch.randn((ids.shape[0], EMBEDDING_DIM), generator=gen, device="cuda")
            x = (rows @ prep_w if prep == "linear"
                 else torch.cat([rows, emb / EMBEDDING_DIM ** 0.5], 1))
            x = x.view(-1, fanout, x.shape[1])
            del rows, emb
            b, f, d = x.shape
            w = (torch.randn((d, DIMS[0]), generator=gen, device="cuda") / d ** 0.5).to(
                torch.bfloat16)
            cases.append(kernel_case(
                "mean_project", f"{prep} prep x f32 {tuple(x.shape)}, W bf16 {tuple(w.shape)}",
                lambda x=x, w=w: mean_project.mean_project(x, w),
                lambda x=x, w=w: mean_project.mean_project_reference(x, w),
                lambda x=x, w=w: x.mean(1).to(torch.bfloat16) @ w,
                x.numel() * 4 + w.numel() * 2 + b * DIMS[0] * 2,
                flops=2 * b * d * DIMS[0] + b * f * d, peak=peaks[1], tol=MEAN_PROJECT_TOL,
                weight=0))
    return time_cases(torch, cases, peaks[0])


def check_sampled_card_vs_cpu(torch, problem, graph):
    """Phase 7 (b): each new aggregator and prep, bf16, at full width on
    SAMPLED_ROOTS roots' injected levels (sampled on the card), the same
    parameters on the card and on the CPU's plain path: logits within
    SAMPLED_TOL of their scale."""
    import copy

    from tpu_sage_torch.sample.sampler import sample_tree
    from tpu_sage_torch.train.trainer import build_model

    roots = torch.as_tensor(problem.folds["train"][:SAMPLED_ROOTS], dtype=torch.int32,
                            device="cuda")
    levels = sample_tree(graph.adj, graph.degrees, roots, FANOUTS,
                         generator=torch.Generator(device="cuda").manual_seed(21))
    feats_cpu = graph.feats.cpu()
    for agg, prep in [(a, "identity") for a in NEW_AGGREGATORS + ("lstm",)] + [
            ("mean", "linear"), ("mean", "node_embedding")]:
        cfg = aggregator_config(agg, prep)
        model = build_model(cfg, problem.n_nodes, problem.n_classes, problem.feats_dim)
        model.reset_parameters(torch.Generator().manual_seed(11))
        want, got = (
            copy.deepcopy(model).to(feats.device)([l.to(feats.device) for l in levels],
                                                  feats).detach().float().cpu()
            for feats in (feats_cpu, graph.feats))
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        if not (bool(torch.isfinite(got).all()) and err <= SAMPLED_TOL * scale):
            raise AssertionError(f"sampled {agg}/{prep} logits: card vs CPU max abs err {err} "
                                 f"> {SAMPLED_TOL} x {scale}")
        log(f"  sampled {agg}/{prep} bf16 logits {tuple(got.shape)}: card vs CPU max abs err "
            f"{err:.4g} (limit {SAMPLED_TOL * scale:.4g})")


def check_exact_aggregators_card_vs_cpu(torch, np):
    """Phase 7 (c): exact inference of each new aggregator on phase 6's
    CHECK_NODES full-width store, its degrees redrawn in [0, 128] (every
    97th node 0), so columns past a degree are masked and degree-0 nodes
    self-loop; f32 and bf16 tables, logits, card against the CPU's plain
    path within EXACT_TOL."""
    import copy

    from tpu_sage_torch.data.synthetic import bench_store
    from tpu_sage_torch.nn.full_graph import embed_all_nodes
    from tpu_sage_torch.train.trainer import COMPUTE_DTYPES, build_model

    store = bench_store(n_nodes=CHECK_NODES, seed=1, cache_dir="0")
    store.degrees[:] = np.random.default_rng(8).integers(0, store.adj.shape[1] + 1,
                                                         store.n_nodes)
    store.degrees[::97] = 0
    for dtype_name, dtype in COMPUTE_DTYPES.items():
        graphs = {dev: store.to_device(train=False, dtype=dtype, device=dev)
                  for dev in ("cpu", "cuda")}
        for agg in NEW_AGGREGATORS:
            cfg = aggregator_config(agg).replace(compute_dtype=dtype_name)
            model = build_model(cfg, store.n_nodes, store.n_classes, store.feat_dim)
            model.reset_parameters(torch.Generator().manual_seed(6))
            want = embed_all_nodes(model, graphs["cpu"], chunk=EXACT_CHUNK, with_head=True)
            got = embed_all_nodes(copy.deepcopy(model).to("cuda"), graphs["cuda"],
                                  chunk=EXACT_CHUNK, with_head=True).cpu()
            limit = EXACT_TOL[dtype_name] * want.abs().max().item()
            err = (got - want).abs().max().item()
            if not (bool(torch.isfinite(got).all()) and err <= limit):
                raise AssertionError(f"exact {agg} logits, {dtype_name} table: card vs CPU max "
                                     f"abs err {err} > {limit}")
            log(f"  exact {agg:<9} logits {tuple(got.shape)}, {dtype_name} table, degrees "
                f"0-128: card vs CPU max abs err {err:.3g} (limit {limit:.3g})")


def phase_aggregators(torch, np, problem, graph, levels, smi, peaks):
    """Phase 7: the other aggregators and preps. (a) kernels at their new
    shapes; (b) sampled and (c) exact card against CPU; (d) training, with
    the launch counters from 0: gcn, max_pool, mean_pool and attention at
    phase 5's Reddit-width configuration (gcn again on a Reddit-shaped SBM
    store, see REDDIT_SBM), ``configs/pubmed_maxpool.json`` and
    ``configs/ppi_lstm.json`` unchanged on Pubmed- and PPI-shaped SBM
    stores, and the linear and node-embedding preps; (e) the exact pass of
    each new aggregator on the f32 and bf16 tables. Returns the kernel cases,
    the launch counts of (d) and the Reddit-shaped SBM problem (phase 8's)."""
    import os

    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.data.synthetic import sbm_store
    from tpu_sage_torch.train.trainer import COMPUTE_DTYPES, TrainConfig, build_model

    t0 = time.perf_counter()
    stand_ins = {"Pubmed-shaped": NodeProblem(sbm_store(**PUBMED)),
                 "PPI-shaped": NodeProblem(sbm_store(**PPI)),
                 "Reddit-shaped SBM": NodeProblem(sbm_store(**REDDIT_SBM))}
    log(f"  SBM stand-ins built in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {p.store.feats.shape}, {p.n_classes} {p.task} targets, max degree "
                    f"{p.store.adj.shape[1]}" for k, p in stand_ins.items()))
    results = new_shape_cases(torch, graph, levels, stand_ins, peaks)
    check_sampled_card_vs_cpu(torch, problem, graph)
    check_exact_aggregators_card_vs_cpu(torch, np)

    total = {}

    def run(label, prob, cfg, steps, warmup=WARMUP_STEPS):
        rec, counts = train_run(torch, np, label, prob, cfg, steps, warmup)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return rec

    runs = [run(f"{agg} on bench_store", problem, aggregator_config(agg), AGG_STEPS)
            for agg in NEW_AGGREGATORS]
    runs.append(run("gcn on Reddit-shaped SBM", stand_ins["Reddit-shaped SBM"],
                    aggregator_config("gcn"), AGG_STEPS))
    here = os.path.dirname(os.path.abspath(__file__))
    for preset, label in (("pubmed_maxpool.json", "Pubmed-shaped"), ("ppi_lstm.json",
                                                                     "PPI-shaped")):
        cfg = TrainConfig.from_json(os.path.join(here, "configs", preset))
        runs.append(run(f"{preset} on {label}", stand_ins[label], cfg, PRESET_STEPS))
    for prep in ("linear", "node_embedding"):
        runs.append(run(f"mean/{prep}", problem, aggregator_config("mean", prep), PREP_STEPS,
                        warmup=2))

    passes = {}
    for agg in NEW_AGGREGATORS:
        for dtype_name, dtype in COMPUTE_DTYPES.items():
            g = problem.device_graph(train=False, dtype=dtype, device="cuda")
            cfg = aggregator_config(agg).replace(compute_dtype=dtype_name)
            model = build_model(cfg, problem.n_nodes, problem.n_classes, problem.feats_dim)
            model.reset_parameters(torch.Generator().manual_seed(6))
            feat_row = g.feats.shape[1] * g.feats.element_size()
            row_bytes = {"gcn": (feat_row, DIMS[0] * 4),
                         "attention": (feat_row, 2 * DIMS[0] * 4)}.get(
                             agg, (AGG_HIDDEN * 4, AGG_HIDDEN * 4))
            passes[f"{agg}_{dtype_name}"] = time_exact_pass(torch, model.to("cuda"), g,
                                                            row_bytes, peaks[0])
    log(smi)
    log(json.dumps({"aggregators": {"runs": runs, "exact_pass": passes,
                                    "nodes": problem.n_nodes, "chunk": EXACT_CHUNK}}))
    return results, total, stand_ins["Reddit-shaped SBM"]


def storage_cases(torch, np, problem, graph, levels, sbm, peaks):
    """Phase 8 (a): the int8 fanout mean, the int8 rows' gathers and the CSR
    hop against their plain versions, bitwise, at the main path's shapes,
    timed (kernel, plain, library, bound); the window-pair composition (``gather_rows`` ×4 and
    ``select_columns``) against the fused CSR hop; and edge cases: fanouts
    above 32 for both fanout means, degree-0 and tail nodes, out-of-range
    ids, CSR indices without window padding. Returns the timed cases and the
    window pair's launch counts."""
    from tpu_sage_torch import kernels
    from tpu_sage_torch.kernels import gather, gather_mean, sample_hop
    from tpu_sage_torch.sample.csr import csr_from_padded, window_pair_hop

    bw, _, f32_peak = peaks
    cases = []
    gen = torch.Generator(device="cuda").manual_seed(23)

    def distinct(t):
        return int(torch.unique(t).numel())

    # int8 fanout mean at the deepest level: 128,000 ids, F = 10, 602 columns
    qf = problem.device_graph(train=True, dtype=torch.bfloat16, device="cuda",
                              quantize=True).feats
    q, scale = qf.q, qf.scale
    l2 = levels[2]
    f = FANOUTS[1]
    r, d = l2.shape[0] // f, q.shape[1]
    l2_64 = l2.long()
    nd = distinct(l2)
    c = scale * gather_mean.reciprocal(f)
    for dtype in (torch.bfloat16, torch.float32):
        for summean in (True, False):
            if summean:
                lib = lambda dt=dtype: (q[l2_64].view(r, f, d).to(torch.int32).sum(1).float()
                                        * c).to(dt)
            else:
                lib = lambda dt=dtype: (q[l2_64] * scale.to(dt)).float().view(r, f, d).mean(
                    1).to(dt)
            out_bytes = 2 if dtype == torch.bfloat16 else 4
            cases.append(kernel_case(
                "gather_fanout_mean_int8",
                f"int8 {tuple(q.shape)} ids={l2.shape[0]} F={f} -> {str(dtype)[6:]}, "
                f"{'int32 sum' if summean else 'dequantize then mean'}",
                lambda dt=dtype, sm=summean: gather_mean.gather_fanout_mean_int8(q, scale, l2, f,
                                                                                 dt, sm),
                lambda dt=dtype, sm=summean: gather_mean.gather_fanout_mean_int8_reference(
                    q, scale, l2, f, dt, sm),
                lib, 4 * l2.shape[0] + nd * d + r * d * out_bytes + 4 * d,
                flops=l2.shape[0] * d * (1 if summean else 2), peak=f32_peak,
                weight=int(dtype == torch.bfloat16 and summean),
                floor_bytes=4 * l2.shape[0] + l2.shape[0] * d + r * d * out_bytes))

    # gather_rows on the int8 step's rows: levels 0 and 1 of the int8 table,
    # 602-byte rows (weight 0: the kernel's step weight is the main path's)
    for ids in levels[:2]:
        n_ids = ids.shape[0]
        cases.append(kernel_case(
            "gather_rows", f"int8 rows {tuple(q.shape)} q={n_ids}",
            lambda i=ids: gather.gather_rows(q, i), lambda i=ids: gather.gather_rows_reference(q, i),
            lambda i=ids.long(): q[i], 4 * n_ids + distinct(ids) * d + n_ids * d, weight=0))

    # the CSR hop on bench_store's CSR (hop 1: 512 ids x 25, hop 2: 12,800 x
    # 10) and on the Reddit-shaped SBM store's, window form (the padded
    # indices the trainer uploads). Bytes: the ids, each distinct 32-byte
    # sector of degrees and of indptr, the distinct 32-byte sectors of
    # indices the picks hit, u and out. The library yardstick is one indexed
    # load with the columns and the degree-0 select precomputed. Then the
    # same tree in one csr_tree launch (the CSR step's sampler), from the
    # same uniforms, bitwise the hops' levels; its bytes are the hops' but
    # for the levels the hops wrote and read back (only the roots are read);
    # no one PyTorch call computes a tree, so it has no library yardstick.
    # The timed call returns the launch's deepest level as it is (every
    # level is held bitwise against the hops first).
    window_counts = {}
    for label, prob, roots, weight in (("bench_store", problem, levels[0], 1),
                                       ("Reddit-shaped SBM", sbm, None, 0)):
        g = prob.device_graph(train=True, dtype=torch.bfloat16, device="cuda", csr=True)
        if roots is None:
            roots = torch.as_tensor(prob.folds["train"][:BATCH], dtype=torch.int32,
                                    device="cuda")
        ids, us, hop_levels, tree_bytes = roots, [], [], 4 * roots.shape[0]
        for hop, fo in enumerate(FANOUTS):
            u = torch.rand((ids.shape[0], fo), generator=gen, device="cuda")
            ids64 = ids.long()
            deg = g.degrees[ids64]
            cols = sample_hop.hop_columns(u, deg.clamp_min(1)).long()
            pos = g.indptr[ids64].long()[:, None] + cols
            live = (deg > 0)[:, None].expand_as(pos)
            nbytes = (4 * ids.shape[0] + 2 * 32 * distinct(ids64 // 8)
                      + 32 * distinct(pos[live] // 8) + 8 * u.numel())
            tree_bytes += nbytes - 4 * ids.shape[0]
            us.append(u)
            cases.append(kernel_case(
                "sample_hop_csr", f"{label} hop {hop + 1}: ids ({ids.shape[0]},), u "
                f"{tuple(u.shape)}, indices ({g.indices.shape[0]},), window {g.window}",
                lambda i=ids, u=u, g=g: sample_hop.sample_hop_csr(g.indptr, g.indices,
                                                                  g.degrees, i, u),
                lambda i=ids, u=u, g=g: sample_hop.sample_hop_csr_reference(
                    g.indptr, g.indices, g.degrees, i, u),
                lambda i=ids, p=pos, dg=deg, g=g: torch.where(
                    dg[:, None] == 0, i[:, None], g.indices[p]),
                nbytes, weight=weight))
            fused = sample_hop.sample_hop_csr(g.indptr, g.indices, g.degrees, ids, u)
            kernels.reset_launch_counts()
            pair = window_pair_hop(g.indptr, g.indices, g.degrees, ids, u, g.window)
            torch.cuda.synchronize()
            for k, v in kernels.launch_counts().items():
                window_counts[k] = window_counts.get(k, 0) + v
            if not torch.equal(pair, fused):
                raise AssertionError(f"{label} hop {hop + 1}: the window-pair composition "
                                     f"differs from the fused CSR hop")
            ids = fused.reshape(-1)
            hop_levels.append(ids)
        tree = sample_hop.csr_tree(g.indptr, g.indices, g.degrees, roots, us)
        if not all(torch.equal(a, b) for a, b in zip(tree, hop_levels)):
            raise AssertionError(f"{label}: the one-launch CSR tree differs from its hops")
        cases.append(kernel_case(
            "csr_tree", f"{label} tree: roots ({roots.shape[0]},), fanouts {FANOUTS}, indices "
            f"({g.indices.shape[0]},), window {g.window}",
            lambda r=roots, us=us, g=g: sample_hop.csr_tree(
                g.indptr, g.indices, g.degrees, r, us)[-1],
            lambda r=roots, us=us, g=g: sample_hop.csr_tree_reference(
                g.indptr, g.indices, g.degrees, r, us)[-1],
            None, tree_bytes, weight=weight))
    results = time_cases(torch, cases, bw)

    # edge cases: the int8 mean's (check_int8_mean_edges), fanouts above 32
    # for the dense mean, CSR rows of degree 0 (the tail node's start is nnz
    # when indices carry no padding), ids out of range, u = 0 and u one ulp
    # below 1
    check_int8_mean_edges(torch, gather_mean, q, scale, gen)
    for fo in (33, 40):
        ids = torch.randint(0, q.shape[0], (300 * fo,), generator=gen, device="cuda",
                            dtype=torch.int32)
        if not torch.equal(gather_mean.gather_fanout_mean(graph.feats, ids, fo),
                           gather_mean.gather_fanout_mean_reference(graph.feats, ids, fo)):
            raise AssertionError(f"gather_fanout_mean F={fo} differs from its plain version")
    n, maxd = 50_000, 128
    deg = torch.randint(0, maxd + 1, (n,), generator=gen, device="cuda", dtype=torch.int32)
    deg[::97], deg[-3:] = 0, 0
    adj = torch.randint(0, n, (n, maxd), generator=gen, device="cuda", dtype=torch.int32)
    indptr, indices = (torch.as_tensor(a, device="cuda")
                       for a in csr_from_padded(adj.cpu().numpy(), deg.cpu().numpy()))
    ids = torch.cat([torch.tensor([n - 1, n - 2, n - 4, -1, -n - 3, n, n + 5], device="cuda",
                                  dtype=torch.int32),
                     torch.randint(0, n, (4089,), generator=gen, device="cuda",
                                   dtype=torch.int32)])
    u = torch.rand((ids.shape[0], 25), generator=gen, device="cuda")
    u[:, 0], u[:, 1] = 0.0, 1.0 - 2.0 ** -24
    if not torch.equal(sample_hop.sample_hop_csr(indptr, indices, deg, ids, u),
                       sample_hop.sample_hop_csr_reference(indptr, indices, deg, ids, u)):
        raise AssertionError("sample_hop_csr differs from its plain version at its edge cases")
    check_csr_tree_edges(torch, sample_hop, gen, indptr, indices, deg, ids)
    torch.cuda.synchronize()
    log("  fanouts 33 and 40 (the dense fanout mean, bitwise), the CSR hop and the CSR tree at "
        "degree 0, tail rows with and without window padding, ids out of range, u at 0 and "
        "one ulp below 1, ragged B, trees of 1-5 hops and walks of 1-4 and 6: ok; "
        f"window-pair composition bitwise the fused CSR hop, launches {window_counts}")
    return results, window_counts


def check_int8_mean_edges(torch, gather_mean, q, scale, gen):
    """gather_fanout_mean_int8 bitwise against its plain version in its four
    modes where no path's shapes go: fanouts 1, 33, 40, 257, 258 and 300 on
    the step's 602-wide table (the packed sums fold every 256 rows); widths
    601, 603, 16 and 608 (odd widths store one column at a time, narrow rows
    share a warp); 602- and 601-wide tables whose base lies 1-15 bytes past
    16-byte alignment, with ids naming their first and last rows (the last
    row ends where the table does, off 16-byte alignment) and ids out of
    range (-1, -n - 1, n, n + 7: the plain form wraps once, then clamps);
    every byte at -128 and at 127 over 256, 257 and 300 rows (the packed
    lanes' extremes); scales down to bf16 subnormals and up to 2.5e35 (the
    bf16 product rounds once, as the plain version's f32 product then its
    rounding do; no sum overflows)."""
    modes = [(dt, sm) for dt in (torch.bfloat16, torch.float32) for sm in (True, False)]

    def check(label, table, sc, ids, fo):
        for dt, sm in modes:
            got = gather_mean.gather_fanout_mean_int8(table, sc, ids, fo, dt, sm)
            want = gather_mean.gather_fanout_mean_int8_reference(table, sc, ids, fo, dt, sm)
            if not torch.equal(got, want):
                raise AssertionError(f"gather_fanout_mean_int8 {label} F={fo} {dt} summean={sm} "
                                     f"differs from its plain version")

    def rand_ids(n, count):
        return torch.randint(0, n, (count,), generator=gen, device="cuda", dtype=torch.int32)

    n = q.shape[0]
    for fo in (1, 33, 40, 257, 258, 300):
        check("602 wide", q, scale, rand_ids(n, 64 * fo), fo)
    for width in (601, 603, 16, 608):
        t = torch.randint(-128, 128, (4096, width), generator=gen, device="cuda",
                          dtype=torch.int8)
        sc = torch.rand((width,), generator=gen, device="cuda") * 0.05 + 1e-4
        for fo in (10, 300):
            check(f"{width} wide", t, sc, rand_ids(4096, 37 * fo), fo)
    m = 2048
    for width in (602, 601):
        buf = torch.randint(-128, 128, (m * width + 32,), generator=gen, device="cuda",
                            dtype=torch.int8)
        sc = torch.rand((width,), generator=gen, device="cuda") * 0.05 + 1e-4
        edge = torch.tensor([0, m - 1, -1, -m - 1, m, m + 7, m - 1, 0, 1, m - 2], device="cuda",
                            dtype=torch.int32)
        for off in range(16):
            base = (16 - buf.data_ptr() % 16 + off) % 16
            t = buf[base:base + m * width].view(m, width)
            check(f"{width} wide at +{off} B", t, sc, torch.cat([edge, rand_ids(m, 390)]), 10)
    for val in (-128, 127):
        t = torch.full((512, 602), val, device="cuda", dtype=torch.int8)
        for fo in (256, 257, 300):
            check(f"every byte {val}", t, scale, rand_ids(512, 9 * fo), fo)
    sc = torch.tensor([2.0 ** -133, 2.0 ** -130, 1e-38, 3e-39, 1e35, 2.5e35, 0.0, -0.75],
                      device="cuda").repeat(602 // 8 + 1)[:602].contiguous()
    check("extreme scales", q, sc, rand_ids(n, 200 * 10), 10)
    torch.cuda.synchronize()
    log("  gather_fanout_mean_int8, four modes bitwise: fanouts 1, 33, 40, 257, 258, 300; widths "
        "601, 603, 16, 608; bases 0-15 B past 16-byte alignment with the last row and ids out "
        "of range; bytes all -128 and all 127 over 256-300 rows; extreme scales: ok")


def check_csr_tree_edges(torch, sample_hop, gen, indptr, indices, deg, ids):
    """csr_tree bitwise against its plain version where no path's trees go,
    on a CSR graph whose degrees are 0-128 (every 97th and the last three
    0: the tail's row start is nnz): indices without window padding (the
    last row ends at n_indices) and with it, roots out of range and negative
    (their self-loop keeps them), u at 0 and one ulp below 1, ragged B (1,
    37 and 4,096 roots), trees of 1, 2 and 5 hops (a deeper tree launches
    again from its fourth level), walks (fanout 1) of 1-4 and 6 hops with
    only the last level kept; each with its launches counted."""
    from tpu_sage_torch import kernels
    from tpu_sage_torch.sample.csr import pad_indices_for_window

    padded = torch.as_tensor(pad_indices_for_window(indices.cpu().numpy(), 128), device="cuda")
    for idx in (indices, padded):
        for roots, fanouts, last in ((ids, (25, 10), False), (ids[:37], (10,), False),
                                     (ids[:1], (3, 2, 2, 2, 2), False),
                                     (ids[:37], (3, 2, 2, 2, 2), True),
                                     *((ids, (1,) * h, True) for h in (1, 2, 3, 4, 6))):
            us, q = [], roots.shape[0]
            for f in fanouts:
                u = torch.rand((q, f), generator=gen, device="cuda")
                u[: q // 7, 0], u[q // 7: 2 * q // 7, 0] = 0.0, 1.0 - 2.0 ** -24
                us.append(u)
                q *= f
            kernels.reset_launch_counts()
            got = sample_hop.csr_tree(indptr, idx, deg, roots, us, last_only=last)
            launches = kernels.launch_counts()["csr_tree"]
            want = sample_hop.csr_tree_reference(indptr, idx, deg, roots, us, last_only=last)
            if (len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want))
                    or launches != -(-len(fanouts) // sample_hop.TREE_HOPS)):
                raise AssertionError(f"csr_tree differs from its plain version: roots "
                                     f"{roots.shape[0]}, fanouts {fanouts}, last only {last}, "
                                     f"indices ({idx.shape[0]},), {launches} launches")


def check_storage_trees(torch, problem, sbm):
    """Phase 8 (b): at full width, one generator state, the CSR tree (window
    and element hops) equals the dense tree bitwise, each with its own
    launch counts, on bench_store and on the Reddit-shaped SBM store."""
    from tpu_sage_torch import kernels
    from tpu_sage_torch.sample.csr import graph_sample_tree

    for label, prob in (("bench_store", problem), ("Reddit-shaped SBM", sbm)):
        roots = torch.as_tensor(prob.folds["train"][:BATCH], dtype=torch.int32, device="cuda")
        dense = prob.device_graph(train=True, dtype=torch.bfloat16, device="cuda")
        csr_graph = prob.device_graph(train=True, dtype=torch.bfloat16, device="cuda", csr=True)
        trees, counts = [], []
        for g, window in ((dense, None), (csr_graph, csr_graph.window), (csr_graph, 0)):
            saved = csr_graph.window
            if window is not None:
                csr_graph.window = window
            kernels.reset_launch_counts()
            trees.append(graph_sample_tree(g, roots, FANOUTS,
                                           generator=torch.Generator(device="cuda").manual_seed(3)))
            torch.cuda.synchronize()
            csr_graph.window = saved
            counts.append({k: v for k, v in kernels.launch_counts().items() if v})
        if counts != [{"sample_hop": 2}, {"csr_tree": 1}, {"csr_tree": 1}]:
            raise AssertionError(f"{label}: tree launch counts {counts}")
        for t in trees[1:]:
            for level, (a, b) in enumerate(zip(trees[0], t)):
                if not torch.equal(a, b):
                    raise AssertionError(f"{label}: the CSR tree differs from the dense tree "
                                         f"at level {level}")
        log(f"  {label}: CSR trees (window {csr_graph.window}, element) "
            f"{[tuple(t.shape) for t in trees[1]]} bitwise the dense tree; launches per tree "
            f"{counts}")


def check_int8_sampled_card_vs_cpu(torch):
    """Phase 8 (d): sampled bf16 logits of the int8 mean model (both
    ``int8_summean`` modes) on a CHECK_NODES full-width store, the same
    parameters and levels on the card and on the CPU's plain path, within
    SAMPLED_TOL of their scale."""
    import copy

    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.data.synthetic import bench_store
    from tpu_sage_torch.sample.sampler import sample_tree
    from tpu_sage_torch.train.trainer import build_model

    problem = NodeProblem(bench_store(n_nodes=CHECK_NODES, seed=1, cache_dir="0"))
    dense = problem.device_graph(train=True, dtype=torch.bfloat16, device="cuda")
    roots = torch.as_tensor(problem.folds["train"][:SAMPLED_ROOTS], dtype=torch.int32,
                            device="cuda")
    levels = sample_tree(dense.adj, dense.degrees, roots, FANOUTS,
                         generator=torch.Generator(device="cuda").manual_seed(29))
    for summean in (True, False):
        cfg = aggregator_config("mean", feature_int8=True, int8_summean=summean)
        model = build_model(cfg, problem.n_nodes, problem.n_classes, problem.feats_dim)
        model.reset_parameters(torch.Generator().manual_seed(11))
        want, got = (
            copy.deepcopy(model).to(dev)(
                [l.to(dev) for l in levels],
                problem.device_graph(train=True, dtype=torch.bfloat16, device=dev,
                                     quantize=True).feats).detach().float().cpu()
            for dev in ("cpu", "cuda"))
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        if not (bool(torch.isfinite(got).all()) and err <= SAMPLED_TOL * scale):
            raise AssertionError(f"int8 sampled logits (int8_summean={summean}): card vs CPU "
                                 f"max abs err {err} > {SAMPLED_TOL} x {scale}")
        log(f"  int8 mean model, int8_summean={summean}, bf16 logits {tuple(got.shape)}: card "
            f"vs CPU max abs err {err:.4g} (limit {SAMPLED_TOL * scale:.4g})")


def storage_quality(torch, np, sbm):
    """Phase 8 (e): ``assortative_bench_store()`` (232,965 × 602, 41
    classes, the label signal in the edges) trained by ``fit`` at the main
    path's configuration, bf16 and int8 tables, with exact validation,
    QUALITY_EPOCHS each; the resident table bytes of both, and the
    adjacency bytes of dense against CSR on the Reddit-shaped SBM store."""
    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.data.synthetic import assortative_bench_store
    from tpu_sage_torch.train.trainer import TrainConfig, fit

    t0 = time.perf_counter()
    problem = NodeProblem(assortative_bench_store())
    build_s = time.perf_counter() - t0
    runs = {}
    for label, int8 in (("bf16", False), ("int8", True)):
        cfg = TrainConfig(batch_size=BATCH, n_train_samples=FANOUTS, n_val_samples=FANOUTS,
                          output_dims=DIMS, compute_dtype="bfloat16", lr_init=0.01,
                          epochs=QUALITY_EPOCHS, exact_val=True, feature_int8=int8)
        recs = []
        t0 = time.perf_counter()
        fit(problem, cfg, log=recs.append, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        epochs = [r for r in recs if "elapsed" in r]
        vals = [r["val_metric"] for r in epochs]
        losses = [r["train_loss"] for r in epochs]
        test = [r["final_test_metric"] for r in recs if "final_test_metric" in r]
        if not (len(vals) == QUALITY_EPOCHS and np.isfinite(losses).all()
                and losses[-1] < losses[0] and all(0.0 <= v <= 1.0 for v in vals) and test):
            raise AssertionError(f"quality run {label}: losses {losses}, val {vals}")
        feats = problem.device_graph(train=True, dtype=torch.bfloat16, device="cuda",
                                     quantize=int8).feats
        runs[label] = {"val_metric": vals, "train_loss": losses, "test_metric": test[0],
                       "epoch_s": [r["elapsed"] for r in epochs], "wall_s": wall,
                       "table_bytes": (feats.nbytes if int8
                                       else feats.numel() * feats.element_size())}
    dense = sbm.device_graph(train=False, dtype=torch.bfloat16, device="cuda")
    csr_graph = sbm.device_graph(train=False, dtype=torch.bfloat16, device="cuda", csr=True)
    adjacency = {"dense_bytes": dense.adj.numel() * 4 + dense.degrees.numel() * 4,
                 "csr_bytes": 4 * (csr_graph.indptr.numel() + csr_graph.indices.numel()
                                   + csr_graph.degrees.numel()),
                 "nnz": int(csr_graph.indptr[-1]), "window": csr_graph.window}
    log(json.dumps({"storage_quality": {"store": "assortative_bench_store()",
                                        "store_build_s": build_s, "runs": runs,
                                        "sbm_full_graph_adjacency": adjacency}}))


def storage_cli(torch):
    """Phase 8 (f): ``tpu_sage_torch.cli.main`` with ``--feature-int8
    --csr-adjacency`` for one epoch on the 232,965-node Reddit-shaped store
    at the main path's configuration (sampled validation on the CSR full
    graph); its launch counts from 0, which must include both new kernels
    and neither dense counterpart."""
    from tpu_sage_torch import cli, kernels

    argv = ["--synthetic", "reddit-shaped", "--synthetic-nodes", str(SERVING_NODES),
            "--feature-int8", "--csr-adjacency", "--compute-dtype", "bfloat16",
            "--batch-size", str(BATCH), "--n-train-samples", "25,10", "--n-val-samples",
            "25,10", "--output-dims", "128,128", "--epochs", "1"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise AssertionError("the CLI run with --feature-int8 --csr-adjacency failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    if not (counts["gather_fanout_mean_int8"] > 0 and counts["csr_tree"] > 0
            and counts["gather_fanout_mean"] == 0 and counts["sample_hop"] == 0):
        raise AssertionError(f"CLI --feature-int8 --csr-adjacency launches {counts}")
    log(f"  CLI --feature-int8 --csr-adjacency, 1 epoch at {SERVING_NODES} nodes in "
        f"{wall:.1f} s; launches {counts}")
    return counts


def phase_storage(torch, np, problem, graph, levels, sbm, smi, peaks):
    """Phase 8: int8 feature storage and CSR adjacency. (a) the two new
    kernels against their plain versions; (b) CSR trees against dense
    trees; (c) the main path's configuration for STORAGE_STEPS timed steps
    with feature_int8, CSR and both, launch counts exact; (d) int8 card
    against CPU; (e) quality on the assortative store, bf16 against int8;
    (f) the CLI with both flags. Returns the timed cases and the launch
    counts of (a)'s window pair, (c) and (f)."""
    from tpu_sage_torch.train.trainer import TrainConfig

    results, window_counts = storage_cases(torch, np, problem, graph, levels, sbm, peaks)
    check_storage_trees(torch, problem, sbm)
    by_path = {"storage_window_pair": window_counts}
    runs = []
    for label, int8, csr in (("feature_int8", True, False), ("csr", False, True),
                             ("feature_int8 + csr", True, True)):
        cfg = TrainConfig(batch_size=BATCH, n_train_samples=FANOUTS, n_val_samples=FANOUTS,
                          output_dims=DIMS, compute_dtype="bfloat16", lr_init=0.01, epochs=1,
                          feature_int8=int8)
        rec, counts = train_run(torch, np, f"main path, {label}", problem, cfg, STORAGE_STEPS,
                                WARMUP_STEPS, csr=csr)
        runs.append(rec)
        by_path[f"storage_train_{label.replace(' + ', '_')}"] = counts
    check_int8_sampled_card_vs_cpu(torch)
    storage_quality(torch, np, sbm)
    by_path["storage_cli"] = storage_cli(torch)
    log(smi)
    log(json.dumps({"storage": {"runs": runs}}))
    return results, by_path


def unsup_per_step(csr=False, corpus=False, int8=False):
    """Kernel launches of one NCE step at phase 9's configuration: the walk's
    WALK_LENGTH hops at fanout 1 (none with a corpus) and the tree's 2 hops
    (``sample_hop``; on CSR adjacency one ``csr_tree`` for the walk and one
    for the tree); the tree's levels 0 and 1 gathered and the corpus rows
    (``gather_rows``; of int8 rows on an int8 table, the scale applied by
    PyTorch); the deepest level's ``gather_fanout_mean`` (its int8 entry
    on an int8 table); 2 ``mean_project``."""
    hops = 2 + (0 if corpus else WALK_LENGTH)
    return {"select_columns": 0, "select_hop": 0, "sample_hop": 0 if csr else hops,
            "gather_rows": 2 + int(corpus), "gather_rows_blockspec": 0,
            "gather_fanout_mean": int(not int8), "mean_project": 2,
            "gather_fanout_mean_int8": int(int8),
            "sample_hop_csr": 0, "csr_tree": (1 + int(not corpus)) if csr else 0,
            "gather_fanout_mean_owned": 0}


def unsup_config(**kw):
    """``scripts/bench_unsup.py:20-24``: ``bench_store()``, mean/identity,
    batch 512, fanouts (25, 10), dims (128, 128), bf16 (lr 0.01)."""
    from tpu_sage_torch.train.trainer import TrainConfig

    return TrainConfig(batch_size=BATCH, n_train_samples=FANOUTS, n_val_samples=FANOUTS,
                       output_dims=DIMS, compute_dtype="bfloat16", lr_init=0.01, epochs=1,
                       **kw)


def unsup_new_shape_cases(torch, graph, csr_graph, qf, peaks):
    """Phase 9 (a): the kernels at the shapes of this phase's paths, against
    their plain versions (bitwise; ``mean_project`` within
    MEAN_PROJECT_TOL) and timed (weight 0: off the main path's step). The
    NCE tree of 512 · (2 + 10) = 6,144 roots: the walk hop (512 × 1, dense
    and CSR), the CSR walk and the CSR NCE tree each in one ``csr_tree``
    launch, the tree's hops (6,144 × 25; 153,600 × 10), its levels 0 and 1
    gathered (6,144 and 153,600 rows of 1,204 bytes), the deepest fanout
    mean (153,600 roots × 10 × 602) of the bf16 table and, as the int8 NCE
    step has it, of the int8 table ``qf`` (bf16 out, int32 sum), and both
    layers' ``mean_project``
    ((6,144, 25, 602), (6,144, 25, 256)); the corpus rows (int32, 512 × 16);
    the fused first layer's gathers of the projected (232,965 × 128) bf16
    table (512 and 12,800 rows), its fanout means there (512 × 25,
    12,800 × 10) and its backward's raw rows at the deepest level (128,000;
    its 512 and 12,800 rows are phase 3's feature gathers)."""
    from tpu_sage_torch.kernels import gather, gather_mean, mean_project, sample_hop
    from tpu_sage_torch.sample.sampler import sample_tree

    bw, bf16_peak, f32_peak = peaks
    feats, adj, deg = graph.feats, graph.adj, graph.degrees
    n, max_degree = adj.shape
    gen = torch.Generator(device="cuda").manual_seed(41)
    cases = []

    def distinct(t):
        return int(torch.unique(t).numel())

    def add_gather(case, table, ids):
        q, row, ids64 = ids.shape[0], table.shape[1] * table.element_size(), ids.long()
        cases.append(kernel_case(
            "gather_rows", f"{case} {str(table.dtype)[6:]} {tuple(table.shape)} q={q}",
            lambda t=table, i=ids: gather.gather_rows(t, i),
            lambda t=table, i=ids: gather.gather_rows_reference(t, i),
            lambda t=table, i=ids64: t[i], 4 * q + distinct(ids) * row + q * row, weight=0))

    def add_hop(case, ids, f):
        u = torch.rand((ids.shape[0], f), generator=gen, device="cuda")
        ids64 = ids.long()
        cols64 = sample_hop.hop_columns(u, deg[ids64].clamp_min(1)).long()
        cases.append(kernel_case(
            "sample_hop", f"{case}: ids ({ids.shape[0]},), u {tuple(u.shape)}",
            lambda i=ids, u=u: sample_hop.sample_hop(adj, deg, i, u),
            lambda i=ids, u=u: sample_hop.sample_hop_reference(adj, deg, i, u),
            lambda i=ids64, c=cols64: adj[i[:, None], c],
            4 * ids.shape[0] + 32 * distinct(ids64 // 8)
            + 32 * distinct((ids64[:, None] * max_degree + cols64) // 8) + 8 * u.numel(),
            weight=0))

    anchors = torch.randint(0, n, (BATCH,), generator=gen, device="cuda", dtype=torch.int32)
    add_hop("walk hop", anchors, 1)
    u = torch.rand((BATCH, 1), generator=gen, device="cuda")
    g = csr_graph
    pos = g.indptr[anchors.long()].long()[:, None] + sample_hop.hop_columns(
        u, g.degrees[anchors.long()].clamp_min(1)).long()
    cases.append(kernel_case(
        "sample_hop_csr", f"walk hop: ids ({BATCH},), u {tuple(u.shape)}, indices "
        f"({g.indices.shape[0]},), window {g.window}",
        lambda: sample_hop.sample_hop_csr(g.indptr, g.indices, g.degrees, anchors, u),
        lambda: sample_hop.sample_hop_csr_reference(g.indptr, g.indices, g.degrees, anchors, u),
        lambda: torch.where(g.degrees[anchors.long()][:, None] == 0, anchors[:, None],
                            g.indices[pos]),
        4 * BATCH + 2 * 32 * distinct(anchors.long() // 8) + 32 * distinct(pos // 8)
        + 8 * u.numel(), weight=0))
    roots = torch.randint(0, n, (BATCH * (2 + N_NEGATIVES),), generator=gen, device="cuda",
                          dtype=torch.int32)
    # the CSR step's two sampler launches: the walk (WALK_LENGTH hops from
    # 512 anchors, only the last level kept) and the NCE tree (6,144 roots,
    # fanouts (25, 10)), one csr_tree each. Bytes: the roots, every hop's u,
    # the distinct 32-byte sectors of degrees and indptr a hop's frontier
    # reads and of indices its picks hit, the kept levels written.
    for label, r_ids, fos, last in (("walk", anchors, (1,) * WALK_LENGTH, True),
                                    ("NCE tree", roots, FANOUTS, False)):
        us, cur, nbytes, hop_levels = [], r_ids, 4 * r_ids.shape[0], []
        for hop, fo in enumerate(fos):
            uh = torch.rand((cur.shape[0], fo), generator=gen, device="cuda")
            c64 = cur.long()
            dg = g.degrees[c64]
            picks = g.indptr[c64].long()[:, None] + sample_hop.hop_columns(
                uh, dg.clamp_min(1)).long()
            live = (dg > 0)[:, None].expand_as(picks)
            nbytes += (2 * 32 * distinct(c64 // 8) + 32 * distinct(picks[live] // 8)
                       + 4 * uh.numel() * (1 + int(not last or hop == len(fos) - 1)))
            cur = sample_hop.sample_hop_csr(g.indptr, g.indices, g.degrees, cur, uh).reshape(-1)
            hop_levels.append(cur)
            us.append(uh)
        got = sample_hop.csr_tree(g.indptr, g.indices, g.degrees, r_ids, us, last_only=last)
        if not all(torch.equal(a, b) for a, b in zip(got, hop_levels[-1:] if last
                                                     else hop_levels)):
            raise AssertionError(f"the CSR {label} in one launch differs from its hops")
        cases.append(kernel_case(
            "csr_tree", f"CSR {label}: roots ({r_ids.shape[0]},), fanouts {fos}, last level "
            f"only {last}, indices ({g.indices.shape[0]},), window {g.window}",
            lambda r=r_ids, us=us, last=last: sample_hop.csr_tree(
                g.indptr, g.indices, g.degrees, r, us, last_only=last)[-1],
            lambda r=r_ids, us=us, last=last: sample_hop.csr_tree_reference(
                g.indptr, g.indices, g.degrees, r, us, last_only=last)[-1],
            None, nbytes, weight=0))
    tree = sample_tree(adj, deg, roots, FANOUTS, generator=gen)
    add_hop("NCE tree hop 1", tree[0], FANOUTS[0])
    add_hop("NCE tree hop 2", tree[1], FANOUTS[1])
    add_gather("NCE level 0", feats, tree[0])
    add_gather("NCE level 1", feats, tree[1])
    f, d = FANOUTS[1], feats.shape[1]
    r, l2, l2_64 = tree[2].shape[0] // f, tree[2], tree[2].long()
    cases.append(kernel_case(
        "gather_fanout_mean", f"NCE deepest level bf16 {tuple(feats.shape)} ids={l2.shape[0]} "
        f"F={f}",
        lambda: gather_mean.gather_fanout_mean(feats, l2, f),
        lambda: gather_mean.gather_fanout_mean_reference(feats, l2, f),
        lambda: feats[l2_64].float().view(r, f, d).mean(1),
        4 * l2.shape[0] + distinct(l2) * d * 2 + r * d * 4, flops=l2.shape[0] * d,
        peak=f32_peak, weight=0, floor_bytes=4 * l2.shape[0] + l2.shape[0] * d * 2 + r * d * 4))
    # the int8 NCE step's deepest mean; its library yardstick is phase 8's
    # (the int32 sum of the gathered rows times scale / F)
    c8 = qf.scale * gather_mean.reciprocal(f)
    cases.append(kernel_case(
        "gather_fanout_mean_int8", f"NCE deepest level int8 {tuple(qf.shape)} ids={l2.shape[0]} "
        f"F={f} -> bfloat16, int32 sum",
        lambda: gather_mean.gather_fanout_mean_int8(qf.q, qf.scale, l2, f, torch.bfloat16),
        lambda: gather_mean.gather_fanout_mean_int8_reference(qf.q, qf.scale, l2, f,
                                                              torch.bfloat16),
        lambda: (qf.q[l2_64].view(r, f, d).to(torch.int32).sum(1).float() * c8).to(
            torch.bfloat16),
        4 * l2.shape[0] + distinct(l2) * d + r * d * 2 + 4 * d, flops=l2.shape[0] * d,
        peak=f32_peak, weight=0, floor_bytes=4 * l2.shape[0] + l2.shape[0] * d + r * d * 2))
    x0 = feats[tree[1].long()].view(-1, FANOUTS[0], d)
    x1 = torch.relu(torch.randn((x0.shape[0], FANOUTS[0], 2 * DIMS[0]), generator=gen,
                                device="cuda")).to(torch.bfloat16)
    for label, x in (("NCE layer 0", x0), ("NCE layer 1", x1)):
        b, fo, dx = x.shape
        w = (torch.randn((dx, DIMS[1]), generator=gen, device="cuda") / dx ** 0.5).to(x.dtype)
        cases.append(kernel_case(
            "mean_project", f"{label} x bf16 {tuple(x.shape)}, W {tuple(w.shape)}",
            lambda x=x, w=w: mean_project.mean_project(x, w),
            lambda x=x, w=w: mean_project.mean_project_reference(x, w),
            lambda x=x, w=w: x.mean(1) @ w,
            x.numel() * 2 + w.numel() * 2 + b * DIMS[1] * 2,
            flops=2 * b * dx * DIMS[1] + b * fo * dx, peak=bf16_peak, tol=MEAN_PROJECT_TOL,
            weight=0))
    corpus = torch.randint(0, n, (n, CORPUS_WALKS * (WALK_LENGTH + 1)), generator=gen,
                           device="cuda", dtype=torch.int32)
    add_gather("walk corpus rows", corpus, anchors)
    del x0, x1, corpus

    main_tree = sample_tree(adj, deg, anchors, FANOUTS, generator=gen)
    proj = (feats @ (torch.randn((d, DIMS[0]), generator=gen, device="cuda")
                     / d ** 0.5).to(feats.dtype)).contiguous()
    add_gather("fused: projected level 0", proj, main_tree[0])
    add_gather("fused: projected level 1", proj, main_tree[1])
    for ids, fo in ((main_tree[1], FANOUTS[0]), (main_tree[2], FANOUTS[1])):
        ro, ids64, w = ids.shape[0] // fo, ids.long(), proj.shape[1]
        cases.append(kernel_case(
            "gather_fanout_mean", f"fused: projected bf16 {tuple(proj.shape)} ids={ids.shape[0]} "
            f"F={fo}",
            lambda i=ids, fo=fo: gather_mean.gather_fanout_mean(proj, i, fo),
            lambda i=ids, fo=fo: gather_mean.gather_fanout_mean_reference(proj, i, fo),
            lambda i=ids64, fo=fo, ro=ro: proj[i].float().view(ro, fo, w).mean(1),
            4 * ids.shape[0] + distinct(ids) * w * 2 + ro * w * 4, flops=ids.shape[0] * w,
            peak=f32_peak, weight=0))
    add_gather("fused backward: raw level 2", feats, main_tree[2])
    results = time_cases(torch, cases, bw)
    del proj
    return results


def check_unsup_and_fused_card_vs_cpu(torch, np):
    """Phase 9 (b): on a small SBM store (2,000 × 64), the same parameters
    and injected levels on the card and on the CPU's plain path: one NCE
    loss and its gradients (f32: the loss within 1e-4 relative, each
    gradient within 1e-4 of its scale), and the fused first layer's logits
    and the gradients of their squared sum (f32 the same limits; bf16
    logits within SAMPLED_TOL of their scale plus one bf16 ulp, gradients
    within 1.5e-2 of their scale)."""
    from tpu_sage_torch.data.synthetic import sbm_problem
    from tpu_sage_torch.nn.params import flax_key, flax_params, load_flax_params
    from tpu_sage_torch.train.trainer import build_model
    from tpu_sage_torch.train.unsupervised import UnsupConfig, UnsupervisedTrainer

    problem = sbm_problem(n_nodes=2000, n_classes=5, feat_dim=64, seed=4)
    rng = np.random.default_rng(8)
    b, q = 64, N_NEGATIVES
    sizes = [b * (2 + q)]
    for f in FANOUTS:
        sizes.append(sizes[-1] * f)
    levels = [rng.integers(0, problem.n_nodes, s).astype(np.int32) for s in sizes]

    def compare(label, outs, tol_out, tol_grad, rtol_out=0.0):
        (want, wgrads), (got, ggrads) = outs["cpu"], outs["cuda"]
        scale = np.abs(want).max()
        err = np.abs(got - want).max()
        if not (np.isfinite(got).all()
                and np.all(np.abs(got - want) <= tol_out * scale + rtol_out * np.abs(want))):
            raise AssertionError(f"{label}: card vs CPU max abs err {err} (scale {scale})")
        worst = 0.0
        for k in wgrads:
            g = np.abs(wgrads[k]).max()
            e = np.abs(ggrads[k] - wgrads[k]).max()
            if not e <= tol_grad * max(g, 1e-30):
                raise AssertionError(f"{label}: gradient {k} card vs CPU max abs err {e} "
                                     f"> {tol_grad} x {g}")
            worst = max(worst, e / max(g, 1e-30))
        log(f"  {label}: card vs CPU max abs err {err:.4g} (scale {scale:.4g}); worst gradient "
            f"err {worst:.3g} of its scale")

    cfg = unsup_config().replace(compute_dtype="float32", batch_size=b)
    src = build_model(cfg, problem.n_nodes, problem.n_classes, problem.feats_dim)
    src.reset_parameters(torch.Generator().manual_seed(12))
    tree = flax_params(src)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, problem.n_nodes, problem.n_classes, problem.feats_dim)
        trainer = UnsupervisedTrainer(model, cfg, UnsupConfig(WALK_LENGTH, N_NEGATIVES), 10)
        graph = problem.device_graph(train=True, device=dev)
        state = trainer.init_state(graph)
        load_flax_params(model, tree)
        loss = trainer.nce_loss_and_grads(
            state, graph, torch.as_tensor(levels[0][:b], device=dev),
            levels=[torch.as_tensor(l, device=dev) for l in levels])
        outs[dev] = (np.array([loss.item()]),
                     {flax_key(k): p.grad.float().cpu().numpy()
                      for k, p in model.named_parameters()})
    compare("NCE loss, f32", outs, 1e-4, 1e-4)

    fused_levels = [l[:s] for l, s in zip(levels, (b, b * FANOUTS[0],
                                                   b * FANOUTS[0] * FANOUTS[1]))]
    for dtype_name, tols in (("float32", (1e-4, 1e-4, 0.0)),
                             ("bfloat16", (SAMPLED_TOL, 1.5e-2, 2.0 ** -7))):
        cfg = unsup_config(fuse_first_layer=True).replace(compute_dtype=dtype_name)
        src = build_model(cfg, problem.n_nodes, problem.n_classes, problem.feats_dim)
        src.reset_parameters(torch.Generator().manual_seed(13))
        tree = flax_params(src)
        outs = {}
        for dev in ("cpu", "cuda"):
            model = load_flax_params(build_model(cfg, problem.n_nodes, problem.n_classes,
                                                 problem.feats_dim), tree).to(dev)
            feats = problem.device_graph(train=True, device=dev,
                                         dtype=getattr(torch, dtype_name)).feats
            logits = model([torch.as_tensor(l, device=dev) for l in fused_levels], feats)
            logits.float().square().sum().backward()
            outs[dev] = (logits.detach().float().cpu().numpy(),
                         {flax_key(k): p.grad.float().cpu().numpy()
                          for k, p in model.named_parameters()})
        compare(f"fused first layer, {dtype_name} logits", outs, tols[0], tols[1], tols[2])


def unsup_run(torch, np, label, problem, unsup, steps, warmup, csr=False, walks=None,
              profile=False, quantize=False):
    """``steps`` timed NCE ``train_step``s at phase 9's configuration after
    ``warmup`` (on the int8 table with ``quantize``), with the launch
    counters from 0 checked per step exactly and the loss finite and
    falling; with ``profile``, PROFILE_STEPS more steps under
    torch.profiler. Returns the run's record and its launch counts."""
    from tpu_sage_torch import kernels
    from tpu_sage_torch.train.trainer import build_model
    from tpu_sage_torch.train.unsupervised import UnsupervisedTrainer, unsup_gather_defaults

    cfg = unsup_gather_defaults(unsup_config())
    train_ids = problem.folds["train"]
    model = build_model(cfg, problem.n_nodes, max(problem.n_classes, 2), problem.feats_dim)
    trainer = UnsupervisedTrainer(model, cfg, unsup, steps_per_epoch=len(train_ids) // BATCH)
    graph = problem.device_graph(train=True, dtype=torch.bfloat16, device="cuda", csr=csr,
                                 quantize=quantize)
    state = trainer.init_state(graph)
    n_batches = warmup + steps + (PROFILE_STEPS if profile else 0)
    perm = np.random.default_rng(7).permutation(train_ids)
    batches = [torch.as_tensor(perm[i * BATCH:(i + 1) * BATCH], dtype=torch.int32,
                               device="cuda") for i in range(n_batches)]
    for ids in batches[:warmup]:
        state, _ = trainer.train_step(state, graph, ids, walks)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = []
    for ids in batches[warmup:warmup + steps]:
        state, m = trainer.train_step(state, graph, ids, walks)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = unsup_per_step(csr=csr, corpus=walks is not None, int8=quantize)
    if counts != {k: v * steps for k, v in want.items()}:
        raise AssertionError(f"{label}: launches in {steps} steps {counts}, expected {want} "
                             f"per step")
    losses = torch.stack(losses).float().cpu().numpy()
    third = max(1, steps // 3)
    first, last = losses[:third].mean(), losses[-third:].mean()
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"{label}: losses {losses} not finite and falling")
    ms_step = dt / steps * 1e3
    edges = BATCH * (2 + unsup.n_negatives) * (FANOUTS[0] + FANOUTS[0] * FANOUTS[1])
    rec = {"run": label, "csr": csr, "corpus": walks is not None, "neg_power": unsup.neg_power,
           "feature_int8": quantize,
           "steps": steps, "ms_per_step": ms_step, "edges_per_step": edges,
           "edges_per_s": edges * steps / dt, "loss_first": float(first),
           "loss_last": float(last), "launches_per_step": want}
    if profile:
        it = iter(batches[warmup + steps:])

        def step():
            trainer.train_step(state, graph, next(it), walks)

        kern, launches = device_profile(torch, step, PROFILE_STEPS)
        device_ms = sum(k[1] for k in kern)
        rec.update(device_kernel_ms_per_step=device_ms,
                   device_busy_share=device_ms / ms_step if device_ms else None,
                   kernel_launches_per_step=launches,
                   top_kernels_ms_per_step=[[k[0][:80], k[1], k[2]] for k in kern[:10]])
    log(json.dumps({"unsupervised_run": rec}))
    return rec, counts


def device_walk_corpus(torch, graph, n_walks, length, seed):
    """A walk corpus ``(n_nodes, n_walks, length + 1)`` made on the card
    with the port's own walk hops: every node starts ``n_walks`` walks."""
    from tpu_sage_torch.sample.sampler import uniform_neighbor_sample

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = graph.degrees.shape[0]
    starts = torch.arange(n, dtype=torch.int32, device="cuda").repeat(n_walks)
    steps = [starts]
    for _ in range(length):
        steps.append(uniform_neighbor_sample(graph.adj, graph.degrees, steps[-1], 1,
                                             generator=gen)[:, 0])
    return torch.stack(steps, 1).view(n_walks, n, length + 1).transpose(0, 1).contiguous()


def unsup_quality(torch, np):
    """Phase 9 (e): ``fit_unsupervised`` on ``assortative_bench_store()``
    (the label signal in the edges) at phase 9's configuration, 2 epochs and
    the probe after the last; the loss must be finite and fall; the probe's
    val accuracy is reported beside the JAX package's record of a
    feature-only probe and chance, not gated."""
    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.data.synthetic import assortative_bench_store
    from tpu_sage_torch.train.unsupervised import UnsupConfig, fit_unsupervised

    problem = NodeProblem(assortative_bench_store())
    t0 = time.perf_counter()
    _, _, hist = fit_unsupervised(problem, unsup_config().replace(epochs=2),
                                  UnsupConfig(WALK_LENGTH, N_NEGATIVES), log=lambda r: None,
                                  device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [h["unsup_loss"] for h in hist]
    probe = hist[-1].get("probe_val_accuracy", -1.0)
    if not (len(losses) == 2 and np.isfinite(losses).all() and losses[1] < losses[0]
            and 0.0 <= probe <= 1.0):
        raise AssertionError(f"fit_unsupervised on the assortative store: {hist}")
    log(json.dumps({"unsupervised_quality": {
        "store": "assortative_bench_store()", "epochs": 2, "unsup_loss": losses,
        "epoch_s": [h["elapsed"] for h in hist], "wall_s": wall,
        "probe_val_accuracy": probe, "feature_only_probe_reference": FEATURE_ONLY_PROBE,
        "chance": CHANCE}}))


def unsup_entry_points(torch, np):
    """Phase 9 (f): ``tpu_sage_torch.cli.main --unsupervised`` for one epoch
    on the 232,965-node Reddit-shaped store with a checkpoint (and the
    probe), ``tpu_sage_torch.export.main`` writing its f16 embeddings
    (232,965 × 256, finite; ``gather_rows`` 2 × 57 launches and nothing
    else), then ``--fuse-first-layer`` for one epoch; each with the launch
    counters from 0."""
    import os
    import tempfile

    from tpu_sage_torch import cli, export, kernels

    base = ["--synthetic", "reddit-shaped", "--synthetic-nodes", str(SERVING_NODES),
            "--compute-dtype", "bfloat16", "--batch-size", str(BATCH), "--n-train-samples",
            "25,10", "--n-val-samples", "25,10", "--output-dims", "128,128", "--epochs", "1"]
    by_path, walls = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ck, out = os.path.join(tmp, "unsup.npz"), os.path.join(tmp, "emb.npy")
        runs = (("unsup_cli", cli.main, base + ["--unsupervised", "--walk-length",
                                                 str(WALK_LENGTH), "--n-negatives",
                                                 str(N_NEGATIVES), "--checkpoint-path", ck]),
                ("unsup_export", export.main,
                 ["--synthetic", "reddit-shaped", "--synthetic-nodes", str(SERVING_NODES),
                  "--checkpoint", ck, "--checkpoint-config", "--out", out, "--out-dtype",
                  "float16"]),
                ("fused_cli", cli.main, base + ["--fuse-first-layer"]))
        for label, entry, argv in runs:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            if entry(argv) != 0:
                raise AssertionError(f"{label} failed: {argv}")
            torch.cuda.synchronize()
            walls[label] = time.perf_counter() - t0
            by_path[label] = kernels.launch_counts()
            if label == "unsup_export":
                arr = np.load(out)
                if (arr.shape != (SERVING_NODES, 2 * DIMS[1]) or arr.dtype != np.float16
                        or not np.isfinite(arr).all()):
                    raise AssertionError(f"exported embeddings {arr.shape} {arr.dtype}")
    n_chunks = -(-SERVING_NODES // EXACT_CHUNK)
    if by_path["unsup_export"] != {**{k: 0 for k in by_path["unsup_export"]},
                                   "gather_rows": 2 * n_chunks}:
        raise AssertionError(f"export launches {by_path['unsup_export']}")
    for label in ("unsup_cli", "fused_cli"):
        want = unsup_per_step() if label == "unsup_cli" else FUSED_PER_STEP
        if any((by_path[label][k] == 0) != (want[k] == 0) for k in want):
            raise AssertionError(f"{label} launches {by_path[label]}")
    log(f"  CLI --unsupervised 1 epoch + probe {walls['unsup_cli']:.1f} s, export of f16 "
        f"embeddings ({SERVING_NODES}, {2 * DIMS[1]}) {walls['unsup_export']:.1f} s, CLI "
        f"--fuse-first-layer 1 epoch {walls['fused_cli']:.1f} s; launches {by_path}")
    return by_path


def phase_unsupervised(torch, np, problem, graph, smi, peaks, main_ms):
    """Phase 9: unsupervised training and the fused first layer. (a) kernels
    at this phase's shapes; (b) card against CPU; (c) the NCE step at
    ``scripts/bench_unsup.py``'s configuration, UNSUP_STEPS timed with exact
    launches per step and a profile, then UNSUP_VARIANT_STEPS each with
    degree-smoothed negatives, CSR adjacency, a walk corpus and the int8
    table; (d) the main
    path's configuration with ``fuse_first_layer``, FUSED_STEPS, beside
    phase 5's ms/step (``main_ms``), and the two whole-table products timed
    alone; (e) the probe on the assortative store; (f) the entry points.
    Returns the timed cases and the launch counts by path."""
    from tpu_sage_torch.bench.timing import cuda_ms
    from tpu_sage_torch.train.unsupervised import UnsupConfig

    csr_graph = problem.device_graph(train=True, dtype=torch.bfloat16, device="cuda", csr=True)
    qf = problem.device_graph(train=True, dtype=torch.bfloat16, device="cuda",
                              quantize=True).feats
    results = unsup_new_shape_cases(torch, graph, csr_graph, qf, peaks)
    check_unsup_and_fused_card_vs_cpu(torch, np)

    by_path, runs = {}, []
    plain = UnsupConfig(WALK_LENGTH, N_NEGATIVES)
    corpus = device_walk_corpus(torch, graph, CORPUS_WALKS, WALK_LENGTH, 5)
    for path, label, unsup, steps, kw in (
            ("unsup_train", "NCE step", plain, UNSUP_STEPS, dict(profile=True)),
            ("unsup_neg_power", "NCE step, neg_power 0.75",
             UnsupConfig(WALK_LENGTH, N_NEGATIVES, 0.75), UNSUP_VARIANT_STEPS, {}),
            ("unsup_csr", "NCE step, CSR", plain, UNSUP_VARIANT_STEPS, dict(csr=True)),
            ("unsup_corpus", "NCE step, walk corpus", plain, UNSUP_VARIANT_STEPS,
             dict(walks=corpus)),
            ("unsup_int8", "NCE step, int8", plain, UNSUP_VARIANT_STEPS,
             dict(quantize=True))):
        rec, by_path[path] = unsup_run(torch, np, label, problem, unsup, steps, 2, **kw)
        runs.append(rec)
    del corpus

    rec, by_path["fused_train"] = train_run(torch, np, "main path, fuse_first_layer", problem,
                                            unsup_config(fuse_first_layer=True), FUSED_STEPS,
                                            WARMUP_STEPS)
    w = torch.randn((graph.feats.shape[1], DIMS[0]), device="cuda").to(torch.bfloat16)
    table_ms = cuda_ms(lambda: graph.feats @ w)
    n, d = graph.feats.shape
    rec.update(main_path_ms_per_step=main_ms, whole_table_product_ms=table_ms,
               whole_table_products_per_step=2,
               whole_table_product_bound_ms=max(
                   (n * d * 2 + d * DIMS[0] * 2 + n * DIMS[0] * 2) / peaks[0],
                   2 * n * d * DIMS[0] / peaks[1]) * 1e3)
    runs.append(rec)
    log(json.dumps({"fused_first_layer": rec}))

    unsup_quality(torch, np)
    by_path.update(unsup_entry_points(torch, np))
    log(smi)
    log(json.dumps({"unsupervised": {"runs": runs}}))
    return results, by_path

def dist_kernel_cases(torch, graph, peaks):
    """Phase 10 (a): the partitioned step's owner-side kernels at the width
    of configs/ogbn_products_dist.json, split among DIST_OWNERS owners of
    bench_store's bf16 table (rank s owns rows [s*m, (s+1)*m)): the
    owner-masked fanout mean over the deepest level's 256,000 ids (25,600
    roots x 10) for each owner, bitwise against its plain version, the 4
    partials' sum against the single-device gather_fanout_mean, again on an
    int8 table; gather_rows(oob="zero") as an owner answers 4*q ids (level
    1's features, hop 2's adjacency || degree rows); select_hop and the bare
    select_columns at the exchanged rows' shape, and select_hop on the CSR
    pair view's rows and at the owner. The world-1 step's own launch (the
    whole table as one owner) is the case that counts into the kernels line."""
    from tpu_sage_torch.dist.halo import CSRPairRows
    from tpu_sage_torch.kernels import gather, gather_mean, sample_hop, select
    from tpu_sage_torch.sample.csr import gather_window_pair
    from tpu_sage_torch.sample.sampler import pack_adjacency, sample_tree

    bw = peaks[0]
    feats, adj, deg = graph.feats, graph.adj, graph.degrees
    n, d = feats.shape
    gen = torch.Generator(device="cuda").manual_seed(13)
    roots = torch.randperm(n, generator=gen, device="cuda")[:DIST_BATCH].int()
    levels = sample_tree(adj, deg, roots, FANOUTS, generator=gen)
    ids, f = levels[2], FANOUTS[1]
    r = ids.shape[0] // f
    m = -(-n // DIST_OWNERS)
    cases = []

    def distinct(x):
        return int(torch.unique(x).numel())

    q8 = torch.clamp(torch.round(feats.float() / (feats.float().abs().amax(0) / 127)),
                     -127, 127).to(torch.int8)
    for label, table in (("bf16", feats), ("int8", q8)):
        partials = []
        for s_, lo in enumerate(range(0, n, m)):
            local = table[lo:lo + m]
            own = (ids >= lo) & (ids < lo + local.shape[0])
            cases.append(kernel_case(
                "gather_fanout_mean_owned",
                f"{label} owner {s_}/{DIST_OWNERS} {tuple(local.shape)} ids={ids.shape[0]} F={f}",
                lambda t=local, lo=lo: gather_mean.gather_fanout_mean_owned(t, ids, f, lo),
                lambda t=local, lo=lo: gather_mean.gather_fanout_mean_owned_reference(
                    t, ids, f, lo),
                lambda t=local, lo=lo, own=own: torch.where(
                    own[:, None], t[(ids.long() - lo).clamp(0, t.shape[0] - 1)], 0
                ).float().view(r, f, d).mean(1),
                4 * ids.shape[0] + distinct(ids[own]) * d * table.element_size() + r * d * 4,
                weight=0, floor_bytes=4 * ids.shape[0] + int(own.sum()) * d
                * table.element_size() + r * d * 4))
            partials.append(gather_mean.gather_fanout_mean_owned(local, ids, f, lo))
        total = partials[0]
        for p in partials[1:]:
            total = total + p
        if label == "bf16":
            want = gather_mean.gather_fanout_mean(table, ids, f)
        else:
            want = table[ids.long()].float().view(r, f, d).sum(1) * gather_mean.reciprocal(f)
        err = (total - want).abs().max().item()
        if not err <= OWNED_TOL * want.abs().max().item():
            raise AssertionError(f"{label}: {DIST_OWNERS} owners' partial means sum to "
                                 f"max abs err {err} from one fanout mean")
        log(f"  {label}: {DIST_OWNERS} owners' partial means against one fanout mean: max abs "
            f"err {err:.3g} (limit {OWNED_TOL} x {want.abs().max().item():.4g})")
    cases.append(kernel_case(
        "gather_fanout_mean_owned", f"bf16 world 1, one owner {tuple(feats.shape)} "
        f"ids={ids.shape[0]} F={f}",
        lambda: gather_mean.gather_fanout_mean_owned(feats, ids, f, 0),
        lambda: gather_mean.gather_fanout_mean_owned_reference(feats, ids, f, 0),
        lambda: feats[ids.long()].float().view(r, f, d).mean(1),
        4 * ids.shape[0] + distinct(ids) * d * 2 + r * d * 4, weight=1,
        floor_bytes=4 * ids.shape[0] + ids.shape[0] * d * 2 + r * d * 4))

    # an owner's answers to every rank's queries (4q ids, the others' zero
    # rows): level 1's features (4 x 6,400 ids of 1,204 bytes) and hop 2's
    # adjacency || degree rows (4 x 6,400 of 516 bytes), owner 1
    packed = pack_adjacency(adj, deg)
    q = levels[1].shape[0] // DIST_OWNERS
    all_ids = levels[1][:DIST_OWNERS * q]
    for name, table in (("feats bf16", feats), ("adjacency || degree int32", packed)):
        local = table[m:2 * m]
        lids = (all_ids - m).contiguous()
        own = (lids >= 0) & (lids < m)
        row = table.shape[1] * table.element_size()
        cases.append(kernel_case(
            "gather_rows", f"owner 1/{DIST_OWNERS} answers {name} {tuple(local.shape)} "
            f"q={lids.shape[0]} oob=zero",
            lambda t=local: gather.gather_rows(t, lids, "zero"),
            lambda t=local: gather.gather_rows_reference(t, lids, "zero"),
            lambda t=local: torch.where(own[:, None], t[lids.long().clamp(0, m - 1)], 0),
            4 * lids.shape[0] + distinct(lids[own]) * row + lids.shape[0] * row, weight=0))

    # the requester's column pick on the exchanged adjacency || degree rows:
    # hop 1 (1,024 x 25) and hop 2 (25,600 x 10), a view of row stride 129:
    # select_hop as the hop launches it (the degree column read in place,
    # the frontier ids for the degree-0 self-loop; bytes: u, the ids, the
    # distinct 32-byte sectors of the picks and of the degree words, out)
    # and the bare select_columns the hop launched before (cols
    # precomputed). Then the same hops on CSR shards: the pair view's rows
    # lo || hi || off || deg (the shift and the degree read in place), and
    # the owner's pick on the window pair with the offsets and degrees as
    # tensors of their own and no ids (the owner answers values || degree).
    idx = torch.arange(adj.shape[1], device="cuda")[None, :] < deg[:, None]
    indptr = torch.zeros(n + 1, dtype=torch.int32, device="cuda")
    indptr[1:] = torch.cumsum(deg, 0)
    window = int(deg.max())
    flat = adj[idx]
    indices = torch.zeros(flat.shape[0] + (-flat.shape[0]) % window + 2 * window,
                          dtype=torch.int32, device="cuda")
    indices[:flat.shape[0]] = flat
    del idx, flat
    pair_view = CSRPairRows(indptr, indices, deg, window)
    for hop, (hop_ids, fo) in enumerate(((levels[0], FANOUTS[0]), (levels[1], FANOUTS[1])), 1):
        rows = packed[hop_ids.long()]
        u = torch.rand((hop_ids.shape[0], fo), generator=gen, device="cuda")
        cols = torch.minimum((u * rows[:, -1:].clamp_min(1).float()).int(),
                             rows[:, -1:].clamp_min(1) - 1).contiguous()
        view, r_deg = rows[:, :-1], rows[:, -1]
        base = torch.arange(view.shape[0], device="cuda")[:, None] * view.stride(0)
        words = (base + cols.long()).reshape(-1)
        cases.append(kernel_case(
            "select_hop", f"hop {hop} exchanged rows int32 {tuple(view.shape)} (row stride "
            f"{view.stride(0)}), degree column, ids, u {tuple(u.shape)}",
            lambda v=view, dg=r_deg, u=u, i=hop_ids: select.select_hop(v, dg, u, ids=i),
            lambda v=view, dg=r_deg, u=u, i=hop_ids: select.select_hop_reference(v, dg, u,
                                                                                 ids=i),
            lambda v=view, c=cols.long(): torch.gather(v, 1, c),
            32 * distinct(torch.cat([words, base[:, 0] + view.shape[1]]) // 8)
            + 8 * u.numel() + 4 * hop_ids.shape[0], weight=0))
        cases.append(kernel_case(
            "select_columns", f"hop {hop} exchanged rows int32 {tuple(view.shape)} (row stride "
            f"{view.stride(0)}), cols {tuple(cols.shape)}",
            lambda v=view, c=cols: select.select_columns(v, c),
            lambda v=view, c=cols: select.select_columns_reference(v, c),
            lambda v=view, c=cols.long(): torch.gather(v, 1, c),
            32 * distinct(words // 8) + 8 * cols.numel(), weight=0))
        prow = pair_view.rows(hop_ids)
        pv, p_shift, p_deg = prow[:, :2 * window], prow[:, 2 * window], prow[:, 2 * window + 1]
        pcols = (p_shift[:, None] + sample_hop.hop_columns(u, p_deg.clamp_min(1))).long()
        pbase = torch.arange(pv.shape[0], device="cuda")[:, None] * prow.stride(0)
        pwords = (pbase + pcols.clamp(0, 2 * window - 1)).reshape(-1)
        cases.append(kernel_case(
            "select_hop", f"hop {hop} CSR pair rows int32 {tuple(prow.shape)}, shift and "
            f"degree columns, ids, u {tuple(u.shape)}",
            lambda v=pv, dg=p_deg, sh=p_shift, u=u, i=hop_ids: select.select_hop(
                v, dg, u, shift=sh, ids=i),
            lambda v=pv, dg=p_deg, sh=p_shift, u=u, i=hop_ids: select.select_hop_reference(
                v, dg, u, shift=sh, ids=i),
            lambda v=pv, c=pcols.clamp(0, 2 * window - 1): torch.gather(v, 1, c),
            32 * distinct(torch.cat([pwords, pbase[:, 0] + 2 * window]) // 8)
            + 8 * u.numel() + 4 * hop_ids.shape[0], weight=0))
        pair, off, _ = gather_window_pair(indptr, indices, hop_ids, window)
        o_deg = deg[hop_ids.long()].contiguous()
        cases.append(kernel_case(
            "select_hop", f"hop {hop} owner pick on the window pair int32 {tuple(pair.shape)}, "
            f"offsets and degrees as tensors, u {tuple(u.shape)}",
            lambda v=pair, dg=o_deg, sh=off, u=u: select.select_hop(v, dg, u, shift=sh),
            lambda v=pair, dg=o_deg, sh=off, u=u: select.select_hop_reference(v, dg, u,
                                                                              shift=sh),
            lambda v=pair, c=pcols.clamp(0, 2 * window - 1): torch.gather(v, 1, c),
            32 * distinct((torch.arange(pair.shape[0], device="cuda")[:, None] * pair.stride(0)
                           + pcols.clamp(0, 2 * window - 1)) // 8)
            + 2 * 32 * -(-pair.shape[0] // 8) + 8 * u.numel(), weight=0))
        del prow, pair
    del q8, indices
    return time_cases(torch, cases, bw), levels


def dist_world1_equivalence(torch, np, store, graph, levels):
    """Phase 10 (c): at world 1 (an NCCL group of one rank in this process)
    the partitioned step's loss and gradients on injected levels equal the
    single-device trainer's from the same parameters, within phase 4's bf16
    limit (3e-2 of each one's scale)."""
    from tpu_sage_torch.dist import mesh
    from tpu_sage_torch.dist.train import PartitionedTrainer
    from tpu_sage_torch.train.trainer import TrainConfig, Trainer, build_model

    cfg = TrainConfig.from_json(DIST_CONFIG).replace(halo="exact")
    spe = len(store.folds["train"]) // cfg.batch_size

    def partitioned():
        tr, g, fold_ids, fold_w = PartitionedTrainer.from_store(store, cfg, "cuda:0")
        st = tr.init_state()
        st, m = tr.train_step(st, g, fold_ids, fold_w, levels=levels)
        return float(m["loss"]), {k: p.grad.float() for k, p in tr.model.named_parameters()}

    loss_p, grads_p = mesh.run_in_process(partitioned, "cuda")
    model = build_model(cfg, store.n_nodes, store.n_classes, store.feat_dim)
    trainer = Trainer(model, cfg, steps_per_epoch=spe, task=store.task)
    state = trainer.init_state(graph)
    state, m = trainer.train_step(state, graph, levels[0], graph.targets[levels[0].long()],
                                  levels=levels)
    loss_s = float(m["loss"])
    errs = {k: ((grads_p[k] - p.grad.float()).abs().max() / p.grad.float().abs().max()).item()
            for k, p in model.named_parameters()}
    if not (abs(loss_p - loss_s) <= SAMPLED_TOL * abs(loss_s)
            and max(errs.values()) <= SAMPLED_TOL):
        raise AssertionError(f"world-1 partitioned step: loss {loss_p} vs {loss_s}, gradient "
                             f"errors (share of scale) {errs}")
    log(f"  world 1: partitioned step loss {loss_p:.6f} vs single device {loss_s:.6f}; "
        f"gradients within {max(errs.values()):.3g} of scale (limit {SAMPLED_TOL})")


def dist_rank(out_dir):
    """Phase 10 (b), run by every spawned rank: DIST_STEPS timed steps of each
    of DIST_MODES at configs/ogbn_products_dist.json's configuration on
    bench_store (cached by phase 2), the launch counts from 0 checked per
    step, a profile, then (exact mode) the sampled and exact evaluations,
    the exact pass against the single-device one on rank 0, and the
    replicas' fingerprints. Writes its records to ``out_dir/rank<r>.json``."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_sage_torch import kernels
    from tpu_sage_torch.data.synthetic import bench_store
    from tpu_sage_torch.dist.debug import assert_replicas_equal, tree_fingerprint
    from tpu_sage_torch.dist.halo import all_gather_rows
    from tpu_sage_torch.dist.mesh import rank, world
    from tpu_sage_torch.dist.train import PartitionedTrainer
    from tpu_sage_torch.nn.full_graph import embed_all_nodes, embed_all_nodes_partitioned
    from tpu_sage_torch.train.trainer import TrainConfig, fold_metric_np

    torch.backends.cuda.matmul.allow_tf32 = False
    me, n_ranks = rank(), world()
    device = torch.device("cuda", torch.cuda.current_device())
    store = bench_store()
    base = TrainConfig.from_json(DIST_CONFIG)
    recs = {}
    for label, kw, csr in DIST_MODES:
        cfg = base.replace(**kw)
        t0 = time.perf_counter()
        tr, graph, fold_ids, fold_w = PartitionedTrainer.from_store(store, cfg, device, csr=csr)
        state = tr.init_state()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        for _ in range(DIST_WARMUP):
            state, _ = tr.train_step(state, graph, fold_ids, fold_w)
        torch.cuda.synchronize()
        dist.barrier()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        losses = []
        for _ in range(DIST_STEPS):
            state, m = tr.train_step(state, graph, fold_ids, fold_w)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = kernels.launch_counts()
        want = dist_per_step(label, n_ranks)
        if counts != {k: v * DIST_STEPS for k, v in want.items()}:
            raise AssertionError(f"partitioned {label}: launches in {DIST_STEPS} steps "
                                 f"{counts}, expected {want} per step")
        losses = torch.stack(losses).float().cpu().numpy()
        if not np.isfinite(losses).all():
            raise AssertionError(f"partitioned {label}: losses {losses}")
        kern, launches = device_profile(
            torch, lambda: tr.train_step(state, graph, fold_ids, fold_w), DIST_PROFILE)
        device_ms = sum(k[1] for k in kern)
        ms = dt / DIST_STEPS * 1e3
        rec = {"mode": label, "halo": tr.halo_mode, "csr": csr, "world": n_ranks,
               "setup_s": setup_s,
               "feature_int8": cfg.feature_int8, "batch": cfg.batch_size,
               "batch_per_rank": tr.batch_per_shard, "steps": DIST_STEPS, "ms_per_step": ms,
               "edges_per_s": cfg.batch_size * (FANOUTS[0] + FANOUTS[0] * FANOUTS[1])
               * DIST_STEPS / dt,
               "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
               "launches": counts, "launches_per_step": want,
               "device_kernel_ms_per_step": device_ms,
               "device_busy_share": device_ms / ms if device_ms else None,
               "kernel_launches_per_step": launches,
               "top_kernels_ms_per_step": [[k[0][:80], k[1], k[2]] for k in kern[:8]]}
        if label == "exact":
            rec["val_sampled"] = tr.evaluate(state, store, "val", seed=cfg.seed + 1)
            t0 = time.perf_counter()
            rec["val_exact"] = tr.evaluate_exact(state, store, "val")
            rec["exact_eval_s"] = time.perf_counter() - t0
            g_full, _ = tr._full_graph_shard(store)
            sharded = all_gather_rows(embed_all_nodes_partitioned(tr.model, g_full,
                                                                  with_head=True))
            sharded = sharded[:store.n_nodes]
            if me == 0:
                single_graph = store.to_device(train=False, dtype=torch.bfloat16, device=device)
                single = embed_all_nodes(tr.model, single_graph, with_head=True)
                err = (sharded - single).abs().max().item()
                scale = single.abs().max().item()
                ids = store.folds["val"]
                single_val = fold_metric_np(store.task, single.cpu().numpy()[ids],
                                            store.targets[ids])
                if not (err <= EXACT_TOL["bfloat16"] * scale
                        and abs(single_val - rec["val_exact"]) <= 1e-3):
                    raise AssertionError(f"partitioned exact pass: max abs err {err} against "
                                         f"the single-device pass (scale {scale}); val "
                                         f"{rec['val_exact']} vs {single_val}")
                rec.update(exact_vs_single_max_abs_err=err, exact_scale=scale,
                           val_exact_single_device=single_val)
                del single_graph, single
            assert_replicas_equal(state.model, "params")
            assert_replicas_equal(state.optimizer, "optimizer")
            fps = [None] * n_ranks
            dist.all_gather_object(fps, [float(tree_fingerprint(state.model)),
                                         float(tree_fingerprint(state.optimizer))])
            rec["fingerprints"] = fps
        recs[label] = rec
        del tr, graph, state
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{me}.json"), "w") as f:
        json.dump(recs, f)


def dist_entry_points(torch, np, tmp):
    """Phase 10 (d): ``tpu_sage_torch.cli.main --partitioned`` with
    configs/ogbn_products_dist.json on the 232,965-node store for 1 epoch
    with a checkpoint, resumed to 2; ``tpu_sage_torch.export.main
    --partitioned`` from that checkpoint against the single-device export
    (f32 logits within EXACT_TOL). Returns the launch counts of each."""
    import os

    from tpu_sage_torch import cli, export, kernels

    ck, logp = os.path.join(tmp, "dist.npz"), os.path.join(tmp, "dist.jsonl")
    argv = ["--config", DIST_CONFIG, "--synthetic", "reddit-shaped", "--synthetic-nodes",
            str(SERVING_NODES), "--partitioned", "--checkpoint-path", ck, "--checkpoint-every",
            "1", "--log-path", logp]
    by_path = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for epochs in (1, 2):
        if cli.main(argv + ["--epochs", str(epochs)]) != 0:
            raise AssertionError(f"the partitioned CLI run to {epochs} epochs failed")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    by_path["dist_cli"] = kernels.launch_counts()
    with open(logp) as f:
        recs = [json.loads(line) for line in f]
    resumed = [r for r in recs if "resumed_from" in r]
    epochs = [r for r in recs if "elapsed" in r]
    heads = [r for r in recs if "n_shards" in r and "epoch" not in r]
    if (len(resumed) != 1 or resumed[0]["start_epoch"] != 1
            or [r["epoch"] for r in epochs] != [0, 1]
            or not all(np.isfinite(r["train_loss"]) and 0 <= r["val_metric"] <= 1
                       for r in epochs)
            or heads[0]["n_shards"] != torch.cuda.device_count()):
        raise AssertionError(f"partitioned CLI records {recs}")
    if by_path["dist_cli"]["gather_fanout_mean_owned"] == 0:
        raise AssertionError(f"partitioned CLI launches {by_path['dist_cli']}")
    summary = [(r["epoch"], round(r["train_loss"], 4), round(r["val_metric"], 4))
               for r in epochs]
    log(f"  partitioned CLI: {heads[0]}, epochs (epoch, loss, val) {summary}, resumed at "
        f"epoch 1, {fit_s:.1f} s; launches {by_path['dist_cli']}")

    outs, walls = {}, {}
    for label, extra in (("dist_export", ["--partitioned"]), ("single_export", [])):
        out = os.path.join(tmp, f"{label}.npy")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if export.main(["--synthetic", "reddit-shaped", "--synthetic-nodes", str(SERVING_NODES),
                        "--checkpoint", ck, "--out", out, "--checkpoint-config",
                        "--logits"] + extra) != 0:
            raise AssertionError(f"{label} failed")
        walls[label] = time.perf_counter() - t0
        by_path[label] = kernels.launch_counts()
        outs[label] = np.load(out)
    a, b = outs["dist_export"], outs["single_export"]
    err = float(np.abs(a - b).max())
    if a.shape != (SERVING_NODES, 41) or not np.isfinite(a).all() or \
            err > EXACT_TOL["float32"] * float(np.abs(b).max()):
        raise AssertionError(f"partitioned export {a.shape}: max abs err {err} against the "
                             f"single-device export")
    log(f"  export --partitioned {a.shape} in {walls['dist_export']:.2f} s (single device "
        f"{walls['single_export']:.2f} s): max abs err {err:.3g}; launches "
        f"{by_path['dist_export']}")
    return by_path


def phase_dist(torch, np, store, graph, smi, peaks):
    """Phase 10: partitioned training. (a) the owner-side kernels at 4
    owners' shapes; (c) world-1 equivalence with the single-device step;
    (b) world = the visible cards' NCCL ranks, spawned, DIST_STEPS steps of
    every flat halo mode and of CSR and int8 shards, evaluations, replica
    fingerprints; (d) the CLI and the exporter with ``--partitioned``.
    Returns the timed cases and the launch counts by path."""
    import os
    import tempfile

    from tpu_sage_torch.dist import mesh

    results, levels = dist_kernel_cases(torch, graph, peaks)
    dist_world1_equivalence(torch, np, store, graph, levels)
    world = torch.cuda.device_count()
    log(f"  spawning {world} NCCL rank(s), one per visible card")
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mesh.spawn(dist_rank, world, "cuda", (tmp,))
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        for label, rec in ranks[0].items():
            by_path[f"dist_{label}"] = rec["launches"]
            log(f"  {label}: {rec['ms_per_step']:.3f} ms/step, device "
                f"{rec['device_kernel_ms_per_step']:.3f} ms/step, loss {rec['loss_first']:.4f} "
                f"-> {rec['loss_last']:.4f}, launches per step {rec['launches_per_step']}")
        log(json.dumps({"partitioned_runs": list(ranks[0].values()), "spawn_wall_s": spawn_s}))
        log(f"  replica fingerprints (params, optimizer) by rank: "
            f"{ranks[0]['exact']['fingerprints']}")
        by_path.update(dist_entry_points(torch, np, tmp))
    log(smi)
    return results, by_path


# -- phase 11: the rest of the multi-GPU path ------------------------------------

def nce_dist_per_step(mode, world):
    """Kernel launches of one partitioned NCE step (phase 11's configuration)
    on each of ``world`` ranks: the WALK_LENGTH walk hops and the tree's 2
    hops each exchange adjacency || degree rows (``gather_rows`` once per
    exchange, or per rank a ring passes; on CSR shards the pick moves to the
    owner after four gathers) and pick a column (``select_hop``); levels
    0 and 1's features (``gather_rows``); the deepest level's pre-reduced
    means (``gather_fanout_mean_owned``); 2 ``mean_project``. ``hier2d``
    answers each exchange once, as exact does."""
    per = world if mode in ("ring", "pipelined") else 1
    hops = WALK_LENGTH + len(FANOUTS)
    return {"select_columns": 0, "select_hop": hops, "sample_hop": 0,
            "gather_rows": (4 * hops if mode == "csr" else hops * per) + 2 * per,
            "gather_rows_blockspec": 0, "gather_fanout_mean": 0, "mean_project": 2,
            "gather_fanout_mean_int8": 0, "sample_hop_csr": 0, "csr_tree": 0,
            "gather_fanout_mean_owned": per}


def nce_config(**kw):
    """``scripts/bench_unsup_partitioned.py:23-28``: mean, identity, batch
    512, (25, 10), (128, 128), bf16, walk length 3, 10 negatives."""
    return unsup_config(**kw)


def multi_gpu_kernel_cases(torch, graph, peaks):
    """Phase 11 (a): the kernels at this phase's new shapes, against their
    plain versions (bitwise; ``mean_project`` within MEAN_PROJECT_TOL) and
    timed (weight 0): the owner-masked fanout mean over the partitioned NCE
    step's deepest level at world 1 (6,144 roots x 25 x 10 = 1,536,000 ids,
    one owner) and as owner 1 of a (2, 2) layout (the 4 ranks' (C, H, q)
    ids); ``gather_rows(oob="zero")`` as owner 1 of a (2, 2) layout answers
    the 4 ranks' NCE level-1 ids; ``select_hop`` at the partitioned NCE
    step's three hop shapes; ``mean_project`` on the column slices a
    model axis of 2 gives (the main path's two layers, W (602, 64) and
    (256, 64)), whose concatenation must equal the whole product."""
    from tpu_sage_torch.kernels import gather, gather_mean, mean_project, sample_hop, select
    from tpu_sage_torch.sample.sampler import pack_adjacency, sample_tree

    bw, bf16_peak, _ = peaks
    feats, adj, deg = graph.feats, graph.adj, graph.degrees
    n, d = feats.shape
    gen = torch.Generator(device="cuda").manual_seed(51)
    roots = torch.randint(0, n, (BATCH * (2 + N_NEGATIVES),), generator=gen, device="cuda",
                          dtype=torch.int32)
    tree = sample_tree(adj, deg, roots, FANOUTS, generator=gen)
    ids, f = tree[2], FANOUTS[1]
    r = ids.shape[0] // f
    m = -(-n // 4)
    cases = []

    def distinct(x):
        return int(torch.unique(x).numel())

    for label, lo, local in (("world 1, one owner", 0, feats),
                             ("(2, 2) layout, owner 1 of 4", m, feats[m:2 * m])):
        own = (ids >= lo) & (ids < lo + local.shape[0])
        cases.append(kernel_case(
            "gather_fanout_mean_owned", f"NCE deepest, {label}: bf16 {tuple(local.shape)} "
            f"ids={ids.shape[0]} F={f}",
            lambda t=local, lo=lo: gather_mean.gather_fanout_mean_owned(t, ids, f, lo),
            lambda t=local, lo=lo: gather_mean.gather_fanout_mean_owned_reference(t, ids, f, lo),
            lambda t=local, lo=lo, own=own: torch.where(
                own[:, None], t[(ids.long() - lo).clamp(0, t.shape[0] - 1)], 0
            ).float().view(r, f, d).mean(1),
            4 * ids.shape[0] + distinct(ids[own]) * d * 2 + r * d * 4, weight=0,
            floor_bytes=4 * ids.shape[0] + int(own.sum()) * d * 2 + r * d * 4))
    lids = (tree[1] - m).contiguous()
    own = (lids >= 0) & (lids < m)
    local = feats[m:2 * m]
    cases.append(kernel_case(
        "gather_rows", f"(2, 2) owner 1 answers NCE level 1 (C, H, q) = (2, 2, "
        f"{lids.shape[0] // 4}) bf16 {tuple(local.shape)} oob=zero",
        lambda: gather.gather_rows(local, lids, "zero"),
        lambda: gather.gather_rows_reference(local, lids, "zero"),
        lambda: torch.where(own[:, None], local[lids.long().clamp(0, m - 1)], 0),
        4 * lids.shape[0] + distinct(lids[own]) * d * 2 + lids.shape[0] * d * 2, weight=0))

    # the partitioned NCE step's column picks (select_hop) on exchanged
    # adjacency || degree rows: a walk hop (512 x 1) and the tree's two hops
    # (6,144 x 25, 153,600 x 10); bytes as phase 10's
    packed = pack_adjacency(adj, deg)
    for label, hop_ids, fo in (("walk hop", roots[:BATCH], 1), ("tree hop 1", tree[0], FANOUTS[0]),
                               ("tree hop 2", tree[1], FANOUTS[1])):
        rows = packed[hop_ids.long()]
        view, r_deg = rows[:, :-1], rows[:, -1]
        u = torch.rand((hop_ids.shape[0], fo), generator=gen, device="cuda")
        cols = sample_hop.hop_columns(u, r_deg.clamp_min(1)).long()
        base = torch.arange(view.shape[0], device="cuda")[:, None] * view.stride(0)
        cases.append(kernel_case(
            "select_hop", f"NCE {label}: exchanged rows int32 {tuple(view.shape)} (row stride "
            f"{view.stride(0)}), ids, u {tuple(u.shape)}",
            lambda v=view, dg=r_deg, u=u, i=hop_ids: select.select_hop(v, dg, u, ids=i),
            lambda v=view, dg=r_deg, u=u, i=hop_ids: select.select_hop_reference(v, dg, u,
                                                                                 ids=i),
            lambda v=view, c=cols: torch.gather(v, 1, c),
            32 * distinct(torch.cat([(base + cols).reshape(-1), base[:, 0] + view.shape[1]])
                          // 8) + 8 * u.numel() + 4 * hop_ids.shape[0], weight=0))
        del rows
    del packed

    main_tree = sample_tree(adj, deg, roots[:BATCH], FANOUTS, generator=gen)
    x0 = feats[main_tree[1].long()].view(BATCH, FANOUTS[0], d)
    x1 = torch.relu(torch.randn((BATCH, FANOUTS[0], 2 * DIMS[0]), generator=gen,
                                device="cuda")).to(torch.bfloat16)
    for label, x in (("layer 0", x0), ("layer 1", x1)):
        b, fo, dx = x.shape
        w = (torch.randn((dx, DIMS[1]), generator=gen, device="cuda") / dx ** 0.5).to(x.dtype)
        halves = [w[:, j * DIMS[1] // 2:(j + 1) * DIMS[1] // 2].contiguous() for j in (0, 1)]
        whole = mean_project.mean_project(x, w)
        cat = torch.cat([mean_project.mean_project(x, h) for h in halves], dim=1)
        torch.testing.assert_close(cat.float(), whole.float(), rtol=MEAN_PROJECT_TOL[0],
                                   atol=MEAN_PROJECT_TOL[1] * whole.float().abs().max().item())
        log(f"  mean_project {label}: the 2 column slices' products concatenated against the "
            f"whole: max abs err {(cat.float() - whole.float()).abs().max().item():.3g}")
        for j, h in enumerate(halves):
            cases.append(kernel_case(
                "mean_project", f"TP {label} slice {j}/2: x bf16 {tuple(x.shape)}, W "
                f"{tuple(h.shape)}",
                lambda x=x, h=h: mean_project.mean_project(x, h),
                lambda x=x, h=h: mean_project.mean_project_reference(x, h),
                lambda x=x, h=h: x.mean(1) @ h,
                x.numel() * 2 + h.numel() * 2 + b * h.shape[1] * 2,
                flops=2 * b * dx * h.shape[1] + b * fo * dx, peak=bf16_peak,
                tol=MEAN_PROJECT_TOL, weight=0))
    results = time_cases(torch, cases, bw)
    del x0, x1, tree, main_tree
    return results


def _grads(model):
    return {k: p.grad.float().clone() for k, p in model.named_parameters()}


def _within(label, loss_a, loss_b, grads_a, grads_b, tol):
    errs = {k: ((grads_a[k] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
            for k, g in grads_b.items()}
    if not (abs(loss_a - loss_b) <= tol * abs(loss_b) and max(errs.values()) <= tol):
        raise AssertionError(f"{label}: loss {loss_a} vs {loss_b}, gradient errors (share "
                             f"of scale) {errs}")
    log(f"  world 1: {label}: loss {loss_a:.6f} vs {loss_b:.6f}; gradients within "
        f"{max(errs.values()):.3g} of scale (limit {tol})")


def multi_gpu_world1(torch, np, store, graph):
    """Phase 11 (b), at world 1 in this process (an NCCL group of one rank):
    one partitioned NCE step on an injected tree over anchors || positives
    || negatives against the single-device NCE step (loss and gradients
    within phase 4's bf16 limit); one hier2d supervised step at layout (1, 1)
    against exact's on the same injected levels, bitwise; one tensor-parallel
    ``DataParallelTrainer(model_axis="model")`` step at (1, 1) against the
    single-device step (loss rtol 1e-5; parameters rtol 1e-4, atol 1e-6)."""
    from tpu_sage_torch.dist import mesh
    from tpu_sage_torch.dist.data_parallel import DataParallelTrainer
    from tpu_sage_torch.dist.train import PartitionedTrainer
    from tpu_sage_torch.dist.unsupervised import PartitionedUnsupervisedTrainer
    from tpu_sage_torch.sample.sampler import sample_tree
    from tpu_sage_torch.train.trainer import TrainConfig, Trainer, build_model
    from tpu_sage_torch.train.unsupervised import (UnsupConfig, UnsupervisedTrainer,
                                                   unsup_gather_defaults)

    unsup = UnsupConfig(WALK_LENGTH, N_NEGATIVES)
    cfg = unsup_gather_defaults(nce_config())
    gen = torch.Generator(device="cuda").manual_seed(61)
    anchors = torch.as_tensor(store.folds["train"][:BATCH], dtype=torch.int32, device="cuda")
    others = torch.randint(0, store.n_nodes, (BATCH * (1 + N_NEGATIVES),), generator=gen,
                           device="cuda", dtype=torch.int32)
    levels = sample_tree(graph.adj, graph.degrees, torch.cat([anchors, others]), FANOUTS,
                         generator=gen)

    def nce():
        tr, g, fold_ids, fold_w = PartitionedUnsupervisedTrainer.from_store(store, cfg, unsup,
                                                                           "cuda:0")
        st = tr.init_state()
        st, m = tr.train_step(st, g, fold_ids, fold_w, levels=levels)
        return float(m["loss"]), _grads(tr.model)

    loss_p, grads_p = mesh.run_in_process(nce, "cuda")
    model = build_model(cfg, store.n_nodes, max(store.n_classes, 2), store.feat_dim)
    trainer = UnsupervisedTrainer(model, cfg, unsup, steps_per_epoch=1)
    state = trainer.init_state(graph)
    loss_s = float(trainer.nce_loss_and_grads(state, graph, anchors, levels=levels))
    _within("partitioned NCE step against the single-device NCE step", loss_p, loss_s,
            grads_p, _grads(model), SAMPLED_TOL)

    dcfg = TrainConfig.from_json(DIST_CONFIG)
    dist_roots = torch.as_tensor(store.folds["train"][:DIST_BATCH], dtype=torch.int32,
                                 device="cuda")
    dist_levels = sample_tree(graph.adj, graph.degrees, dist_roots, FANOUTS, generator=gen)

    def supervised(mode):
        layout = mesh.layout_2d(1, 1) if mode == "hier2d" else None
        tr, g, fold_ids, fold_w = PartitionedTrainer.from_store(
            store, dcfg.replace(halo=mode), "cuda:0", layout=layout)
        st = tr.init_state()
        st, m = tr.train_step(st, g, fold_ids, fold_w, levels=dist_levels)
        return m["loss"].clone(), _grads(tr.model)

    (lh, gh), (le, ge) = mesh.run_in_process(lambda: (supervised("hier2d"),
                                                      supervised("exact")), "cuda")
    if not (torch.equal(lh, le) and all(torch.equal(gh[k], ge[k]) for k in ge)):
        raise AssertionError(f"hier2d at (1, 1): loss {lh.item()} vs exact {le.item()}, "
                             f"gradients differ in {[k for k in ge if not torch.equal(gh[k], ge[k])]}")
    log(f"  world 1: hier2d step at layout (1, 1) bitwise exact's (loss {lh.item():.6f})")

    tcfg = TrainConfig(batch_size=BATCH, n_train_samples=FANOUTS, n_val_samples=FANOUTS,
                       output_dims=DIMS, compute_dtype="bfloat16", lr_init=0.01)
    main_levels = sample_tree(graph.adj, graph.degrees, anchors, FANOUTS, generator=gen)

    def step(cls, **kw):
        model = build_model(tcfg, store.n_nodes, store.n_classes, store.feat_dim)
        tr = cls(model, tcfg, steps_per_epoch=1, task=store.task, **kw)
        st = tr.init_state(graph)
        st, m = tr.train_step(st, graph, anchors, graph.targets[anchors.long()],
                              levels=main_levels)
        return float(m["loss"]), {k: p.detach().float().clone()
                                  for k, p in model.named_parameters()}

    loss_t, params_t = mesh.run_in_process(
        lambda: step(DataParallelTrainer, model_axis="model", layout=mesh.layout_2d(1, 1)),
        "cuda")
    loss_1, params_1 = step(Trainer)
    torch.testing.assert_close(torch.tensor(loss_t), torch.tensor(loss_1), rtol=1e-5, atol=0)
    for k, p in params_1.items():
        torch.testing.assert_close(params_t[k], p, rtol=1e-4, atol=1e-6, msg=k)
    log(f"  world 1: tensor-parallel step at (data, model) = (1, 1): loss {loss_t:.6f} vs "
        f"{loss_1:.6f}; parameters within rtol 1e-4, atol 1e-6")


def _profiled_run(torch, np, label, step, steps, warmup, want, edges_per_step):
    """``warmup`` steps, then ``steps`` timed with the launch counters from
    0 (exactly ``want`` per step), then DIST_PROFILE under torch.profiler.
    ``step()`` returns the step's metrics. Returns the run's record."""
    import torch.distributed as dist

    from tpu_sage_torch import kernels

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    dist.barrier()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step()["loss"] for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    if counts != {k: v * steps for k, v in want.items()}:
        raise AssertionError(f"{label}: launches in {steps} steps {counts}, expected {want} "
                             f"per step")
    losses = torch.stack(losses).float().cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: losses {losses}")
    kern, launches = device_profile(torch, step, DIST_PROFILE)
    # an NCCL kernel runs from its launch until its peers' data has arrived,
    # so its time holds the wait for the other ranks: counted apart
    nccl_ms = sum(k[1] for k in kern if k[0].startswith("nccl"))
    device_ms = sum(k[1] for k in kern) - nccl_ms
    ms = dt / steps * 1e3
    return {"run": label, "steps": steps, "ms_per_step": ms,
            "edges_per_s": edges_per_step * steps / dt, "loss_first": float(losses[0]),
            "loss_last": float(losses[-1]), "launches": counts, "launches_per_step": want,
            "device_kernel_ms_per_step": device_ms, "nccl_kernel_ms_per_step": nccl_ms,
            "device_busy_share": device_ms / ms if device_ms else None,
            "kernel_launches_per_step": launches,
            "top_kernels_ms_per_step": [[k[0][:80], k[1], k[2]] for k in kern[:8]]}


def multi_gpu_rank(out_dir):
    """Phase 11 (c)-(e), run by every spawned rank: (c) NCE_STEPS partitioned
    NCE steps under each of NCE_MODES (exact launches per step, a profile),
    ``embed_fold`` of the val fold and the replicas' fingerprints; (d)
    DIST_STEPS hier2d steps at configs/ogbn_products_dist.json's width over
    (1, n) or, from 4 cards, (2, n/2), and its exact evaluation against the
    single-device pass; (e) TP_STEPS tensor-parallel steps at the main
    path's width over (n/m, m). Writes ``out_dir/rank<r>.json``."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_sage_torch.data.synthetic import bench_store, sbm_store
    from tpu_sage_torch.dist import mesh
    from tpu_sage_torch.dist.data_parallel import DataParallelTrainer
    from tpu_sage_torch.dist.debug import assert_replicas_equal, tree_fingerprint
    from tpu_sage_torch.dist.halo import all_gather_rows
    from tpu_sage_torch.dist.train import PartitionedTrainer
    from tpu_sage_torch.dist.unsupervised import PartitionedUnsupervisedTrainer
    from tpu_sage_torch.nn.full_graph import embed_all_nodes, embed_all_nodes_partitioned
    from tpu_sage_torch.train.trainer import TrainConfig, build_model, fold_metric_np
    from tpu_sage_torch.train.unsupervised import UnsupConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    me, n_ranks = mesh.rank(), mesh.world()
    device = torch.device("cuda", torch.cuda.current_device())
    store = bench_store()
    recs = {}
    nce_edges = BATCH * (2 + N_NEGATIVES) * (FANOUTS[0] + FANOUTS[0] * FANOUTS[1])
    for label, kw, unsup_kw, csr in NCE_MODES:
        cfg = nce_config(**kw)
        layout = mesh.layout_2d(*mesh.host_layout()) if cfg.halo == "hier2d" else None
        t0 = time.perf_counter()
        tr, graph, fold_ids, fold_w = PartitionedUnsupervisedTrainer.from_store(
            store, cfg, UnsupConfig(WALK_LENGTH, N_NEGATIVES, **unsup_kw), device, csr=csr,
            layout=layout)
        state = tr.init_state()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        mode = "csr" if csr else tr.halo_mode
        rec = _profiled_run(torch, np, f"nce {label}",
                            lambda: tr.train_step(state, graph, fold_ids, fold_w)[1],
                            NCE_STEPS, NCE_WARMUP, nce_dist_per_step(mode, n_ranks), nce_edges)
        rec.update(mode=label, halo=tr.halo_mode, world=n_ranks, setup_s=setup_s, csr=csr,
                   batch_per_rank=tr.batch_per_shard, halo_measured_ms=tr.halo_timings,
                   layout=list(layout.shape) if layout is not None else None)
        if label == "exact":
            ids = store.folds["val"]
            t0 = time.perf_counter()
            z = tr.embed_fold(state, store, ids)
            torch.cuda.synchronize()
            rec["embed_fold_s"] = time.perf_counter() - t0
            if tuple(z.shape) != (len(ids), 2 * DIMS[1]) or not torch.isfinite(z).all():
                raise AssertionError(f"embed_fold: {tuple(z.shape)}")
            assert_replicas_equal(state.model, "params")
            assert_replicas_equal(state.optimizer, "optimizer")
            fps = [None] * n_ranks
            dist.all_gather_object(fps, [float(tree_fingerprint(state.model)),
                                         float(tree_fingerprint(state.optimizer))])
            rec["fingerprints"] = fps
        recs[f"nce_{label}"] = rec
        del tr, graph, state
        torch.cuda.empty_cache()

    shape = (2, n_ranks // 2) if n_ranks >= 4 else (1, n_ranks)
    layout = mesh.layout_2d(*shape)
    cfg = TrainConfig.from_json(DIST_CONFIG).replace(halo="hier2d")
    tr, graph, fold_ids, fold_w = PartitionedTrainer.from_store(store, cfg, device,
                                                                layout=layout)
    state = tr.init_state()
    rec = _profiled_run(torch, np, "hier2d", lambda: tr.train_step(state, graph, fold_ids,
                                                                  fold_w)[1],
                        DIST_STEPS, DIST_WARMUP, dist_per_step("hier2d", n_ranks),
                        cfg.batch_size * (FANOUTS[0] + FANOUTS[0] * FANOUTS[1]))
    rec.update(layout=list(shape), world=n_ranks)
    rec["val_exact"] = tr.evaluate_exact(state, store, "val")
    g_full, _ = tr._full_graph_shard(store)
    sharded = all_gather_rows(embed_all_nodes_partitioned(tr.model, g_full,
                                                          with_head=True))[:store.n_nodes]
    if me == 0:
        single = embed_all_nodes(tr.model, store.to_device(train=False, dtype=torch.bfloat16,
                                                           device=device), with_head=True)
        err, scale = (sharded - single).abs().max().item(), single.abs().max().item()
        ids = store.folds["val"]
        single_val = fold_metric_np(store.task, single.cpu().numpy()[ids], store.targets[ids])
        if not (err <= EXACT_TOL["bfloat16"] * scale and abs(single_val - rec["val_exact"])
                <= 1e-3):
            raise AssertionError(f"hier2d exact pass: max abs err {err} (scale {scale}); val "
                                 f"{rec['val_exact']} vs {single_val}")
        rec.update(exact_vs_single_max_abs_err=err, exact_scale=scale,
                   val_exact_single_device=single_val)
        del single
    assert_replicas_equal(state.model, "hier2d params")
    recs["hier2d"] = rec
    del tr, graph, state, g_full, sharded
    torch.cuda.empty_cache()

    m_axis = 2 if n_ranks % 2 == 0 else 1
    tp_store = store if m_axis == 1 else sbm_store(**{**REDDIT_SBM, "n_classes": TP_CLASSES})
    tcfg = TrainConfig(batch_size=BATCH, n_train_samples=FANOUTS, n_val_samples=FANOUTS,
                       output_dims=DIMS, compute_dtype="bfloat16", lr_init=0.01)
    model = build_model(tcfg, tp_store.n_nodes, tp_store.n_classes, tp_store.feat_dim)
    tr = DataParallelTrainer(model, tcfg, steps_per_epoch=1, task=tp_store.task,
                             model_axis="model",
                             layout=mesh.layout_2d(n_ranks // m_axis, m_axis))
    graph = tp_store.to_device(train=True, dtype=torch.bfloat16, device=device)
    state = tr.init_state(graph)
    perm = np.random.default_rng(7).permutation(tp_store.folds["train"])
    it = iter(torch.as_tensor(perm, dtype=torch.int32, device=device).split(BATCH))

    def tp_step():
        ids = next(it)
        return tr.train_step(state, graph, ids, graph.targets[ids.long()])[1]

    rec = _profiled_run(torch, np, "tensor parallel", tp_step, TP_STEPS, DIST_WARMUP, PER_STEP,
                        BATCH * (FANOUTS[0] + FANOUTS[0] * FANOUTS[1]))
    rec.update(layout=[n_ranks // m_axis, m_axis], world=n_ranks, n_classes=tp_store.n_classes,
               store="bench_store()" if m_axis == 1 else f"Reddit-shaped SBM, "
               f"{TP_CLASSES} classes", local_kernel_shapes={
                   k: list(p.shape) for k, p in model.named_parameters() if p.ndim == 2})
    recs["tensor_parallel"] = rec
    with open(os.path.join(out_dir, f"rank{me}.json"), "w") as f:
        json.dump(recs, f)


def multi_gpu_entry_points(torch, np, tmp):
    """Phase 11 (f): ``tpu_sage_torch.cli.main --partitioned --unsupervised``
    at phase 11's configuration on the 232,965-node store for 1 epoch with a
    checkpoint (``--no-eval``), resumed to 2 with the probe (it must start
    at epoch 1); ``--partitioned --halo hier2d`` with
    configs/ogbn_products_dist.json for 1 epoch; ``tpu_sage_torch.export.main
    --partitioned`` of the unsupervised checkpoint's embeddings against the
    single-device export (within EXACT_TOL), and with ``--coordinator
    127.0.0.1:<free port> --num-processes 1 --process-id 0``, bitwise the
    single-device export. Returns the launch counts of each."""
    import os
    import socket

    from tpu_sage_torch import cli, export, kernels

    ck, logp = os.path.join(tmp, "nce.npz"), os.path.join(tmp, "nce.jsonl")
    graph = ["--synthetic", "reddit-shaped", "--synthetic-nodes", str(SERVING_NODES)]
    base = graph + ["--compute-dtype", "bfloat16", "--batch-size", str(BATCH),
                    "--n-train-samples", "25,10", "--n-val-samples", "25,10", "--output-dims",
                    "128,128", "--partitioned", "--unsupervised", "--walk-length",
                    str(WALK_LENGTH), "--n-negatives", str(N_NEGATIVES), "--checkpoint-path",
                    ck, "--checkpoint-every", "1", "--log-path", logp]
    by_path, walls = {}, {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for epochs, extra in ((1, ["--no-eval"]), (2, [])):
        if cli.main(base + ["--epochs", str(epochs)] + extra) != 0:
            raise AssertionError(f"the partitioned NCE CLI run to {epochs} epochs failed")
    torch.cuda.synchronize()
    walls["nce_cli"] = time.perf_counter() - t0
    by_path["nce_cli"] = kernels.launch_counts()
    with open(logp) as f:
        recs = [json.loads(line) for line in f]
    resumed = [r for r in recs if "resumed_from" in r]
    epochs = [r for r in recs if "unsup_loss" in r]
    probe = [r["probe_val_accuracy"] for r in recs if "probe_val_accuracy" in r]
    if (len(resumed) != 1 or resumed[0]["start_epoch"] != 1
            or [r["epoch"] for r in epochs] != [0, 1]
            or not np.isfinite([r["unsup_loss"] for r in epochs]).all()
            or len(probe) != 1 or not 0 <= probe[0] <= 1):
        raise AssertionError(f"partitioned NCE CLI records {recs}")
    # one card: the ranks run in this process, whose counters see them
    want = nce_dist_per_step("exact", 1)
    if torch.cuda.device_count() == 1 and any(
            (by_path["nce_cli"][k] == 0) != (want[k] == 0) for k in want):
        raise AssertionError(f"partitioned NCE CLI launches {by_path['nce_cli']}")
    log(f"  CLI --partitioned --unsupervised: epochs (epoch, loss) "
        f"{[(r['epoch'], round(r['unsup_loss'], 4)) for r in epochs]}, resumed at epoch 1, "
        f"probe {probe[0]:.4f}, {walls['nce_cli']:.1f} s")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hlog = os.path.join(tmp, "hier2d.jsonl")
    if cli.main(["--config", DIST_CONFIG] + graph + ["--partitioned", "--halo", "hier2d",
                                                    "--epochs", "1", "--log-path", hlog]) != 0:
        raise AssertionError("the hier2d CLI run failed")
    torch.cuda.synchronize()
    walls["hier2d_cli"] = time.perf_counter() - t0
    by_path["hier2d_cli"] = kernels.launch_counts()
    with open(hlog) as f:
        recs = [json.loads(line) for line in f]
    head = next(r for r in recs if "n_shards" in r and "epoch" not in r)
    ep = [r for r in recs if "train_loss" in r]
    if head["halo"] != "hier2d" or len(ep) != 1 or not np.isfinite(ep[0]["train_loss"]):
        raise AssertionError(f"hier2d CLI records {recs}")
    log(f"  CLI --partitioned --halo hier2d: {head}, epoch {ep[0]}, {walls['hier2d_cli']:.1f} s")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outs = {}
    for label, extra in (("nce_export", ["--partitioned"]), ("single_export", []),
                         ("multihost_export", ["--coordinator", f"127.0.0.1:{port}",
                                               "--num-processes", "1", "--process-id", "0"])):
        out = os.path.join(tmp, f"{label}.npy")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if export.main(graph + ["--checkpoint", ck, "--checkpoint-config", "--out", out]
                       + extra) != 0:
            raise AssertionError(f"{label} failed")
        walls[label] = time.perf_counter() - t0
        by_path[label] = kernels.launch_counts()
        outs[label] = np.load(out)
    a, b = outs["nce_export"], outs["single_export"]
    err = float(np.abs(a - b).max())
    if a.shape != (SERVING_NODES, 2 * DIMS[1]) or not np.isfinite(a).all() or \
            err > EXACT_TOL["float32"] * float(np.abs(b).max()):
        raise AssertionError(f"partitioned export of embeddings {a.shape}: max abs err {err}")
    if not np.array_equal(outs["multihost_export"], b):
        raise AssertionError("export with --num-processes 1 differs from the plain export")
    log(f"  export --partitioned of the NCE checkpoint's embeddings {a.shape} in "
        f"{walls['nce_export']:.2f} s: max abs err {err:.3g} against the single-device export "
        f"({walls['single_export']:.2f} s); --coordinator 127.0.0.1:{port} --num-processes 1 "
        f"bitwise it ({walls['multihost_export']:.2f} s)")
    del by_path["single_export"]
    return by_path


def multi_gpu_scaling(np):
    """Phase 11 (g): ``python3 -m tpu_sage_torch.bench.scaling`` over 1, 2,
    4 ranks, capped at the visible cards; each line's efficiency is finite
    and the first is 1."""
    import torch

    counts = ",".join(str(c) for c in (1, 2, 4) if c <= torch.cuda.device_count())
    out = subprocess.run([sys.executable, "-m", "tpu_sage_torch.bench.scaling", "--devices",
                          counts], capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"bench.scaling exited {out.returncode}:\n{out.stdout[-3000:]}\n"
                             f"{out.stderr[-6000:]}")
    recs = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    if [r["n_devices"] for r in recs] != [int(c) for c in counts.split(",")] or \
            recs[0]["efficiency"] != 1.0 or not np.isfinite([r["ms_per_step"] for r in recs]).all():
        raise AssertionError(f"bench.scaling records {recs}")
    log(json.dumps({"scaling": recs}))


def phase_multi_gpu(torch, np, store, graph, smi, peaks):
    """Phase 11: the rest of the multi-GPU path. (a) kernels at its shapes;
    (b) world-1 equivalences; (c)-(e) one spawned NCCL rank per visible
    card: partitioned NCE in every mode, hier2d supervised training and
    tensor parallelism; (f) the entry points; (g) the scaling harness.
    Returns the timed cases and the launch counts by path."""
    import os
    import tempfile

    from tpu_sage_torch.dist import mesh

    results = multi_gpu_kernel_cases(torch, graph, peaks)
    multi_gpu_world1(torch, np, store, graph)
    world = torch.cuda.device_count()
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mesh.spawn(multi_gpu_rank, world, "cuda", (tmp,))
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        for label, rec in ranks[0].items():
            by_path[label] = rec["launches"]
            log(f"  {label}: {rec['ms_per_step']:.3f} ms/step, device "
                f"{rec['device_kernel_ms_per_step']:.3f} ms/step (and NCCL "
                f"{rec['nccl_kernel_ms_per_step']:.3f}), busy "
                f"{(rec['device_busy_share'] or 0) * 100:.1f} %, {rec['edges_per_s'] / 1e6:.1f} M "
                f"sampled edges/s, loss {rec['loss_first']:.4f} -> {rec['loss_last']:.4f}, "
                f"launches per step {rec['launches_per_step']}")
        log(f"  tensor parallel over (data, model) = {tuple(ranks[0]['tensor_parallel']['layout'])}"
            f" on {ranks[0]['tensor_parallel']['store']} ({ranks[0]['tensor_parallel']['n_classes']}"
            f" classes), local kernels {ranks[0]['tensor_parallel']['local_kernel_shapes']}")
        log(json.dumps({"multi_gpu_runs": list(ranks[0].values()), "spawn_wall_s": spawn_s}))
        log(f"  replica fingerprints (params, optimizer) by rank: "
            f"{ranks[0]['nce_exact']['fingerprints']}")
        by_path.update(multi_gpu_entry_points(torch, np, tmp))
    multi_gpu_scaling(np)
    log(smi)
    return results, by_path


# -- phase 12: the auxiliary modules -------------------------------------------------

# the device kernels of the main path's four wrappers, as the profiler's trace
# names them (the __global__ functions of kernels/csrc)
MAIN_PATH_DEVICE_KERNELS = {"sample_hop": "sample_hop_kernel", "gather_rows": "gather_rows_",
                            "gather_fanout_mean": "gather_fanout_mean_kernel",
                            "mean_project": "mean_project_bf16_kernel"}
# bench/capacity.py --probe runs at 0.9 of the modeled max_nodes (each in a
# fresh process), and once past it at 1.15, where it must end in the advice
CAPACITY_PROBES = (("dense bf16 training", ["--frac", "0.9"]),
                   ("int8 training", ["--frac", "0.9", "--int8"]),
                   ("bf16 exact pass", ["--frac", "0.9", "--mode", "infer"]))
CAPACITY_TIMEOUT = 240


def convert_and_train(torch, np, store, tmp):
    """Phase 12 (b): ``bench_store()``'s adjacency as an edge list through the
    port's converter (more than 100,000 edges: its native C++ code), written
    to ``problem.h5`` and read back bitwise, then phase 5's configuration
    trained on it with phase 5's launches per step."""
    import os

    from tpu_sage_torch import native
    from tpu_sage_torch.data.convert import from_edgelist, save_problem_h5
    from tpu_sage_torch.data.problem import NodeProblem

    n, deg = store.adj.shape
    edges = np.stack([np.repeat(np.arange(n, dtype=np.int64), deg),
                      store.adj.reshape(-1).astype(np.int64)], axis=1)
    if not (native.available() and len(edges) > 100_000):
        raise AssertionError("the converter's native library does not build or would not run")
    t0 = time.perf_counter()
    conv = from_edgelist(edges, store.feats, store.targets, store.folds, max_degree=deg, seed=0)
    t1 = time.perf_counter()
    path = os.path.join(tmp, "problem.h5")
    save_problem_h5(conv, path)
    t2 = time.perf_counter()
    problem = NodeProblem.from_h5(path)
    t3 = time.perf_counter()
    back = problem.store
    for k in ("adj", "degrees", "train_adj", "train_degrees", "feats", "targets"):
        a, b = getattr(back, k), getattr(conv, k)
        if not (a.dtype == b.dtype and np.array_equal(a, b)):
            raise AssertionError(f"problem.h5 {k} is not the converted store's")
    for k in conv.folds:
        if not np.array_equal(back.folds[k], conv.folds[k]):
            raise AssertionError(f"problem.h5 fold {k} is not the converted store's")
    rec = {"edges_in": len(edges), "nodes": n, "feat_dim": conv.feat_dim,
           "from_edgelist_s": t1 - t0, "save_problem_h5_s": t2 - t1, "from_h5_s": t3 - t2,
           "file_bytes": os.path.getsize(path), "mean_degree": float(conv.degrees.mean()),
           "mean_train_degree": float(conv.train_degrees.mean()), "native_library": True}
    log(json.dumps({"convert": rec}))
    del edges, conv
    run, counts = train_run(torch, np, "converted problem.h5", problem,
                            aggregator_config("mean"), TRAIN_STEPS, WARMUP_STEPS)
    if run["launches_per_step"] != PER_STEP:
        raise AssertionError(f"converted run: {run['launches_per_step']} launches per step, "
                             f"phase 5's {PER_STEP}")
    return counts


def profile_with_trace(torch, tmp, main_ms):
    """Phase 12 (c): ``bench/profile.py::profile_steps`` at phase 5's
    configuration with a trace, its launches exact, its Chrome trace naming
    the main path's device kernels."""
    import os
    import re

    from tpu_sage_torch import kernels
    from tpu_sage_torch.bench.profile import profile_steps

    trace_dir = os.path.join(tmp, "trace")
    kernels.reset_launch_counts()
    out = profile_steps(trace_dir, steps=TRAIN_STEPS, batch_size=BATCH,
                        compute_dtype="bfloat16", trace=True, fanouts=FANOUTS)
    counts = kernels.launch_counts()
    want = {k: v * (TRAIN_STEPS + 1) for k, v in PER_STEP.items()}  # one untraced step first
    if counts != want:
        raise AssertionError(f"profile_steps launched {counts}, expected {want}")
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    device_names = {e["name"] for e in events if e.get("cat") == "kernel"}
    named = {k: sorted(n for n in device_names if re.search(r"(?<![\w])" + prefix, n))
             for k, prefix in MAIN_PATH_DEVICE_KERNELS.items()}
    missing = [k for k, names in named.items() if not names]
    if missing:
        raise AssertionError(f"the trace names none of {missing}'s device kernels; it has "
                             f"{sorted(n[:80] for n in device_names)}")
    log(json.dumps({"profile_steps": {**out, "phase5_ms_per_step": main_ms,
                                      "trace_events": len(events),
                                      "device_kernels_named": {k: [n[:80] for n in v[:2]]
                                                               for k, v in named.items()}}}))
    return counts


def plain_baseline(torch, main_ms):
    """Phase 12 (d): the plain-PyTorch GraphSAGE step on the card
    (``bench/torch_baseline.py``), which launches no kernel of the port."""
    from tpu_sage_torch import kernels
    from tpu_sage_torch.bench import torch_baseline

    kernels.reset_launch_counts()
    out = torch_baseline.run(device="cuda")
    if any(kernels.launch_counts().values()) or not out["loss_finite"]:
        raise AssertionError(f"the plain baseline launched {kernels.launch_counts()} or its "
                             f"loss is not finite")
    edges = BATCH * (FANOUTS[0] + FANOUTS[0] * FANOUTS[1])
    log(json.dumps({"torch_baseline": {**out, "phase5_ms_per_step": main_ms,
                                       "phase5_edges_per_sec": edges / (main_ms / 1e3)}}))


def capacity_runs(torch):
    """Phase 12 (e): ``bench/capacity.py`` in fresh processes: the measured
    slack and transient constants; the 0.9 probes, each training or serving
    within its modeled bytes with its far-row checks bitwise; the 1.15 probe
    ending in the advice and exit code 1 with no traceback; the envelope.
    The probes size themselves to the card's memory less what this process
    holds (``--hbm-gb``)."""
    import gc
    import os

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    held = total - free
    hbm_gb = str((total - held) / 1024**3)
    log(f"  this process holds {held} B of the card's {total} B; the probes size for the rest")
    root = os.path.dirname(os.path.abspath(__file__))

    def run(*args):
        return subprocess.run([sys.executable, "-m", "tpu_sage_torch.bench.capacity", *args],
                              cwd=root, capture_output=True, text=True, timeout=CAPACITY_TIMEOUT)

    r = run("--measure")
    if r.returncode != 0:
        raise AssertionError(f"capacity --measure failed:\n{r.stderr[-3000:]}")
    measured = json.loads(r.stdout.strip().splitlines()[-1])["measured"]
    # mem_get_info is the card's: the fresh process's own runtime bytes are
    # what it sees outside its allocator less what this process holds
    own = measured["runtime_bytes"] - held
    log(json.dumps({"capacity_measured": {**measured, "this_process_holds": held,
                                          "fresh_process_runtime_bytes": own,
                                          "fresh_process_slack_bytes":
                                              own + measured["allocator_bytes"]}}))
    for label, args in CAPACITY_PROBES:
        r = run("--probe", "--hbm-gb", hbm_gb, *args)
        lines = r.stdout.strip().splitlines()
        if r.returncode != 0 or not lines:
            raise AssertionError(f"capacity probe {label} exited {r.returncode}:\n"
                                 f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
        rec = json.loads(lines[-1])["probe_result"]
        if not (rec["within_model"] and rec["finite"] and all(rec["far_rows_bitwise"].values())):
            raise AssertionError(f"capacity probe {label}: {rec}")
        log(f"  {label}: {lines[0]}")
        log(f"  {label}: peak allocated {rec['peak_allocated']} B against {rec['modeled_bytes']}"
            f" B modeled; {lines[-1]}")
    r = run("--probe", "--hbm-gb", hbm_gb, "--frac", "1.15")
    if r.returncode != 1 or not r.stderr.startswith("error: graph does not fit device memory") \
            or "Traceback" in r.stderr:
        raise AssertionError(f"the 1.15 probe exited {r.returncode}, not 1 with the advice:\n"
                             f"{r.stderr[-3000:]}")
    log(f"  past the limit (1.15): exit 1, {r.stderr.strip()}")
    r = run()
    if r.returncode != 0:
        raise AssertionError(f"the capacity table failed:\n{r.stderr[-3000:]}")
    log(json.dumps({"capacity_table": [json.loads(line) for line in r.stdout.splitlines()]}))


def phase_auxiliary(torch, np, store, main_ms, smi):
    """Phase 12: the auxiliary modules on the card. (a) ``kernels.probe()``;
    (b) conversion and training; (c) the profiler; (d) the plain baseline;
    (e) the capacity model. Returns the launch counts by path."""
    import tempfile

    from tpu_sage_torch.kernels import probe

    t0 = time.perf_counter()
    if not probe():
        raise AssertionError("kernels.probe() returned False")
    log(f"  kernels.probe(): True in {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        by_path = {"converted_train": convert_and_train(torch, np, store, tmp),
                   "profile_steps": profile_with_trace(torch, tmp, main_ms)}
    plain_baseline(torch, main_ms)
    capacity_runs(torch)
    log(smi)
    return by_path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card",
              file=sys.stderr)
        return 2
    import numpy as np

    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.data.synthetic import bench_store
    from tpu_sage_torch.kernels import _build
    from tpu_sage_torch.sample.sampler import sample_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    walls, started = {}, [time.perf_counter(), None]

    def phase(label):
        """Log the phase's start and the last one's wall time."""
        now = time.perf_counter()
        if started[1] is not None:
            walls[started[1]] = now - started[0]
            log(f"  ({started[1]}: {walls[started[1]]:.1f} s wall)")
        started[:] = [now, label]
        if label:
            log(label)

    phase("phase 1: device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"  {smi}")
    name = torch.cuda.get_device_name(0)
    peaks = PEAKS["pcie" if "pcie" in name.lower() else "sxm"]
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; peaks used: "
        f"{peaks[0] / 1e12} TB/s, {peaks[1] / 1e12} TFLOP/s bf16, {peaks[2] / 1e12} f32")

    phase("phase 2: build")
    t0 = time.perf_counter()
    _build.build()
    log(f"  built the {len(_build.SOURCES)} kernel sources with nvcc in {time.perf_counter() - t0:.2f} s "
        f"into {_build.BUILD_DIR}")
    for src in _build.SOURCES:
        log(f"  {src}.cu -Xptxas -v: {'; '.join(ptxas_report(_build.library_path(src)[1] + '.log'))}")

    t0 = time.perf_counter()
    store = bench_store()  # cached for phase 10's spawned ranks
    problem = NodeProblem(store)
    graph = problem.device_graph(train=True, dtype=torch.bfloat16, device="cuda")
    log(f"  bench_store {store.feats.shape} built and uploaded in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    roots = torch.as_tensor(store.folds["train"][:BATCH], dtype=torch.int32, device="cuda")
    levels = sample_tree(graph.adj, graph.degrees, roots, FANOUTS, generator=gen)
    torch.cuda.synchronize()

    phase("phase 3: kernels against their plain versions at their paths' shapes")
    results = phase_kernels(torch, np, graph, levels, peaks)
    check_packed_sampler(torch, graph, roots)

    phase("phase 4: card against CPU")
    phase_reference(torch, np, store, levels)

    phase("phase 5: main path")
    main_counts, main_ms = phase_main_path(torch, np, problem)
    by_path = {"train_steps": main_counts}
    by_path["f32_train"] = phase_main_path_f32(torch, np, problem)

    phase("phase 6: serving path")
    by_path.update(phase_serving(torch, np, smi, peaks))

    phase("phase 7: aggregators")
    agg_results, by_path["aggregators"], sbm = phase_aggregators(torch, np, problem, graph,
                                                                 levels, smi, peaks)
    results += agg_results

    phase("phase 8: storage (int8 features, CSR adjacency)")
    storage_results, storage_paths = phase_storage(torch, np, problem, graph, levels, sbm, smi,
                                                   peaks)
    results += storage_results
    by_path.update(storage_paths)

    phase("phase 9: unsupervised and fused first layer")
    unsup_results, unsup_paths = phase_unsupervised(torch, np, problem, graph, smi, peaks,
                                                    main_ms)
    results += unsup_results
    by_path.update(unsup_paths)

    phase("phase 10: partitioned training (torch.distributed)")
    dist_results, dist_paths = phase_dist(torch, np, store, graph, smi, peaks)
    results += dist_results
    by_path.update(dist_paths)
    phase("phase 11: the rest of the multi-GPU path (partitioned NCE, hier2d, tensor "
          "parallelism, multi-host export, scaling)")
    mg_results, mg_paths = phase_multi_gpu(torch, np, store, graph, smi, peaks)
    results += mg_results
    by_path.update(mg_paths)
    phase("phase 12: auxiliary modules (probe, converter, profiler, baseline, capacity)")
    del graph, levels, problem, sbm
    by_path.update(phase_auxiliary(torch, np, store, main_ms, smi))
    phase(None)

    kernels_line = []
    for name_k, (source, replaces) in SOURCES.items():
        rows = [r for r in results if r["kernel"] == name_k]
        # one step's calls: each main-path case once (the foil: the cases
        # gather_rows has on the main path; select_columns and select_hop,
        # which the main path does not launch: one packed tree's two hops;
        # the int8 and CSR kernels: one step of the main path's configuration
        # on an int8 table and CSR adjacency, csr_tree its one tree and
        # sample_hop_csr that tree's two hops one by one); the
        # exact-inference gathers and the other storage cases have weight 0
        # and stand in "cases". A library time is null where a weighted case
        # has no library call.
        def step(key):
            vals = [r[key] for r in rows if r["weight"]]
            if any(v is None for v in vals):
                return None
            return sum(r[key] * r["weight"] for r in rows if r["weight"])
        kernels_line.append({
            "name": name_k, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(c[name_k] for c in by_path.values()),
            "launches_by_path": {path: c[name_k] for path, c in by_path.items()},
            "launches_per_step": PER_STEP[name_k],
            "launches_per_step_f32": PER_STEP[name_k],
            "launches_per_step_int8_csr": STORAGE_PER_STEP[name_k],
            "launches_per_step_unsupervised": unsup_per_step()[name_k],
            "launches_per_step_unsupervised_int8": unsup_per_step(int8=True)[name_k],
            "launches_per_step_fused_first_layer": FUSED_PER_STEP[name_k],
            "launches_per_step_partitioned": dist_per_step("exact",
                                                           torch.cuda.device_count())[name_k],
            "launches_per_step_partitioned_nce": nce_dist_per_step(
                "exact", torch.cuda.device_count())[name_k],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": step("ms"), "plain_ms": step("plain_ms"), "bound_ms": step("bound_ms"),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                         else "operations"),
            "library_ms": step("library_ms"),
            "cases": [{k: r[k] for k in ("case", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms", "no_reuse_floor_ms")
                       if k in r} for r in rows],
        })
    log(json.dumps({"phase_wall_s": walls}))
    log(f"{smi}")
    log(json.dumps({"kernels": kernels_line,
                    "timing": "median of 20 CUDA-event timings per case, each L2-cold "
                              "(a 2x-L2 buffer written and another read before each call)"}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
