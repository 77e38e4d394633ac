"""Node-sharded unsupervised training: NCE over walks through the halo
exchange (counterpart of ``tpu_sage/dist/unsupervised.py``).

The objective of ``train/unsupervised.py`` on the partitioned path of
``dist/train.py``. One step, on every rank:

1. anchors: ``batch_per_shard`` ids from the rank's fold group by the
   epoch's permutation (``epoch_perm``/``perm_batch``, as supervised);
2. positives: ``walk_length`` one-hop hops through
   ``sample_level_distributed``, each fetching the frontier's adjacency ‖
   degree rows by halo exchange, so walks cross shards (each hop's overflow
   counted);
3. negatives over the global real-node range ``[0, n_real)`` (never a
   partition padding id): uniform, or ∝ ``max(degree, 1)^neg_power``
   through the replicated logits ``neg_power·log(max(deg, 1))``
   (``neg_logits``) and ``torch.multinomial``: JAX's ``categorical`` in
   distribution, not in draws;
4. one tree over anchors ‖ positives ‖ negatives (one halo cascade), the
   levels' features (the deepest pre-reduced by its owners), the encoder
   (``encode_gathered``), ``nce_loss · w / max(Σ_ranks w, 1e-12)``, and the
   supervised step's one ``all_reduce`` (loss, overflow, gradients), then
   the same Adam step on every rank.

The walk, the negatives and the tree draw from their own generators,
seeded per epoch from ``rng_seed(seed, stream, epoch, rank)``, so an epoch
replays on any shard count; ``train_step`` takes injected anchors, walk
uniforms, negatives or levels (the parity seam).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from tpu_sage_torch.dist.halo import all_gather_rows
from tpu_sage_torch.dist.mesh import Layout2D, rank
from tpu_sage_torch.dist.partition import shard_fold_masked
from tpu_sage_torch.dist.train import (EVAL, PartitionedTrainer, _rank_setup, _zero,
                                       all_reduce_grads, log_head, resolve_layout, rng_seed,
                                       sample_level_distributed)
from tpu_sage_torch.graph.graph_data import GraphStore
from tpu_sage_torch.train.checkpoint import BestTracker, maybe_checkpoint, resume_state
from tpu_sage_torch.train.trainer import TrainConfig, TrainState, build_model
from tpu_sage_torch.train.unsupervised import (UnsupConfig, logistic_probe, nce_loss,
                                               resolve_probe_every, unsup_gather_defaults)

WALK, NEG = 3, 4  # rng_seed streams of the walk and the negatives (the tree's is SAMPLE)


def neg_logits(store: GraphStore, neg_power: float, device) -> Optional[torch.Tensor]:
    """The replicated degree-smoothed logits ``neg_power · log(max(deg, 1))``
    (f32, one per real node, from the full graph's degrees), or None for
    uniform negatives (``neg_power`` 0)."""
    if neg_power <= 0:
        return None
    logits = neg_power * np.log(np.maximum(store.degrees.astype(np.float64), 1.0))
    return torch.as_tensor(logits.astype(np.float32), device=device)


def draw_global_negatives(count: int, n_real: int, logits: Optional[torch.Tensor],
                          generator: torch.Generator, device) -> torch.Tensor:
    """``count`` int32 negatives in ``[0, n_real)``: uniform, or drawn with
    probability ∝ ``exp(logits)`` over the ``n_real`` real nodes."""
    if logits is not None:
        return torch.multinomial(torch.exp(logits), count, replacement=True,
                                 generator=generator).to(torch.int32)
    return torch.randint(0, n_real, (count,), generator=generator, device=device,
                         dtype=torch.int32)


class PartitionedUnsupervisedTrainer(PartitionedTrainer):
    """``PartitionedTrainer`` with the NCE objective: the same front end
    (shards, fold groups, halo modes, layout), its own step and epoch, and
    ``embed_fold`` for the probe in place of the supervised evaluation."""

    def __init__(self, model, config: TrainConfig, unsup: UnsupConfig, shard_size: int,
                 steps_per_epoch: int, device, n_real_nodes: int, csr_window: int = 0,
                 layout: Optional[Layout2D] = None, neg_logits: Optional[torch.Tensor] = None):
        super().__init__(model, config, shard_size, steps_per_epoch, device,
                         task="classification", csr_window=csr_window, layout=layout)
        self.unsup = unsup
        self.n_real_nodes = n_real_nodes
        self.neg_logits = neg_logits
        self.walk_gen = torch.Generator(device=self.device)
        self.neg_gen = torch.Generator(device=self.device)

    @classmethod
    def from_store(cls, store: GraphStore, config: TrainConfig, unsup: UnsupConfig,
                   device, csr: bool = False, layout: Optional[Layout2D] = None):
        """As ``PartitionedTrainer.from_store``, with the unsupervised
        workload's gather defaults; ``halo='measured'`` races the real NCE
        epoch, not the supervised one. Returns ``(trainer, graph, fold_ids,
        fold_w)``."""
        device = torch.device(device)
        config = unsup_gather_defaults(config)
        graph, fold_ids, fold_w, m, spe = cls._sharded_inputs(store, config, device, csr)
        model = build_model(config, store.n_nodes, max(store.n_classes, 2), store.feat_dim)
        kw = dict(csr_window=getattr(graph, "window", 0), layout=layout,
                  neg_logits=neg_logits(store, unsup.neg_power, device))
        make = lambda c: cls(model, c, unsup, m, spe, device, store.n_nodes, **kw)  # noqa: E731
        config, raced = cls._race(config, make, graph, fold_ids, fold_w, device, layout)
        trainer = make(config)
        trainer._adopt(store, graph, raced)
        return trainer, graph, fold_ids, fold_w

    def _seed_epoch(self, state: TrainState, epoch: int) -> None:
        super()._seed_epoch(state, epoch)
        self.walk_gen.manual_seed(rng_seed(self.config.seed, WALK, epoch, rank()))
        self.neg_gen.manual_seed(rng_seed(self.config.seed, NEG, epoch, rank()))

    def walk(self, graph, ids: torch.Tensor, us: Optional[Sequence[torch.Tensor]] = None):
        """Positives: ``walk_length`` one-hop distributed hops from ``ids``
        (``us``: each hop's ``(B, 1)`` uniforms, else the walk stream's).
        Returns ``(positives, n_overflow)``."""
        view = self.adjacency_view(graph)
        window = getattr(graph, "window", 0)
        os_fn = self._owner_select(graph)
        pos, ovf = ids.to(torch.int32), _zero(ids)
        for hop in range(self.unsup.walk_length):
            pos, o = sample_level_distributed(view, pos, 1, self.gather, pair_window=window,
                                              owner_select=os_fn, generator=self.walk_gen,
                                              u=None if us is None else us[hop])
            ovf = ovf + o
        return pos, ovf

    def train_step(self, state: TrainState, graph, fold_ids: torch.Tensor, fold_w: np.ndarray,
                   *, ids: Optional[torch.Tensor] = None,
                   us: Optional[Sequence[torch.Tensor]] = None,
                   neg: Optional[torch.Tensor] = None,
                   levels: Optional[Sequence[torch.Tensor]] = None):
        """One NCE step on every rank. Injected ``ids`` (this rank's anchors,
        its own nodes), ``us`` (the walk's uniforms), ``neg`` and ``levels``
        (the tree over anchors ‖ positives ‖ negatives, replacing the three
        draws) give the parity seam. Returns ``(state, {"loss",
        "halo_overflow", "lr"})``, summed over the ranks."""
        w = float(fold_w[rank()])
        total = float(np.sum(fold_w))
        b, q = self.batch_per_shard, self.unsup.n_negatives
        lr = self._lr_fn(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        ovf = _zero(fold_ids)
        if levels is None:
            batch = self._batch_ids(state, fold_ids, w)
            ids = batch if ids is None else ids
            with torch.no_grad():
                pos, ovf = self.walk(graph, ids, us)
                if neg is None:
                    neg = draw_global_negatives(b * q, self.n_real_nodes, self.neg_logits,
                                                self.neg_gen, self.device)
                roots = torch.cat([ids.to(torch.int32), pos, neg.to(torch.int32)])
                levels, o = self.sample_levels(graph, roots, self.model.fanouts(train=True),
                                               state.generator)
                ovf = ovf + o
        levels = list(levels)
        b = levels[0].shape[0] // (2 + q)
        state.optimizer.zero_grad(set_to_none=True)
        z, o = self.forward_levels(graph, levels, head=False)
        scale = torch.tensor(w, dtype=torch.float32) / torch.tensor(max(total, 1e-12),
                                                                     dtype=torch.float32)
        loss_s = nce_loss(z[:b], z[b:2 * b], z[2 * b:].reshape(b, q, -1)) * scale.item()
        loss_s.backward()
        loss, overflow = all_reduce_grads(list(self.model.parameters()), (loss_s, ovf + o))
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss, "halo_overflow": overflow, "lr": lr}

    @torch.no_grad()
    def embed_fold(self, state: TrainState, store: GraphStore, ids: np.ndarray,
                   seed: int = 0) -> torch.Tensor:
        """Embeddings ``(len(ids), D)`` f32 of any node set, in the order of
        ``ids``, through the partitioned path on the full graph (the probe's
        protocol): each rank embeds the ids it owns, in chunks of
        ``batch_per_shard`` from trees of the evaluation fanouts, and every
        rank gets all of them. Run by every rank."""
        graph, m = self._full_graph_shard(store)
        bps = self.batch_per_shard
        tbl, _ = shard_fold_masked(np.asarray(ids), self.n_shards, m, pad_to_multiple=bps)
        me = rank()
        mine = torch.as_tensor(tbl[me], dtype=torch.int32, device=self.device).view(-1, bps)
        gen = torch.Generator(device=self.device).manual_seed(rng_seed(seed, EVAL, 0, me))
        fanouts = self.model.fanouts(train=False)
        chunks = []
        for cids in mine:
            levels, _ = self.sample_levels(graph, cids, fanouts, gen)
            chunks.append(self.forward_levels(graph, levels, head=False)[0].float())
        local = torch.cat(chunks)
        z = all_gather_rows(local).view(self.n_shards, *local.shape)
        # shard_fold_masked groups the ids by owner in their order: each
        # shard's first rows are its ids, in the caller's order
        owners = torch.as_tensor(np.asarray(ids) // m, device=self.device)
        out = torch.empty((len(ids), z.shape[-1]), dtype=z.dtype, device=self.device)
        for s in range(self.n_shards):
            sel = torch.nonzero(owners == s)[:, 0]
            out[sel] = z[s, :sel.shape[0]]
        return out


def fit_unsupervised_partitioned(
    store: GraphStore,
    config: TrainConfig,
    unsup: Optional[UnsupConfig] = None,
    log=None,
    resume_from: Optional[str] = None,
    checkpoint_every: int = 0,
    probe: bool = True,
    csr: bool = False,
    device=None,
    layout: Optional[Layout2D] = None,
):
    """``fit_unsupervised`` on the node-sharded path, run by every rank of a
    process group: one JSON line per epoch (rank 0 logs and writes the
    checkpoints), periodic checkpoints and resume at the epoch after the
    checkpoint's step, and (``probe``, classification tasks) the logistic
    probe on ``embed_fold``'s embeddings every ``unsup.probe_every`` epochs
    and after the last, on which ``patience``/``save_best`` key. ``device``
    and ``layout`` as ``fit_partitioned``. Returns ``(trainer, state,
    history)`` on every rank."""
    unsup = unsup or UnsupConfig()
    device, log, lead = _rank_setup(device, log)
    trainer, graph, fold_ids, fold_w = PartitionedUnsupervisedTrainer.from_store(
        store, config, unsup, device, csr=csr, layout=resolve_layout(config, layout))
    config = trainer.config
    log_head(trainer, log, csr)
    state = trainer.init_state()
    state, start_epoch = resume_state(state, resume_from, trainer.steps_per_epoch, log)
    can_probe = probe and store.task == "classification"
    tracker = BestTracker(config, resume_from, log, write=lead)
    probe_every, tracker = resolve_probe_every(unsup, tracker, can_probe, log)

    def run_probe(st):
        return logistic_probe(lambda ids: trainer.embed_fold(st, store, ids), store.targets,
                              store.folds)

    history = []
    for epoch in range(start_epoch, config.epochs):
        t0 = time.time()
        state, m = trainer.train_epoch(state, graph, fold_ids, fold_w)
        rec = {"epoch": epoch, "unsup_loss": float(m["loss"]),
               "elapsed": round(time.time() - t0, 4), "n_shards": trainer.n_shards}
        if trainer.halo_mode == "bucketed":
            rec["halo_overflow"] = int(m["halo_overflow"])
        acc = None
        if can_probe and probe_every > 0 and (epoch + 1) % probe_every == 0:
            acc = run_probe(state)
            if acc is not None:
                rec["probe_val_accuracy"] = acc
        history.append(rec)
        log(rec)
        maybe_checkpoint(state, resume_from, checkpoint_every, epoch, log, config=config,
                         write=lead)
        if tracker.update(acc, state):
            break
    if can_probe and history and "probe_val_accuracy" not in history[-1]:
        acc = run_probe(state)
        if acc is not None:
            history[-1]["probe_val_accuracy"] = acc
            log({"probe_val_accuracy": acc})
            tracker.update(acc, state)
    return trainer, state, history
