"""Pure data-parallel training: the graph replicated on every rank, the
batch split by rank (counterpart of ``tpu_sage/dist/data_parallel.py``).

The JAX package shards the batch axis of one jitted step and lets GSPMD
insert the gradient all-reduce; here each rank runs the single-device step
on its slice of the batch, and one ``all_reduce`` of one flattened buffer
averages the gradients (the mean over the whole batch, since the slices are
equal), so Adam makes the same update on every rank. For graphs too big to
replicate, use ``dist/train.py::PartitionedTrainer``. Tensor-parallel
``model_axis`` (``param_shardings``) is not ported yet (ROADMAP Queue 1 item
14).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from tpu_sage_torch.dist.mesh import rank, world
from tpu_sage_torch.dist.train import PERM, SAMPLE, all_reduce_grads, rng_seed
from tpu_sage_torch.sample.csr import graph_sample_tree
from tpu_sage_torch.train.trainer import Graph, Trainer, TrainState


class DataParallelTrainer(Trainer):
    """``Trainer`` whose step runs this rank's slice of the batch and
    averages the gradients over the ranks. Sampling draws from a per-rank
    stream; the epoch's batch permutation is the same on every rank."""

    def __init__(self, *args, model_axis: Optional[str] = None, **kwargs):
        if model_axis is not None:
            raise ValueError("tensor-parallel model_axis is not ported yet "
                             "(ROADMAP Queue 1 item 14)")
        super().__init__(*args, **kwargs)

    def init_state(self, graph: Graph) -> TrainState:
        state = super().init_state(graph)
        state.generator.manual_seed(rng_seed(self.config.seed, SAMPLE, 0, rank()))
        return state

    @staticmethod
    def shard_batch(x: torch.Tensor) -> torch.Tensor:
        """This rank's equal slice of ``x`` along dim 0."""
        n, b = world(), x.shape[0]
        if b % n:
            raise ValueError(f"batch of {b} does not split into {n} equal slices")
        return x[rank() * (b // n):(rank() + 1) * (b // n)]

    def train_step(self, state: TrainState, graph: Graph, ids: torch.Tensor,
                   targets: torch.Tensor, levels: Optional[List[torch.Tensor]] = None
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        """One step on the whole batch ``ids``; each rank samples (or takes
        from the injected ``levels`` of the whole batch) and runs its slice."""
        lr = self._lr_fn(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        ids, targets = self.shard_batch(ids), self.shard_batch(targets)
        if levels is None:
            levels = graph_sample_tree(graph, ids, self.model.fanouts(train=True),
                                       generator=state.generator)
        else:
            levels = [self.shard_batch(level) for level in levels]
        state.optimizer.zero_grad(set_to_none=True)
        logits = self.model(levels, graph.feats)
        loss = self.loss_fn(logits, targets)
        loss.backward()
        (loss_mean,) = all_reduce_grads(list(self.model.parameters()), (loss,), divisor=world())
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss_mean, "lr": lr}

    def train_epoch(self, state: TrainState, graph: Graph, fold_ids: torch.Tensor,
                    fold_targets: torch.Tensor) -> Tuple[TrainState, Dict[str, Any]]:
        """One epoch over whole batches of a permutation drawn alike on every
        rank (a CPU generator seeded from the seed and the epoch)."""
        b = self.config.batch_size
        n_batches = fold_ids.shape[0] // b
        if n_batches == 0:
            raise ValueError(f"train fold ({fold_ids.shape[0]} nodes) is smaller than "
                             f"batch_size={b}; lower the batch size")
        epoch = state.step // self.steps_per_epoch
        gen = torch.Generator().manual_seed(rng_seed(self.config.seed, PERM, epoch, 0))
        perm = torch.randperm(fold_ids.shape[0], generator=gen)[:n_batches * b]
        perm = perm.to(fold_ids.device)
        losses = []
        for i in range(n_batches):
            sel = perm[i * b:(i + 1) * b]
            state, m = self.train_step(state, graph, fold_ids[sel], fold_targets[sel])
            losses.append(m["loss"])
        return state, {"loss": torch.stack(losses).mean(), "lr": self._lr_fn(state.step - 1)}
