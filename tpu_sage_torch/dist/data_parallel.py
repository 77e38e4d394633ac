"""Data-parallel training, the graph replicated on every rank and the batch
split, with optional tensor parallelism over a ``model`` axis (counterpart
of ``tpu_sage/dist/data_parallel.py``).

The JAX package shards the batch axis of one jitted step and lets GSPMD
insert the gradient all-reduce; here each rank runs the single-device step
on its slice of the batch, and one ``all_reduce`` of one flattened buffer
averages the gradients (the mean over the whole batch, since the slices are
equal), so Adam makes the same update on every rank. For graphs too big to
replicate, use ``dist/train.py::PartitionedTrainer``.

Tensor parallelism (``model_axis``) lays the ranks out as a ``(data,
model)`` grid (``mesh.Layout2D``, rank ``= data·n_model + model``) and keeps
the JAX package's rule (``param_shardings``): every 2-D parameter named
``kernel`` is split along its output dimension over the model group, its
Adam moments with it, and everything else is replicated. Each split
``Dense`` is column-parallel: the rank computes its output columns (the mean
aggregator's neighbor branch still through ``mean_project``, on its slice
of ``W``), the columns are all-gathered over the model group, the gather's
backward takes the rank's slice of the gradient, and the input's gradient
is all-reduced over the model group. The batch is split over the data
index, so a model group samples and sees the same tree. Split leaves'
gradients are averaged over the data group, replicated ones over all ranks.
A width the model axis does not divide raises, as ``jax.device_put`` does.
Checkpoints hold the gathered kernels and moments, in the single-device
layout (``save``/``load``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from tpu_sage_torch.dist.halo import all_gather_rows
from tpu_sage_torch.dist.mesh import Layout2D, layout_2d, rank, world
from tpu_sage_torch.dist.train import PERM, SAMPLE, all_reduce_grads, rng_seed
from tpu_sage_torch.nn.dense import Dense
from tpu_sage_torch.nn.params import flax_key
from tpu_sage_torch.sample.csr import graph_sample_tree
from tpu_sage_torch.train.checkpoint import load_checkpoint, save_checkpoint
from tpu_sage_torch.train.trainer import Graph, Trainer, TrainState, build_optimizer


def param_shardings(model: torch.nn.Module, model_axis: Optional[str]) -> Dict[str, tuple]:
    """Each parameter's placement by flax key, as PartitionSpec tuples:
    ``(None, model_axis)`` for every 2-D leaf named ``kernel`` (split along
    its output dimension), ``()`` (replicated) for the rest and for every
    leaf when ``model_axis`` is None. The rule is the JAX package's; it
    applies to each parameter's Adam moments alike."""
    return {flax_key(name): ((None, model_axis) if model_axis is not None and p.ndim == 2
                             and name.rsplit(".", 1)[-1] == "kernel" else ())
            for name, p in model.named_parameters()}


def split_kernels(model: torch.nn.Module, n_model: int, model_axis: str = "model"
                  ) -> List[Tuple[str, Dense]]:
    """The ``(name, Dense)`` pairs whose kernels the rule splits, after
    checking that ``n_model`` divides every one's output width (a
    ``ValueError`` naming the leaf and the sizes otherwise)."""
    specs = param_shardings(model, model_axis)
    out = []
    for name, mod in model.named_modules():
        if isinstance(mod, Dense) and specs[flax_key(f"{name}.kernel")]:
            width = mod.kernel.shape[1]
            if width % n_model:
                raise ValueError(f"{flax_key(name + '.kernel')}: output width {width} of a "
                                 f"{tuple(mod.kernel.shape)} kernel is not divisible by the "
                                 f"{n_model} shards of model axis {model_axis!r}")
            out.append((name, mod))
    return out


def _gather_columns(y: torch.Tensor, group, n: int) -> torch.Tensor:
    parts = all_gather_rows(y.reshape(-1, y.shape[-1]), group).view(n, *y.shape)
    return parts.movedim(0, -2).reshape(*y.shape[:-1], n * y.shape[-1])


class _Enter(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the model group (in
    f32: a bf16 sum of two rounds once, as in bf16)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        acc = g.float().contiguous()
        dist.all_reduce(acc, group=ctx.group)
        return acc.to(g.dtype), None


class _Gather(torch.autograd.Function):
    """The output columns all-gathered along the last dimension; the
    gradient's slice of this rank's columns back."""

    @staticmethod
    def forward(ctx, y, group, n, index):
        ctx.index, ctx.width = index, y.shape[-1]
        return _gather_columns(y, group, n)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None, None, None


class ColumnParallel:
    """A split ``Dense``'s hooks (``nn/dense.py``): its rank ``index`` of
    ``size`` in the model ``group``."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.group) if x.requires_grad else x

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(y, self.group, self.size, self.index)

    def split(self, full: torch.Tensor) -> torch.Tensor:
        w = full.shape[-1] // self.size
        return full[..., self.index * w:(self.index + 1) * w].clone()

    def unsplit(self, local: torch.Tensor) -> torch.Tensor:
        return _gather_columns(local.detach(), self.group, self.size)


class DataParallelTrainer(Trainer):
    """``Trainer`` whose step runs this rank's slice of the batch and
    averages the gradients over the ranks. Sampling draws from a stream per
    data index; the epoch's batch permutation is the same on every rank.

    ``model_axis`` (a name, as the JAX package's mesh axis) turns on tensor
    parallelism over ``layout``, a ``(data, model)`` ``mesh.Layout2D``
    (default ``(world, 1)``, built in ``init_state`` inside the process
    group). ``init_state`` splits the kernels once per trainer."""

    def __init__(self, *args, model_axis: Optional[str] = None,
                 layout: Optional[Layout2D] = None, **kwargs):
        super().__init__(*args, **kwargs)
        if model_axis is not None and self.config.fuse_first_layer:
            raise ValueError("tensor-parallel model_axis does not split the fused first "
                             "layer's whole-table products; set fuse_first_layer=False")
        self.model_axis = model_axis
        self.layout = layout
        self._tp: Optional[ColumnParallel] = None
        self._split: List[Tuple[str, Dense]] = []

    # -- layout ---------------------------------------------------------------

    def _data(self) -> Tuple[int, int]:
        """``(data index, data-parallel ranks)``."""
        if self.layout is None:
            return rank(), world()
        return self.layout.outer, self.layout.shape[0]

    def init_state(self, graph: Graph) -> TrainState:
        state = super().init_state(graph)
        if self.model_axis is not None:
            if self.layout is None:
                self.layout = layout_2d(world(), 1)
            self._split = split_kernels(self.model, self.layout.shape[1], self.model_axis)
            self._tp = ColumnParallel(self.layout.inner_group, self.layout.shape[1],
                                      self.layout.inner)
            self._resplit(state)
        state.generator.manual_seed(rng_seed(self.config.seed, SAMPLE, 0, self._data()[0]))
        return state

    def _reshard(self, state: TrainState, fn) -> None:
        """Replace every split kernel and its Adam moments by ``fn`` of them
        and rebuild the optimizer over the new parameters, its state kept."""
        opt = state.optimizer
        old = {id(p): opt.state.get(p, {}) for p in self.model.parameters()}
        moved = {}
        for _, mod in self._split:
            new = torch.nn.Parameter(fn(mod.kernel.detach()))
            moved[id(new)] = {k: (fn(v) if torch.is_tensor(v) and v.ndim == 2 else v)
                              for k, v in old.pop(id(mod.kernel)).items()}
            mod.kernel = new
        old.update(moved)
        lr = opt.param_groups[0]["lr"]
        state.optimizer = build_optimizer(self.config, self.model.parameters(), lr)
        for p in self.model.parameters():
            if old.get(id(p)):
                state.optimizer.state[p] = old[id(p)]

    def _unsplit(self, state: TrainState) -> None:
        """Gather the split kernels and moments whole (the single-device
        model)."""
        for _, mod in self._split:
            mod.tp = None
        self._reshard(state, self._tp.unsplit)

    def _resplit(self, state: TrainState) -> None:
        for _, mod in self._split:
            mod.tp = self._tp
        self._reshard(state, self._tp.split)

    # -- checkpoints ----------------------------------------------------------

    def save(self, path: str, state: TrainState, config=None, write: bool = True) -> None:
        """Write ``state`` in the single-device layout (the split kernels and
        moments gathered; every rank takes part, ``write`` ranks write)."""
        if self._split:
            self._unsplit(state)
        if write:
            save_checkpoint(path, state, config=config)
        if self._split:
            self._resplit(state)

    def load(self, path: str, state: TrainState) -> TrainState:
        """Restore a single-device-layout checkpoint and split it."""
        if not self._split:
            return load_checkpoint(path, state)
        self._unsplit(state)
        state = load_checkpoint(path, state)
        self._resplit(state)
        return state

    # -- the step -------------------------------------------------------------

    def shard_batch(self, x: torch.Tensor) -> torch.Tensor:
        """This data index's equal slice of ``x`` along dim 0."""
        d, n = self._data()
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch of {b} does not split into {n} equal slices")
        return x[d * (b // n):(d + 1) * (b // n)]

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
        split = {id(mod.kernel) for _, mod in self._split}
        params = list(self.model.parameters())
        if split:
            all_reduce_grads([p for p in params if id(p) in split], (),
                             divisor=self._data()[1], group=self.layout.outer_group)
        (loss_mean,) = all_reduce_grads([p for p in params if id(p) not in split], (loss,),
                                        divisor=world())
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
