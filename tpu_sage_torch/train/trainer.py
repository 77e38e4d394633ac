"""Training machinery: the step, on-device epoch batching, evaluation and the
fit loop (counterpart of ``tpu_sage/train/trainer.py``).

- Fold ids and targets live on the device; an epoch's batches are a
  device-side ``randperm`` over the fold, walked by a Python loop of steps.
- The LR schedule is a function of the step counter, set on the optimizer
  before every step (the reference's per-batch schedule).
- Evaluation pads a fold to whole batches and weights counts with a mask,
  so every fold node counts exactly once.
- Randomness: parameter init draws from a CPU ``torch.Generator`` seeded
  with ``TrainConfig.seed`` (the same values on every device); sampling and
  the epoch permutations draw from a generator on the device seeded with
  ``seed + 2``; evaluation uses a fresh generator seeded with ``seed + 1`` on
  every call, as the reference reuses one eval key.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from tpu_sage_torch import tracing
from tpu_sage_torch.graph.graph_data import CSRDeviceGraph, DeviceGraph
from tpu_sage_torch.nn.full_graph import embed_all_nodes, exact_supported
from tpu_sage_torch.nn.model import GSSupervised, default_layer_specs
from tpu_sage_torch.sample.csr import graph_sample_tree
from tpu_sage_torch.train.checkpoint import BestTracker, maybe_checkpoint, resume_state
from tpu_sage_torch.train.losses import loss_lookup
from tpu_sage_torch.train.lr import LRSchedule
from tpu_sage_torch.train.metrics import metric_lookup

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
Graph = Union[DeviceGraph, CSRDeviceGraph]  # what the step samples from


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Flat, json-loadable run config with the reference's field names, so the
    presets in ``configs/`` load unchanged. The gather-lowering knobs
    change no value: ``gather_form`` and ``gather_form_deep`` pick the
    gathers' out-of-range form (``nn/model.py``), ``gather_chunks`` is
    ignored; the partitioned path's (``halo``, ``halo_measure_steps``,
    ``halo_capacity_factor``, ``csr_owner_select``) are read by
    ``dist/train.py`` and ignored on one device; ``halo_chunks`` changes no
    value there either (the port does not split the exchange)."""

    aggregator_class: str = "mean"
    prep_class: str = "identity"
    n_train_samples: Tuple[int, ...] = (25, 10)
    n_val_samples: Tuple[int, ...] = (25, 10)
    output_dims: Tuple[int, ...] = (128, 128)
    batch_size: int = 256
    epochs: int = 10
    lr_init: float = 0.01
    lr_schedule: str = "constant"
    lr_kwargs: Tuple[Tuple[str, Any], ...] = ()
    weight_decay: float = 0.0
    optimizer: str = "adam"
    seed: int = 123
    combine: str = "concat"
    normalize: bool = True
    agg_hidden_dim: int = 512
    embedding_dim: int = 64
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    feature_int8: bool = False
    fuse_first_layer: bool = False
    gather_form: Optional[str] = None
    gather_form_deep: Optional[str] = None
    gather_chunks: Optional[int] = None
    fuse_last: str = "auto"
    int8_summean: bool = True
    patience: int = 0
    save_best: bool = False
    exact_val: bool = False
    exact_val_every: int = 1
    halo: str = "auto"
    halo_measure_steps: Optional[int] = None
    halo_capacity_factor: float = 2.0
    csr_owner_select: bool = True
    halo_chunks: int = 10

    @classmethod
    def from_dict(cls, d: dict, origin: str = "<dict>") -> "TrainConfig":
        """Build from a plain dict (a json preset) with the tuple-field
        coercions; keys starting with ``_`` are comments, unknown keys raise."""
        d = {k: v for k, v in d.items() if not k.startswith("_")}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown config keys in {origin}: {sorted(unknown)}; "
                f"valid keys: {sorted(known)}"
            )
        for k in ("n_train_samples", "n_val_samples", "output_dims"):
            if k in d:
                d[k] = tuple(d[k])
        if "lr_kwargs" in d:
            kw = d["lr_kwargs"]
            pairs = kw.items() if isinstance(kw, dict) else (tuple(p) for p in kw)
            d["lr_kwargs"] = tuple(sorted(pairs))
        return cls(**d)

    @classmethod
    def from_json(cls, path: str) -> "TrainConfig":
        with open(path) as f:
            d = json.load(f)
        return cls.from_dict(d, origin=path)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def check_ported(config: TrainConfig) -> None:
    """Raise ``ValueError`` for a config naming a dtype, optimizer or LR
    schedule the port does not know."""
    if config.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype: {config.compute_dtype!r}")
    if config.optimizer not in ("adam", "sgd"):
        raise ValueError(f"unknown optimizer: {config.optimizer}")
    if config.lr_schedule not in LRSchedule.lookup:
        raise ValueError(f"unknown lr_schedule: {config.lr_schedule!r}")


def fold_metric_np(task: str, logits: np.ndarray, targets: np.ndarray) -> float:
    """Fold metric from full-graph logits on the host, with the definitions
    of the masked eval (``Trainer.eval_fold``): accuracy, micro-F1, negated
    MSE or negated MAE."""
    if task == "classification":
        return float((logits.argmax(-1) == targets.astype(np.int64)).mean())
    if task == "multilabel_classification":
        preds = (logits > 0).astype(np.float64)
        t = targets.astype(np.float64)
        tp = float((preds * t).sum())
        fp = float((preds * (1 - t)).sum())
        fn = float(((1 - preds) * t).sum())
        return 2 * tp / max(2 * tp + fp + fn, 1e-12)
    err = logits - targets.astype(logits.dtype)
    if task == "regression":
        return float(-(err ** 2).mean())
    return float(-np.abs(err).mean())


def build_model(config: TrainConfig, n_nodes: int, n_classes: int,
                feat_dim: int) -> GSSupervised:
    """The model on the CPU, parameters not yet drawn (``Trainer.init_state``
    draws them). ``n_nodes`` sizes the node-embedding prep's table."""
    check_ported(config)
    specs = default_layer_specs(
        fanouts=config.n_train_samples,
        val_fanouts=config.n_val_samples,
        output_dims=config.output_dims,
    )
    return GSSupervised(
        layer_specs=specs,
        n_classes=n_classes,
        feat_dim=feat_dim,
        aggregator_class=config.aggregator_class,
        prep_class=config.prep_class,
        n_nodes=n_nodes,
        embedding_dim=config.embedding_dim,
        combine=config.combine,
        normalize=config.normalize,
        agg_hidden_dim=config.agg_hidden_dim,
        dtype=None if config.compute_dtype == "float32" else COMPUTE_DTYPES[config.compute_dtype],
        fuse_last=config.fuse_last,
        int8_summean=config.int8_summean,
        fuse_first_layer=config.fuse_first_layer,
        gather_form=config.gather_form,
        gather_form_deep=config.gather_form_deep,
    )


def make_schedule(config: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """``lr(step) = schedule(step / steps_per_epoch)``."""
    kwargs = dict(config.lr_kwargs)
    kwargs.setdefault("epochs", float(config.epochs))
    sched = LRSchedule.lookup[config.lr_schedule](lr_init=config.lr_init, **kwargs)

    def lr_fn(step: int) -> float:
        return sched(np.float32(step) / np.float32(steps_per_epoch))

    return lr_fn


def build_optimizer(config: TrainConfig, params, lr: float) -> torch.optim.Optimizer:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8), or SGD.
    ``weight_decay`` is an L2 term added to the gradient, as the reference's
    ``add_decayed_weights`` before the optimizer: ``Adam(weight_decay=)``,
    not AdamW."""
    if config.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=config.weight_decay)
    if config.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr, weight_decay=config.weight_decay)
    raise ValueError(f"unknown optimizer: {config.optimizer}")


@dataclasses.dataclass
class TrainState:
    """What a step changes: the model's parameters, the optimizer's state,
    the step counter and the sampling generator."""

    model: GSSupervised
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator  # sampling and epoch permutations, on the device


class Trainer:
    """Owns the model, the loss, the metric and the LR schedule."""

    def __init__(
        self,
        model: GSSupervised,
        config: TrainConfig,
        steps_per_epoch: int,
        loss_fn: Optional[Callable] = None,
        metric_fn: Optional[Callable] = None,
        task: str = "classification",
    ):
        # full-f32 products on the card: TF32 keeps ~3 decimal digits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.config = config
        self.task = task
        self.loss_fn = loss_fn or loss_lookup[task]
        self.metric_fn = metric_fn or metric_lookup[task]
        self.steps_per_epoch = steps_per_epoch
        self._lr_fn = make_schedule(config, steps_per_epoch)

    def init_state(self, graph: Graph) -> TrainState:
        """Draw fresh parameters, move the model to the graph's device and
        build the optimizer and the sampling generator."""
        self.model.reset_parameters(torch.Generator().manual_seed(self.config.seed))
        self.model.to(graph.device)
        gen = torch.Generator(device=graph.device).manual_seed(self.config.seed + 2)
        opt = build_optimizer(self.config, self.model.parameters(), self._lr_fn(0))
        return TrainState(model=self.model, optimizer=opt, step=0, generator=gen)

    def train_step(
        self,
        state: TrainState,
        graph: Graph,
        ids: torch.Tensor,
        targets: torch.Tensor,
        levels: Optional[List[torch.Tensor]] = None,
    ) -> Tuple[TrainState, Dict[str, Any]]:
        """One optimizer step on a batch. ``levels`` injects a sampled tree
        (parity tests); by default the tree is sampled from ``graph``."""
        dev = ids.device
        with tracing.span("tsg.train.step", dev):
            lr = self._lr_fn(state.step)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            if levels is None:
                with tracing.span("tsg.train.sample", dev):
                    levels = graph_sample_tree(graph, ids, self.model.fanouts(train=True),
                                               generator=state.generator)
            if tracing.enabled():
                tracing.count(edges=sum(level.numel() for level in levels[1:]))
            state.optimizer.zero_grad(set_to_none=True)
            with tracing.span("tsg.train.forward", dev):
                logits = self.model(levels, graph.feats)
                loss = self.loss_fn(logits, targets)
            with tracing.span("tsg.train.backward", dev):
                loss.backward()
            with tracing.span("tsg.train.optimizer", dev):
                state.optimizer.step()
            state.step += 1
            logits = logits.detach()
            metric = self.metric_fn(logits, targets)
        return state, {"loss": loss.detach(), "metric": metric, "lr": lr}

    def train_epoch(
        self,
        state: TrainState,
        graph: Graph,
        fold_ids: torch.Tensor,      # (n_fold,) int32 on the device
        fold_targets: torch.Tensor,  # (n_fold, ...) aligned with fold_ids
    ) -> Tuple[TrainState, Dict[str, Any]]:
        """One epoch: device permutation → whole batches → a loop of steps."""
        b = self.config.batch_size
        n_batches = fold_ids.shape[0] // b
        if n_batches == 0:
            raise ValueError(
                f"train fold ({fold_ids.shape[0]} nodes) is smaller than "
                f"batch_size={b}; lower the batch size"
            )
        n = n_batches * b
        perm = torch.randperm(fold_ids.shape[0], generator=state.generator,
                              device=fold_ids.device)[:n]
        ids_b = fold_ids[perm].view(n_batches, b)
        tgt_b = fold_targets[perm].view(n_batches, b, *fold_targets.shape[1:])
        losses = []
        for i in range(n_batches):
            state, m = self.train_step(state, graph, ids_b[i], tgt_b[i])
            losses.append(m["loss"])
        return state, {"loss": torch.stack(losses).mean(), "lr": self._lr_fn(state.step - 1)}

    @torch.no_grad()
    def eval_fold(
        self,
        graph: Graph,
        generator: torch.Generator,
        ids_padded: torch.Tensor,      # (n_batches, B) int32
        targets_padded: torch.Tensor,  # (n_batches, B, ...)
        mask_padded: torch.Tensor,     # (n_batches, B) float32
    ) -> Dict[str, torch.Tensor]:
        """Masked full-fold evaluation with the val fanouts on ``graph``.
        Mask-weighted global counts make accuracy / micro-F1 exact over the
        fold regardless of padding."""
        fanouts = self.model.fanouts(train=False)
        s = torch.zeros(4, dtype=torch.float32, device=ids_padded.device)
        for ids, targets, mask in zip(ids_padded, targets_padded, mask_padded):
            levels = graph_sample_tree(graph, ids, fanouts, generator=generator)
            logits = self.model(levels, graph.feats)
            if self.task == "classification":
                correct = torch.sum((logits.argmax(-1) == targets.long()) * mask)
                s += torch.stack([correct, mask.sum(), torch.zeros_like(correct),
                                  torch.zeros_like(correct)])
            elif self.task == "multilabel_classification":
                preds = (logits > 0).float() * mask[:, None]
                t = targets.float() * mask[:, None]
                tp = torch.sum(preds * t)
                fp = torch.sum(preds * (1 - t) * mask[:, None])
                fn = torch.sum((1 - preds) * t * mask[:, None])
                s += torch.stack([tp, fp, fn, torch.zeros_like(tp)])
            else:  # regression: sums of squared and absolute errors + count
                err = logits - targets.to(logits.dtype)
                se = torch.sum(torch.square(err) * mask[:, None]).float()
                ae = torch.sum(torch.abs(err) * mask[:, None]).float()
                cnt = mask.sum() * logits.shape[-1]
                s += torch.stack([se, ae, cnt, torch.zeros_like(se)])
        if self.task == "classification":
            return {"metric": s[0] / torch.clamp(s[1], min=1.0)}
        if self.task == "multilabel_classification":
            return {"metric": 2 * s[0] / torch.clamp(2 * s[0] + s[1] + s[2], min=1e-12)}
        if self.task == "regression":
            return {"metric": -s[0] / torch.clamp(s[2], min=1.0)}
        return {"metric": -s[1] / torch.clamp(s[2], min=1.0)}

    def evaluate(
        self,
        graph: Graph,
        ids: np.ndarray,
        targets: np.ndarray,
        generator: torch.Generator,
        batch_size: Optional[int] = None,
    ) -> float:
        """Host wrapper: pad the fold, run ``eval_fold``, return the scalar."""
        b = batch_size or self.config.batch_size
        n = len(ids)
        n_batches = max(1, -(-n // b))
        pad = n_batches * b - n
        ids_p = np.concatenate([ids, np.zeros(pad, dtype=ids.dtype)])
        tgt_p = np.concatenate([targets, np.zeros((pad,) + targets.shape[1:], dtype=targets.dtype)])
        mask_p = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
        dev = graph.device
        out = self.eval_fold(
            graph,
            generator,
            torch.as_tensor(ids_p.reshape(n_batches, b), dtype=torch.int32, device=dev),
            torch.as_tensor(tgt_p.reshape((n_batches, b) + targets.shape[1:]), device=dev),
            torch.as_tensor(mask_p.reshape(n_batches, b), device=dev),
        )
        return float(out["metric"])


def fit(
    problem,
    config: TrainConfig,
    log: Optional[Callable[[Dict], None]] = None,
    eval_every_epoch: bool = True,
    resume_from: Optional[str] = None,
    val_interval_batches: Optional[int] = None,
    checkpoint_every: int = 0,
    device: str | torch.device = "cuda",
    csr: bool = False,
) -> Tuple[Trainer, TrainState, list]:
    """End-to-end training on a NodeProblem: per-epoch training over the train
    fold with the per-batch LR, validation on the full graph, one JSON metric
    line per epoch, and the final test metric.

    ``resume_from``: a checkpoint path. If it (or its ``.last`` sibling)
    exists, training restarts from it at the epoch after its step;
    ``checkpoint_every`` > 0 also writes it every N epochs, and
    ``config.save_best`` writes it on every val improvement instead (the
    periodic writes then go to ``.last``). ``val_interval_batches``: each
    epoch runs in segments of that many batches, drawn from a host shuffle
    of the fold, with a validation after each. ``config.exact_val``:
    validation by exact full-graph inference (``nn/full_graph.py``) on the
    compute-dtype table, every ``exact_val_every``-th epoch and the last,
    sampled in between; ``patience`` and ``save_best`` then compare exact
    epochs only. ``csr``: CSR adjacency for training and sampled validation;
    exact validation keeps the full graph's adjacency dense (layer-wise
    inference walks whole rows). ``config.feature_int8``: the feature table
    int8 with per-column scales. ``device="cuda"`` without a card raises;
    nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit(device='cuda') needs a CUDA device; pass device='cpu' for the CPU")
    if log is None:
        log = lambda d: print(json.dumps(d), flush=True)  # noqa: E731
    check_ported(config)

    train_ids = problem.folds["train"]
    if len(train_ids) < config.batch_size:
        config = config.replace(batch_size=max(1, len(train_ids)))
        log({"note": f"batch_size clamped to train fold size {config.batch_size}"})
    steps_per_epoch = max(1, len(train_ids) // config.batch_size)
    model = build_model(config, problem.n_nodes, problem.n_classes, problem.feats_dim)
    trainer = Trainer(model, config, steps_per_epoch, task=problem.task)
    use_exact_val = config.exact_val and exact_supported(model)
    if config.exact_val and not use_exact_val:
        log({"note": "exact_val unsupported for this aggregator; "
                     "falling back to sampled validation"})
    elif use_exact_val and csr:
        log({"note": "exact_val densifies the FULL-graph adjacency for the "
                     "eval pass (training storage stays CSR); budget "
                     "n_nodes*max_degree*4 bytes of transient HBM"})
    fdt = COMPUTE_DTYPES[config.compute_dtype]
    graph_train = problem.device_graph(train=True, dtype=fdt, device=device, csr=csr,
                                       quantize=config.feature_int8)

    def get_graph_full() -> Graph:
        # uploaded on first use: a run without validation never holds it
        return problem.device_graph(train=False, dtype=fdt, device=device,
                                    csr=csr and not use_exact_val,
                                    quantize=config.feature_int8)

    state = trainer.init_state(graph_train)
    state, start_epoch = resume_state(state, resume_from, steps_per_epoch, log)
    tracker = BestTracker(config, resume_from, log)

    fold_ids = torch.as_tensor(train_ids, dtype=torch.int32, device=device)
    fold_targets = graph_train.targets[fold_ids.long()]
    val_ids = problem.folds["val"]

    def eval_fold_ids(ids: np.ndarray, exact: bool = True) -> float:
        if use_exact_val and exact:
            logits = embed_all_nodes(model, get_graph_full(), with_head=True)
            logits = logits[torch.as_tensor(ids, device=device)].cpu().numpy()
            return fold_metric_np(problem.task, logits, problem.store.targets[ids])
        gen = torch.Generator(device=device).manual_seed(config.seed + 1)
        return trainer.evaluate(get_graph_full(), ids, problem.store.targets[ids], gen)

    def exact_this_epoch(epoch: int) -> bool:
        """exact_val_every thinning: exact on every K-th epoch and the last."""
        k = max(1, config.exact_val_every)
        return (epoch + 1) % k == 0 or epoch == config.epochs - 1

    def validate(rec: dict, exact: bool = True) -> dict:
        if len(val_ids):
            rec["val_metric"] = eval_fold_ids(val_ids, exact=exact)
        return rec

    history = []
    for epoch in range(start_epoch, config.epochs):
        t0 = time.time()
        if val_interval_batches:
            # segments of a fresh whole-epoch shuffle, drawn on the host with
            # the JAX package's numpy call, so segment membership matches it
            ep_perm = torch.as_tensor(np.random.default_rng(
                config.seed * 1_000_003 + epoch).permutation(len(train_ids)), device=device)
            ep_ids, ep_tgt = fold_ids[ep_perm], fold_targets[ep_perm]
            seg = val_interval_batches * config.batch_size
            losses, last_lr = [], trainer._lr_fn(state.step)
            for start in range(0, len(train_ids) - config.batch_size + 1, seg):
                state, m = trainer.train_epoch(state, graph_train, ep_ids[start:start + seg],
                                               ep_tgt[start:start + seg])
                losses.append(float(m["loss"]))
                last_lr = m["lr"]
                log(validate({"epoch": epoch, "batch_offset": start // config.batch_size,
                              "train_loss": losses[-1]}, exact=exact_this_epoch(epoch)))
            train_metrics = {"loss": np.mean(losses) if losses else float("nan"),
                             "lr": last_lr}
        else:
            state, train_metrics = trainer.train_epoch(state, graph_train, fold_ids,
                                                       fold_targets)
        rec = {
            "epoch": epoch,
            "train_loss": float(train_metrics["loss"]),
            "lr": float(train_metrics["lr"]),
            "elapsed": round(time.time() - t0, 4),
        }
        exact_now = exact_this_epoch(epoch)
        if eval_every_epoch:
            rec = validate(rec, exact=exact_now)
        history.append(rec)
        log(rec)
        maybe_checkpoint(state, resume_from, checkpoint_every, epoch, log, config=config)
        # with exact_val_every > 1 the sampled in-between metrics are
        # informational: the tracker compares exact epochs only
        tracked = rec.get("val_metric") if (not use_exact_val or exact_now) else None
        if tracker.update(tracked, state):
            break

    test_ids = problem.folds.get("test", np.array([], dtype=np.int64))
    if eval_every_epoch and len(test_ids):
        log({"final_test_metric": eval_fold_ids(test_ids)})
    return trainer, state, history
