"""Checkpoint and resume (counterpart of ``tpu_sage/train/checkpoint.py``).

A checkpoint is one ``.npz`` in the JAX package's layout, key for key, so
each package reads the other's files::

    params/params/agg_layers_{i}/fc_self/kernel     parameters, by name
    params/params/...                               (nn/params.py::flax_key)
    {opt}0/count, {opt}0/mu/params/..., {opt}0/nu/params/..., {opt}1/count
                                                    Adam (optax scale_by_adam,
                                                    then the schedule's count)
    {opt}1/count                                    SGD (the schedule's count)
    step              int32 ()
    key               uint32 (2,)
    __config__        JSON of the TrainConfig (when given)
    __best_metric__   float64 (save_best writes)

``{opt}`` is ``opt_state/``, or ``opt_state/1/`` with weight decay: optax
chains ``add_decayed_weights``, which holds no state, in front. Adam's
``exp_avg`` and ``exp_avg_sq`` are optax's ``mu`` and ``nu``; its
per-parameter ``step`` is both counts.

Random state: a ``torch.Generator`` cannot continue a ``jax.random`` key.
The port stores its sampling generator's exact state under one more key,
``__torch_generator_<device type>__``, which the JAX package's loader never
reads, and writes in ``key`` a valid uint32 pair made from the generator's
seed and the step. Loading a file without that key for the template's device
type (a JAX file, or one written on the other device type) reseeds the
generator from ``key``: training goes on, on another random stream than the
writer's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from tpu_sage_torch.nn.params import flax_key


def _opt_prefix(optimizer: torch.optim.Optimizer) -> str:
    return "opt_state/1/" if optimizer.param_groups[0]["weight_decay"] else "opt_state/"


def _is_adam(optimizer: torch.optim.Optimizer) -> bool:
    if isinstance(optimizer, torch.optim.Adam):
        return True
    if isinstance(optimizer, torch.optim.SGD):
        return False
    raise TypeError(f"checkpoints hold Adam or SGD state, not {type(optimizer).__name__}")


def _generator_key(generator: torch.Generator) -> str:
    return f"__torch_generator_{generator.device.type}__"


def save_checkpoint(path: str, state, config=None, best_metric=None) -> None:
    """Write ``state`` (a ``trainer.TrainState``) to ``path``, atomically: a
    ``.tmp.npz`` beside it, then ``os.replace``.

    ``config`` (a TrainConfig) is recorded as ``__config__`` JSON, which
    ``read_checkpoint_config`` reads back; ``best_metric`` (save_best writes)
    is the val metric this state reached, so a resumed run's ``BestTracker``
    compares against it."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    opt = state.optimizer
    prefix, adam = _opt_prefix(opt), _is_adam(opt)
    flat, count = {}, 0
    for name, p in state.model.named_parameters():
        key = flax_key(name)
        flat["params/" + key] = p.detach().float().cpu().numpy()
        if adam:
            st = opt.state.get(p, {})
            count = int(st["step"]) if "step" in st else count
            for torch_name, optax_name in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                v = st.get(torch_name)
                flat[f"{prefix}0/{optax_name}/{key}"] = (
                    np.zeros(tuple(p.shape), np.float32) if v is None
                    else v.detach().float().cpu().numpy())
    if adam:
        flat[f"{prefix}0/count"] = np.int32(count)
    flat[f"{prefix}1/count"] = np.int32(state.step)
    flat["step"] = np.int32(state.step)
    seed = (state.generator.initial_seed() + state.step) % 2 ** 64
    flat["key"] = np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)
    flat[_generator_key(state.generator)] = state.generator.get_state().numpy()
    if config is not None:
        flat["__config__"] = np.array(json.dumps(dataclasses.asdict(config), default=list))
    if best_metric is not None:
        flat["__best_metric__"] = np.float64(best_metric)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def read_best_metric(path: str) -> Optional[float]:
    """The ``__best_metric__`` recorded by a save_best write (None if absent
    or the file doesn't exist)."""
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        if "__best_metric__" not in data.files:
            return None
        return float(data["__best_metric__"])


def read_checkpoint_config(path: str) -> Optional[dict]:
    """The ``__config__`` dict stored by ``save_checkpoint`` (None if the
    checkpoint carries none)."""
    if not os.path.exists(path):
        raise SystemExit(f"error: checkpoint not found: {path!r}")
    with np.load(path) as data:
        if "__config__" not in data.files:
            return None
        return json.loads(str(data["__config__"]))


def checkpoint_step(path: str) -> int:
    """The step counter stored in a checkpoint (a peek, no restore)."""
    with np.load(path) as data:
        return int(data["step"])


def resume_state(state, resume_from, steps_per_epoch: int, log):
    """If ``resume_from`` (or its ``.last`` sibling, the periodic file of a
    ``save_best`` run) exists, load whichever holds the later step and
    compute the epoch to restart at, the one after the checkpointed step.
    Returns ``(state, start_epoch)``."""
    if not resume_from:
        return state, 0
    candidates = [p for p in (resume_from, resume_from + ".last") if os.path.exists(p)]
    if not candidates:
        return state, 0
    path = max(candidates, key=checkpoint_step)
    state = load_checkpoint(path, state)
    start_epoch = state.step // steps_per_epoch
    log({"resumed_from": path, "step": state.step, "start_epoch": start_epoch})
    return state, start_epoch


def maybe_checkpoint(state, resume_from, checkpoint_every: int, epoch: int, log,
                     config=None, write: bool = True) -> None:
    """Write ``resume_from`` every ``checkpoint_every`` epochs. With
    ``config.save_best`` the tracker owns ``resume_from`` (the best state so
    far), so the periodic writes go to the ``.last`` sibling. ``write=False``
    (every rank of a partitioned run but the first) writes nothing."""
    if not (write and checkpoint_every > 0 and resume_from
            and (epoch + 1) % checkpoint_every == 0):
        return
    path = resume_from + ".last" if (config is not None and config.save_best) else resume_from
    save_checkpoint(path, state, config=config)
    log({"checkpoint": path, "step": state.step})


class BestTracker:
    """Early stopping and best-checkpoint bookkeeping.

    ``update(val, state)`` returns True when training should stop: no
    val-metric improvement for ``config.patience`` consecutive epochs. With
    ``config.save_best`` the checkpoint is written on every improvement, so
    the file always holds the best state so far. Metrics are higher-is-better
    throughout (regression metrics are negated by the eval paths).
    ``write=False`` (every rank of a partitioned run but the first) decides
    as the writer does but writes nothing."""

    def __init__(self, config, resume_from, log, write: bool = True):
        self.write = write
        self.patience = config.patience
        self.save_best = config.save_best
        self.resume_from = resume_from
        self.log = log
        self.config = config
        # a resumed save_best run compares against the metric the best file
        # already holds, so a worse epoch after resume cannot overwrite it
        self.best = read_best_metric(resume_from) if (self.save_best and resume_from) else None
        if self.best is not None:
            log({"resumed_best_metric": self.best})
        self.stale = 0

    @property
    def active(self) -> bool:
        return self.patience > 0 or self.save_best

    def update(self, val, state) -> bool:
        if val is None:
            return False
        if self.best is None or val > self.best:
            self.best, self.stale = val, 0
            if self.save_best and self.resume_from and self.write:
                save_checkpoint(self.resume_from, state, config=self.config, best_metric=val)
                self.log({"checkpoint_best": self.resume_from, "val_metric": val,
                          "step": state.step})
            return False
        self.stale += 1
        if self.patience and self.stale >= self.patience:
            self.log({"early_stop": True, "best_val_metric": self.best,
                      "stale_epochs": self.stale})
            return True
        return False


def load_checkpoint(path: str, template):
    """Restore into ``template`` (a ``TrainState`` of the same model and
    optimizer configuration) and return it with the stored step.

    Parameters load by name. Adam's state is created for every parameter
    here, ``step`` as the tensor Adam keeps (a CPU scalar for the default,
    non-fused Adam), so the first step after a resume continues the moments
    instead of restarting them. Entries the layout does not name (such as
    another device type's generator state) are ignored."""
    if not os.path.exists(path):
        raise SystemExit(f"error: checkpoint not found: {path!r}")
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}

    def entry(key: str, shape) -> np.ndarray:
        if key not in flat:
            raise KeyError(f"checkpoint {path} missing entry {key!r}")
        stored = flat[key]
        if stored.shape != tuple(shape):
            raise ValueError(f"checkpoint mismatch at {key}: {stored.shape} vs {tuple(shape)}")
        return stored

    model, opt = template.model, template.optimizer
    prefix, adam = _opt_prefix(opt), _is_adam(opt)
    step = int(entry("step", ()))
    entry(f"{prefix}1/count", ())
    count = int(entry(f"{prefix}0/count", ())) if adam else 0
    index = {id(p): i for i, p in enumerate(p for g in opt.param_groups for p in g["params"])}
    scalar = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
    opt_state = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            key = flax_key(name)
            p.copy_(torch.from_numpy(entry("params/" + key, p.shape).astype(np.float32)))
            if adam:
                opt_state[index[id(p)]] = {
                    "step": torch.tensor(float(count), dtype=scalar),
                    **{torch_name: torch.from_numpy(
                        entry(f"{prefix}0/{optax_name}/{key}", p.shape).astype(np.float32))
                       for torch_name, optax_name in (("exp_avg", "mu"), ("exp_avg_sq", "nu"))},
                }
    opt.load_state_dict({"state": opt_state, "param_groups": opt.state_dict()["param_groups"]})

    gen = template.generator
    stored = flat.get(_generator_key(gen))
    if stored is not None:
        gen.set_state(torch.from_numpy(stored.copy()))
    else:
        hi, lo = (int(x) for x in entry("key", (2,)))
        gen.manual_seed((hi << 32) | lo)
    return dataclasses.replace(template, step=step)
