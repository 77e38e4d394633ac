"""LR schedules: constant / linear / cyclical / sgdr (counterpart of
``tpu_sage/train/lr.py``).

Each schedule is a function ``f(progress) -> lr`` of fractional epoch
progress ``step / steps_per_epoch``, evaluated on the host in f32 arithmetic
(as the reference evaluates it in f32 on the device) and set on the
optimizer before every step.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[float], float]


class LRSchedule:
    """Factory namespace mirroring the reference's ``LRSchedule`` class."""

    @staticmethod
    def constant(lr_init: float = 0.01, **_) -> Schedule:
        def f(progress):
            return float(np.float32(lr_init))
        return f

    @staticmethod
    def linear(lr_init: float = 0.01, epochs: float = 10.0, **_) -> Schedule:
        """Linear decay to 0 over the run."""
        def f(progress):
            p = np.float32(progress)
            return float(np.float32(lr_init) * np.maximum(np.float32(0.0),
                                                          np.float32(1.0) - p / np.float32(epochs)))
        return f

    @staticmethod
    def cyclical(lr_init: float = 0.01, lr_min: float = 0.0, period: float = 1.0, **_) -> Schedule:
        """Triangle wave per ``period`` epochs: lr_init → lr_min → lr_init."""
        def f(progress):
            p = np.float32(progress) / np.float32(period)
            frac = p - np.floor(p)
            tri = np.float32(1.0) - np.abs(np.float32(2.0) * frac - np.float32(1.0))
            return float(np.float32(lr_min) + np.float32(lr_init - lr_min) * (np.float32(1.0) - tri))
        return f

    @staticmethod
    def sgdr(lr_init: float = 0.01, lr_min: float = 0.0, period: float = 10.0,
             t_mult: float = 2.0, **_) -> Schedule:
        """Cosine annealing with warm restarts (Loshchilov & Hutter); the
        restart period grows by ``t_mult`` each cycle."""
        def f(progress):
            p = np.float32(progress)
            per = np.float32(period)
            if t_mult == 1.0:
                t_cur = np.mod(p, per)
                t_i = per
            else:
                tm = np.float32(t_mult)
                n = np.floor(np.log(np.maximum(p / per * (tm - np.float32(1.0)) + np.float32(1.0),
                                               np.float32(1.0))) / np.log(tm))
                start = per * (tm ** n - np.float32(1.0)) / (tm - np.float32(1.0))
                t_i = per * tm ** n
                t_cur = p - start
            return float(np.float32(lr_min) + np.float32(0.5) * np.float32(lr_init - lr_min)
                         * (np.float32(1.0) + np.cos(np.float32(np.pi) * t_cur / t_i)))
        return f

    lookup = {}  # populated below


LRSchedule.lookup = {
    "constant": LRSchedule.constant,
    "linear": LRSchedule.linear,
    "cyclical": LRSchedule.cyclical,
    "sgdr": LRSchedule.sgdr,
}
