"""Environment overrides for the measured knobs (counterpart of
``tpu_sage/overrides.py``), read under the same variable names.

Every knob is a ``TrainConfig`` field first (``gather_form``,
``gather_chunks``, ``fuse_last``, ``int8_summean``): the product path, where
the chosen values are recorded in the run's config line and in checkpoint
metadata. The ``TPU_SAGE_*`` variables are whole-program overrides for A/B
runs: when set they win over the config everywhere. The names are the JAX
package's, so one setting switches both packages in a parity run.

The port reads them when a step runs (eager PyTorch has no trace to freeze
them in), but like the JAX package's they are meant to be set at process
start. ``gather_chunks`` is read and changes nothing: the port launches one
kernel per gather (``ops.py``).
"""

from __future__ import annotations

import os
from typing import Optional


def gather_form(configured: Optional[str]) -> Optional[str]:
    """``TPU_SAGE_GATHER_FORM=masked|plain`` forces one gather form
    everywhere; otherwise the configured value (None = the default)."""
    return os.environ.get("TPU_SAGE_GATHER_FORM") or configured


def gather_chunks(configured: int) -> int:
    """``TPU_SAGE_GATHER_CHUNKS=k`` (1 disables chunking)."""
    v = os.environ.get("TPU_SAGE_GATHER_CHUNKS")
    return int(v) if v else int(configured)


def fuse_last(configured: str) -> str:
    """``TPU_SAGE_FUSE_LAST=0|1|all`` → ``off|auto|all`` (the JAX package's
    spellings; ``off``/``auto`` pass through)."""
    v = os.environ.get("TPU_SAGE_FUSE_LAST")
    if v is None:
        return configured
    return {"0": "off", "1": "auto"}.get(v, v)


def int8_summean(configured: bool) -> bool:
    """``TPU_SAGE_INT8_SUMMEAN=0`` restores dequantize-then-mean."""
    v = os.environ.get("TPU_SAGE_INT8_SUMMEAN")
    return bool(configured) if v is None else v != "0"
