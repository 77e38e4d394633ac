"""Cross-cutting helpers (counterpart of ``tpu_sage/utils.py``).

``set_seeds`` seeds numpy and returns a seeded ``torch.Generator``, the
port's counterpart of the JAX package's root key: the port threads explicit
generators and seeds no global RNG. ``enable_compilation_cache`` points the
kernels' build cache at a directory of the caller's, the port's persistent
compile cache.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def set_seeds(seed: int, device: str | torch.device = "cuda") -> torch.Generator:
    """Seed numpy's global RNG and return a ``torch.Generator`` on ``device``
    seeded with ``seed``."""
    np.random.seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array → host numpy. bf16 tensors come
    back as f32 arrays, exactly: numpy has no bf16, and every bf16 value is
    an f32 value."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def enable_compilation_cache(path: Optional[str] = None) -> str:
    """Build and load the CUDA kernels under ``path`` (default: where they
    build already, the checkout's ``build/tpu_sage_torch``), so later runs
    reuse the libraries ``nvcc`` built once; the libraries are named by a
    hash of source and flags, so a stale one is never loaded. Returns the
    directory. Set it before the first kernel launch: libraries already
    loaded stay loaded."""
    from tpu_sage_torch.kernels import _build

    path = path or _build.BUILD_DIR
    os.makedirs(path, exist_ok=True)
    _build.BUILD_DIR = os.path.abspath(path)
    return _build.BUILD_DIR
