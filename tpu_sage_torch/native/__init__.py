"""ctypes bindings for the native ETL core (counterpart of
``tpu_sage/native/__init__.py``).

``graph_builder.cpp`` is a verbatim copy of the JAX package's C++ source, so for
the same seed both packages build the same tables bit for bit. ``load()``
compiles it with ``g++`` on first use (never at import) into
``build/tpu_sage_torch/native/`` in the checkout, as a library named by a hash
of the source and the flags, and exposes:

- ``build_padded_adjacency(edges, n_nodes, max_degree, seed, symmetrize)``
- ``random_walks(adj, degrees, starts, n_walks, walk_len, seed)``

Without a C++ toolchain ``load()`` returns None and the callers
(``data/convert.py``) take the numpy implementations: this is a host-ETL
accelerator, never a device path and never a correctness dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "graph_builder.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "tpu_sage_torch", "native",
)
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def library_path() -> str:
    """The shared library's path: ``BUILD_DIR/libtsg_native_<hash>.so``, the
    hash over the source and the flags."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"libtsg_native_{digest[:16]}.so")


def _compile(out: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, out)  # atomic publish: concurrent compiles race harmlessly
    return True


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, compiled if needed; None when no toolchain can
    build it."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    out = library_path()
    if not os.path.exists(out) and not _compile(out):
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(out)
    except OSError:
        _load_failed = True
        return None

    lib.build_padded_adjacency.restype = ctypes.c_int
    lib.build_padded_adjacency.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.random_walks.restype = ctypes.c_int
    lib.random_walks.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def build_padded_adjacency(
    edges: np.ndarray, n_nodes: int, max_degree: int,
    seed: int = 0, symmetrize: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Native padded-adjacency build ``(adj int32, degrees int32)``; raises
    RuntimeError without the library (check ``available()`` or use the numpy
    implementation) and ValueError with the library's code on bad input (1: no nodes
    or no columns, 2: an edge endpoint out of range)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable; use the numpy implementation")
    edges = np.ascontiguousarray(np.asarray(edges, dtype=np.int64).reshape(-1, 2))
    adj = np.empty((n_nodes, max_degree), dtype=np.int32)
    deg = np.empty((n_nodes,), dtype=np.int32)
    rc = lib.build_padded_adjacency(
        _ptr(edges, ctypes.c_int64), edges.shape[0], n_nodes,
        max_degree, int(symmetrize), seed,
        _ptr(adj, ctypes.c_int32), _ptr(deg, ctypes.c_int32),
    )
    if rc != 0:
        raise ValueError(f"build_padded_adjacency failed with code {rc}")
    return adj, deg


def random_walks(
    adj: np.ndarray, degrees: np.ndarray, starts: np.ndarray,
    n_walks: int, walk_len: int, seed: int = 0,
) -> np.ndarray:
    """Native walk corpus ``(n_starts, n_walks, walk_len + 1)`` int32; raises
    ValueError with the generator's code on bad input (1: ``walk_len < 0`` or
    ``n_walks <= 0``, 2: a start out of range)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    adj = np.ascontiguousarray(adj, dtype=np.int32)
    degrees = np.ascontiguousarray(degrees, dtype=np.int32)
    starts = np.ascontiguousarray(np.asarray(starts, dtype=np.int64))
    out = np.empty((len(starts), n_walks, walk_len + 1), dtype=np.int32)
    rc = lib.random_walks(
        _ptr(adj, ctypes.c_int32), _ptr(degrees, ctypes.c_int32),
        adj.shape[0], adj.shape[1],
        _ptr(starts, ctypes.c_int64), len(starts),
        n_walks, walk_len, seed, _ptr(out, ctypes.c_int32),
    )
    if rc != 0:
        raise ValueError(f"random_walks failed with code {rc}")
    return out
