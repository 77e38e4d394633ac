"""Build and load the CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled on first
use with ``nvcc`` for ``sm_90a`` into its own shared library under
``build/tpu_sage_torch/`` in the checkout, named by a hash of the source and
the flags, and loaded with ``ctypes``. ``build()`` starts one ``nvcc`` per
missing library, all at once, and waits for them together. The compiler's
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside each
library as ``<library>.log``. ``launch`` is the one way a wrapper calls an
entry point, and counts each launch under its kernel's name
(``kernels.launch_counts``).

Nothing here builds or loads at import: the tests import every module on
machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from typing import Dict, Iterable, Tuple

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "tpu_sage_torch",
)
SOURCES = tuple(sorted(f[:-3] for f in os.listdir(_CSRC) if f.endswith(".cu")))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
counts: Counter = Counter()  # launches per kernel name since kernels.reset_launch_counts


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the toolkit's
    default install location; raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Tuple[str, str]:
    """``(source, shared library)`` paths for ``csrc/<name>.cu``."""
    src = os.path.join(_CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, os.path.join(BUILD_DIR, f"lib{name}_{digest[:16]}.so")


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    process per source, all started together."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    pending = []
    for name in names:
        src, out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        pending.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in pending:
        log, _ = proc.communicate()
        with open(out + ".log", "wb") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)  # atomic publish
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def library(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed.

    ``signatures`` maps each C entry point to its ``argtypes``; every entry
    point returns the ``cudaError_t`` of its launch as an ``int``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(library_path(name)[1])
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return lib


def check_launch(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError_t {err}")


def launch(fn, *args, device: torch.device, kernel: str) -> None:
    """Call the C entry point ``fn(*args, stream)`` with ``device`` current
    and its current stream, without synchronizing; raise on a launch error,
    else count one launch of ``kernel`` (a name of ``kernels.KERNELS``)."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check_launch(err, fn.__name__)
    counts[kernel] += 1


def require(t, name: str, *, device, dtypes, ndim: int) -> None:
    """Validate a tensor argument before its pointer goes to a kernel."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
