"""Hand-written CUDA kernels for Hopper: one per TPU kernel of the JAX package,
and the exact pass's max and mean summaries, which the JAX package left to XLA.

=====================  ==================================================  ====================
port module            replaces (JAX package)                              CUDA source
=====================  ==================================================  ====================
``select``             ``kernels/select.py::select_columns_pallas``        ``csrc/select.cu``
``sample_hop``         ``kernels/select.py::select_columns_pallas`` with   ``csrc/select.cu``
                       the hop's gathers (``sample/sampler.py:55-60``);
                       the CSR hop and the CSR tree in one launch
                       (``sample/csr.py``)
``gather``             ``kernels/gather.py::gather_rows``                  ``csrc/gather.cu``
``gather_blockspec``   ``kernels/gather.py::gather_rows_blockspec``        ``csrc/gather.cu``
``gather_mean``        ``kernels/gather_mean.py::gather_fanout_mean``      ``csrc/gather_mean.cu``
                       (and, for int8 tables, ``data/quantize.py::
                       QuantizedFeats.fanout_mean``)
``mean_project``       ``kernels/mean_project.py::mean_project``           ``csrc/mean_project.cu``
``neighbor_max``       no Pallas kernel: XLA's masked max of the max-pool  ``csrc/neighbor_max.cu``
                       summary in ``nn/full_graph.py`` (the exact pass)
``neighbor_mean``      no Pallas kernel: XLA's masked sum and division of  ``csrc/neighbor_mean.cu``
                       the mean, gcn and mean_pool summaries in
                       ``nn/full_graph.py`` (the exact pass)
=====================  ==================================================  ====================

``gather_mean`` also holds the owner side of the partitioned path's
pre-reduced exchange (``tpu_sage/dist/halo.py::dist_gather_fanout_mean``, XLA
in the JAX package), ``gather_fanout_mean_owned``.

Each module holds its kernel's wrapper, the plain PyTorch version beside it
(``*_reference``) and a launch counter ``LAUNCHES``; ``gather_mean`` holds
two more entry points, the int8 fanout mean and the owner-masked one,
``sample_hop`` two, the CSR hop and the CSR tree, and ``select`` one, the
column pick fused with its hop arithmetic (``select_hop``), each with a
counter of its own (``COUNTERS``). A wrapper runs the plain
version only for tensors on the CPU; for a CUDA tensor it launches its kernel
or raises. The kernels build on first use (``_build``). ``gather_blockspec``
is the measurement foil of ``gather``: nothing on the main path launches it.
The main path's sampler hops launch ``sample_hop`` (select fused with its
gathers); the packed sampler and the partitioned hops ``select_hop``; CSR
trees and walks ``csr_tree``.

``probe()`` is the counterpart of the JAX package's
``tpu_sage/kernels/__init__.py::probe``: it builds every source, then in a
subprocess under a timeout launches each of the thirteen kernels once against
its plain version. It is a health check and switches nothing: no path reads it.
The JAX package's ``PALLAS_ENABLED`` flag has no counterpart, because the
port's kernels are always on for CUDA tensors.
"""

from __future__ import annotations

import os
import subprocess
import sys

from tpu_sage_torch.kernels import (gather, gather_blockspec, gather_mean, mean_project,
                                    neighbor_max, neighbor_mean, sample_hop, select)

KERNEL_MODULES = {
    "select_columns": select,
    "sample_hop": sample_hop,
    "gather_rows": gather,
    "gather_rows_blockspec": gather_blockspec,
    "gather_fanout_mean": gather_mean,
    "mean_project": mean_project,
    "gather_fanout_mean_int8": gather_mean,
    "sample_hop_csr": sample_hop,
    "gather_fanout_mean_owned": gather_mean,
    "select_hop": select,
    "csr_tree": sample_hop,
    "neighbor_max": neighbor_max,
    "neighbor_mean": neighbor_mean,
}
COUNTERS = {name: "LAUNCHES" for name in KERNEL_MODULES}  # each kernel's counter
COUNTERS.update(gather_fanout_mean_int8="INT8_LAUNCHES", sample_hop_csr="CSR_LAUNCHES",
                gather_fanout_mean_owned="OWNED_LAUNCHES", select_hop="HOP_LAUNCHES",
                csr_tree="TREE_LAUNCHES")


def launch_counts() -> dict:
    """Kernel launches per kernel since the last ``reset_launch_counts``."""
    return {name: getattr(mod, COUNTERS[name]) for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for name, mod in KERNEL_MODULES.items():
        setattr(mod, COUNTERS[name], 0)


def probe(timeout: float = 90.0) -> bool:
    """Do the kernels build, launch and match their plain versions here?
    Builds every source in this process first (a cold ``nvcc`` build takes
    minutes and is not what the timeout guards), then runs
    ``kernels/_probe.py`` in a subprocess killed after ``timeout`` seconds,
    so a hung launch cannot take the caller down. True only if each of the
    thirteen kernels launched once and matched; False with no card, no ``nvcc``,
    a failed build, a hang or a mismatch. Never raises."""
    import torch

    from tpu_sage_torch.kernels import _build

    try:
        if not torch.cuda.is_available():
            return False
        _build.build()
    except Exception:
        return False
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    try:
        r = subprocess.run([sys.executable, "-m", "tpu_sage_torch.kernels._probe",
                            _build.BUILD_DIR], cwd=root, env=env, timeout=timeout,
                           capture_output=True)
    except (OSError, subprocess.SubprocessError):
        return False
    return r.returncode == 0
