"""Hand-written CUDA kernels for Hopper, one per TPU kernel of the JAX package.

=====================  ==================================================  ====================
port module            replaces (JAX package)                              CUDA source
=====================  ==================================================  ====================
``select``             ``kernels/select.py::select_columns_pallas``        ``csrc/select.cu``
``sample_hop``         ``kernels/select.py::select_columns_pallas`` with   ``csrc/select.cu``
                       the hop's gathers (``sample/sampler.py:55-60``)
``gather``             ``kernels/gather.py::gather_rows``                  ``csrc/gather.cu``
``gather_blockspec``   ``kernels/gather.py::gather_rows_blockspec``        ``csrc/gather.cu``
``gather_mean``        ``kernels/gather_mean.py::gather_fanout_mean``      ``csrc/gather_mean.cu``
``mean_project``       ``kernels/mean_project.py::mean_project``           ``csrc/mean_project.cu``
=====================  ==================================================  ====================

Each module holds its kernel's wrapper, the plain PyTorch version beside it
(``*_reference``) and a launch counter ``LAUNCHES``. A wrapper runs the plain
version only for tensors on the CPU; for a CUDA tensor it launches its kernel
or raises. The kernels build on first use (``_build``). ``gather_blockspec``
is the measurement foil of ``gather``: nothing on the main path launches it.
The main path's sampler hops launch ``sample_hop`` (select fused with its
gathers); the packed sampler launches ``select``.
"""

from __future__ import annotations

from tpu_sage_torch.kernels import (gather, gather_blockspec, gather_mean, mean_project,
                                    sample_hop, select)

KERNEL_MODULES = {
    "select_columns": select,
    "sample_hop": sample_hop,
    "gather_rows": gather,
    "gather_rows_blockspec": gather_blockspec,
    "gather_fanout_mean": gather_mean,
    "mean_project": mean_project,
}


def launch_counts() -> dict:
    """Kernel launches per kernel since the last ``reset_launch_counts``."""
    return {name: mod.LAUNCHES for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.LAUNCHES = 0
