"""Hand-written CUDA kernels for Hopper, one per TPU kernel of the JAX package.

=====================  ==================================================  ====================
port module            replaces (JAX package)                              CUDA source
=====================  ==================================================  ====================
``select``             ``kernels/select.py::select_columns_pallas``        ``csrc/select.cu``
``sample_hop``         ``kernels/select.py::select_columns_pallas`` with   ``csrc/select.cu``
                       the hop's gathers (``sample/sampler.py:55-60``);
                       the CSR hop (``sample/csr.py``)
``gather``             ``kernels/gather.py::gather_rows``                  ``csrc/gather.cu``
``gather_blockspec``   ``kernels/gather.py::gather_rows_blockspec``        ``csrc/gather.cu``
``gather_mean``        ``kernels/gather_mean.py::gather_fanout_mean``      ``csrc/gather_mean.cu``
                       (and, for int8 tables, ``data/quantize.py::
                       QuantizedFeats.fanout_mean``)
``mean_project``       ``kernels/mean_project.py::mean_project``           ``csrc/mean_project.cu``
=====================  ==================================================  ====================

``gather_mean`` also holds the owner side of the partitioned path's
pre-reduced exchange (``tpu_sage/dist/halo.py::dist_gather_fanout_mean``, XLA
in the JAX package), ``gather_fanout_mean_owned``.

Each module holds its kernel's wrapper, the plain PyTorch version beside it
(``*_reference``) and a launch counter ``LAUNCHES``; ``gather_mean`` holds
two more entry points, the int8 fanout mean and the owner-masked one, and
``sample_hop`` a second, the CSR hop, each with a counter of its own
(``COUNTERS``). A wrapper runs the plain
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
    "gather_fanout_mean_int8": gather_mean,
    "sample_hop_csr": sample_hop,
    "gather_fanout_mean_owned": gather_mean,
}
COUNTERS = {name: "LAUNCHES" for name in KERNEL_MODULES}  # each kernel's counter
COUNTERS.update(gather_fanout_mean_int8="INT8_LAUNCHES", sample_hop_csr="CSR_LAUNCHES",
                gather_fanout_mean_owned="OWNED_LAUNCHES")


def launch_counts() -> dict:
    """Kernel launches per kernel since the last ``reset_launch_counts``."""
    return {name: getattr(mod, COUNTERS[name]) for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for name, mod in KERNEL_MODULES.items():
        setattr(mod, COUNTERS[name], 0)
