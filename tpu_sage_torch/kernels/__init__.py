"""Hand-written CUDA kernels for Hopper: one per TPU kernel of the JAX package,
the exact pass's max and mean summaries, which the JAX package left to XLA,
and the ordering of a gather's ids by id, which it does not do.

``KERNELS`` below is the one list of them: each kernel's name, the port
module holding its wrapper, its CUDA source in ``csrc/`` and what it replaces
in the JAX package. A module may hold more than one kernel: ``gather`` the
ordering (``gather_order``) beside the gather, ``gather_mean`` the int8 and
owner-masked fanout means beside the plain one, ``sample_hop`` the CSR hop
and the CSR tree, ``select`` the column pick fused with its hop arithmetic
(``select_hop``).

Each module holds its kernels' wrappers and the plain PyTorch version beside
each (``*_reference``). A wrapper runs the plain version only for tensors on
the CPU; for a CUDA tensor it launches its kernel through ``_build.launch``,
which counts the launch under the kernel's name, or raises. The kernels build
on first use (``_build``). ``gather_blockspec`` is the measurement foil of
``gather``: nothing on the main path launches it. The main path's sampler
hops launch ``sample_hop`` (select fused with its gathers); the packed
sampler and the partitioned hops ``select_hop``; CSR trees and walks
``csr_tree``.

``probe()`` is the counterpart of the JAX package's
``tpu_sage/kernels/__init__.py::probe``: it builds every source, then in a
subprocess under a timeout launches each kernel of ``KERNELS`` once against
its plain version. It is a health check and switches nothing: no path reads
it. The JAX package's ``PALLAS_ENABLED`` flag has no counterpart, because the
port's kernels are always on for CUDA tensors.
"""

from __future__ import annotations

import os
import subprocess
import sys
from types import ModuleType
from typing import NamedTuple

from tpu_sage_torch.kernels import (_build, gather, gather_blockspec, gather_mean, mean_project,
                                    neighbor_max, neighbor_mean, sample_hop, select)


class Kernel(NamedTuple):
    module: ModuleType  # the port module holding the wrapper and its plain version
    source: str  # csrc/<source>.cu
    replaces: str  # in the JAX package


KERNELS = {
    "select_columns": Kernel(select, "select", "kernels/select.py::select_columns_pallas"),
    "sample_hop": Kernel(sample_hop, "select", "kernels/select.py::select_columns_pallas with "
                         "the hop's gathers of sample/sampler.py::uniform_neighbor_sample"),
    "gather_rows": Kernel(gather, "gather", "kernels/gather.py::gather_rows"),
    "gather_rows_blockspec": Kernel(gather_blockspec, "gather",
                                    "kernels/gather.py::gather_rows_blockspec"),
    "gather_fanout_mean": Kernel(gather_mean, "gather_mean",
                                 "kernels/gather_mean.py::gather_fanout_mean"),
    "mean_project": Kernel(mean_project, "mean_project", "kernels/mean_project.py::mean_project"),
    "gather_fanout_mean_int8": Kernel(gather_mean, "gather_mean",
                                      "kernels/gather_mean.py::gather_fanout_mean on an int8 "
                                      "table (data/quantize.py::QuantizedFeats.fanout_mean, XLA)"),
    "sample_hop_csr": Kernel(sample_hop, "select", "kernels/select.py::select_columns_pallas in "
                             "the CSR hops of sample/csr.py::uniform_neighbor_sample_csr and "
                             "uniform_neighbor_sample_csr_window"),
    "gather_fanout_mean_owned": Kernel(gather_mean, "gather_mean",
                                       "kernels/gather_mean.py::gather_fanout_mean with the owner "
                                       "mask of dist/halo.py::dist_gather_fanout_mean (XLA)"),
    "select_hop": Kernel(select, "select", "kernels/select.py::select_columns_pallas with the "
                         "column arithmetic of dist/train.py::sample_level_distributed, "
                         "dist/halo.py::dist_sample_csr_owner_select and "
                         "sample/sampler.py::sample_tree_packed"),
    "csr_tree": Kernel(sample_hop, "select", "kernels/select.py::select_columns_pallas in every "
                       "hop of sample/csr.py::sample_tree_csr and of the CSR walk of "
                       "train/unsupervised.py::graph_random_walk"),
    "neighbor_max": Kernel(neighbor_max, "neighbor_max", "no Pallas kernel: XLA's masked max of "
                           "the max pool's exact summary in nn/full_graph.py"),
    "neighbor_mean": Kernel(neighbor_mean, "neighbor_mean", "no Pallas kernel: XLA's masked sum "
                            "and division of the mean, gcn and mean_pool exact summaries in "
                            "nn/full_graph.py"),
    "gather_order": Kernel(gather, "gather", "no Pallas kernel: kernels/gather.py::gather_rows "
                           "walks its ids in output order; the port's gather walks them in id "
                           "order where gather_order_plan says so"),
}


def launch_counts() -> dict:
    """Kernel launches per kernel of ``KERNELS`` since the last
    ``reset_launch_counts``, 0 for a kernel not launched."""
    return {name: _build.counts[name] for name in KERNELS}


def reset_launch_counts() -> None:
    _build.counts.clear()


def probe(timeout: float = 90.0) -> bool:
    """Do the kernels build, launch and match their plain versions here?
    Builds every source in this process first (a cold ``nvcc`` build takes
    minutes and is not what the timeout guards), then runs
    ``kernels/_probe.py`` in a subprocess killed after ``timeout`` seconds,
    so a hung launch cannot take the caller down. True only if each
    kernel of ``KERNELS`` launched once and matched; False with no card, no
    ``nvcc``, a failed build, a hang or a mismatch. Never raises."""
    import torch

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
