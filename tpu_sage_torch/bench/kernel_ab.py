"""Time this checkout's fanout-mean and mean + projection kernels against
another checkout's, in turns on one card, L2-cold, at the main path's shapes.

    python -m tpu_sage_torch.bench.kernel_ab --other DIR

``DIR`` holds another checkout of the repository whose
``tpu_sage_torch/kernels/csrc/{gather_mean,mean_project}.cu`` export the
earlier C interface ``tsg_gather_fanout_mean(table, ids, out, n_table,
n_roots, d, fanout, is_bf16, stream)`` and ``tsg_mean_project(x, w, out, b,
f, d, o, is_bf16, stream)``. Both are built with this checkout's
``nvcc`` flags into ``build/tpu_sage_torch/ab/``. The inputs are the ones
``chip_smoke.py`` phase 3 uses (Reddit-shaped ``bench_store``, batch 512,
fanouts (25, 10), seed 0). Each pair is timed in the order other, this,
this, other (``bench.timing.cuda_ms``, median of 20 L2-cold calls each); one
JSON line reports both times of each side, the card and its power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from tpu_sage_torch.bench.timing import cuda_ms
from tpu_sage_torch.kernels import _build, gather_mean, mean_project

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_OTHER_SIGNATURES = {
    "gather_mean": ("tsg_gather_fanout_mean", (_P, _P, _P, _LL, _LL, _I, _I, _I, _P)),
    "mean_project": ("tsg_mean_project", (_P, _P, _P, _LL, _I, _I, _I, _I, _P)),
}


def _build_other(root: str, name: str):
    src = os.path.join(root, "tpu_sage_torch", "kernels", "csrc", name + ".cu")
    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, f"lib{name}_other.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib_path, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)
    fn_name, argtypes = _OTHER_SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def main(argv=None) -> int:
    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.data.synthetic import bench_store
    from tpu_sage_torch.sample.sampler import sample_tree

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True, help="root of the other checkout")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.build()
    other = {name: _build_other(args.other, name) for name in _OTHER_SIGNATURES}

    store = bench_store(cache_dir="0")
    graph = NodeProblem(store).device_graph(train=True, dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    roots = torch.as_tensor(store.folds["train"][:512], dtype=torch.int32, device="cuda")
    l0, l1, l2 = sample_tree(graph.adj, graph.degrees, roots, (25, 10), generator=gen)
    feats = graph.feats
    n, d = feats.shape
    x0 = feats[l1.long()].view(512, 25, d)
    x1 = torch.relu(torch.randn((512, 25, 256), generator=gen, device="cuda")).to(torch.bfloat16)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def other_fanout_mean():
        out = torch.empty((l2.shape[0] // 10, d), dtype=torch.float32, device="cuda")
        _build.check_launch(other["gather_mean"](feats.data_ptr(), l2.data_ptr(), out.data_ptr(),
                                                 n, out.shape[0], d, 10, 1, stream()),
                            "other tsg_gather_fanout_mean")
        return out

    def other_mean_project(x, w):
        b, f, dx = x.shape
        out = torch.empty((b, w.shape[1]), dtype=x.dtype, device="cuda")
        _build.check_launch(other["mean_project"](x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                                  b, f, dx, w.shape[1], 1, stream()),
                            "other tsg_mean_project")
        return out

    pairs = {"gather_fanout_mean bf16 ids=128000 F=10":
             (other_fanout_mean, lambda: gather_mean.gather_fanout_mean(feats, l2, 10))}
    for label, x in (("layer 0", x0), ("layer 1", x1)):
        w = (torch.randn((x.shape[2], 128), generator=gen, device="cuda")
             / x.shape[2] ** 0.5).to(torch.bfloat16)
        pairs[f"mean_project {label} x {tuple(x.shape)}"] = (
            lambda x=x, w=w: other_mean_project(x, w),
            lambda x=x, w=w: mean_project.mean_project(x, w))
    report = {}
    for label, (fn_other, fn_this) in pairs.items():
        a, b = fn_other(), fn_this()
        torch.cuda.synchronize()
        err = (a.float() - b.float()).abs().max().item()
        t = [cuda_ms(fn) for fn in (fn_other, fn_this, fn_this, fn_other)]
        report[label] = {"other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]],
                         "max_abs_diff": err}
    print(smi)
    print(json.dumps({"kernel_ab": report, "device": torch.cuda.get_device_name(0),
                      "timing": "median of 20 CUDA-event timings, each L2-cold"}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
