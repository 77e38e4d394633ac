"""What sets the int8 fanout mean's time: one set of loads, each arithmetic
on them timed alone, L2-cold, at the int8 step's shape.

    python -m tpu_sage_torch.bench.int8_stages

Builds ``bench/csrc/int8_stages.cu`` (its comment lists the stages) with
the kernels' ``nvcc`` flags into ``build/tpu_sage_torch/bench/``, and runs
each stage over the deepest level of the main path's tree on
``bench_store()``'s int8 table (12,800 roots × F = 10 × 602 columns, as
``chip_smoke.py`` phase 8 and ``bench/kernel_ab.py`` build it) and over the
NCE step's (153,600 roots, from a 6,144-root tree). The stages that must
agree do: 1 and 2 (int32 sums), 3 and 4 (bf16 dequantize), 5 and 6 (f32
dequantize), bitwise. This checkout's ``gather_fanout_mean_int8`` is timed
beside them in its four modes. Then each stage's SASS (``cuobjdump -sass``)
is counted by opcode: the unrolled batch of 5 rows × 10 words × 2 bytes is
100 columns a lane, so a count over 100 is about the instructions a column.
One JSON line reports the times, the agreement and the counts, after the
card's name and power limit.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import subprocess

import torch

from tpu_sage_torch.bench.timing import cuda_ms
from tpu_sage_torch.kernels import _build, gather_mean

STAGES = ("loads only", "byte-wise int32 sum", "packed int32 sum", "bf16 dequantize (I2F, F2F)",
          "bf16 dequantize (magic, mul.bf16x2)", "f32 dequantize (I2F)",
          "f32 dequantize (magic)")
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "int8_stages.cu")
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _build_stages() -> str:
    out_dir = os.path.join(_build.BUILD_DIR, "bench")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libint8_stages.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, _SRC], check=True,
                   capture_output=True)
    return lib


def sass_counts(lib: str) -> dict:
    """Opcode counts of each ``stage_kernel<N>`` in the library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], check=True, capture_output=True,
                          text=True).stdout
    counts, stage = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : \S*stage_kernelILi(\d)E", line)
        if m:
            stage = int(m.group(1))
            counts[stage] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and stage is not None:
            counts[stage][m.group(1).split(".")[0]] += 1
    return counts


def main() -> int:
    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.data.synthetic import bench_store
    from tpu_sage_torch.sample.sampler import sample_tree

    if not torch.cuda.is_available():
        raise SystemExit("int8_stages needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib_path = _build_stages()
    fn = ctypes.CDLL(lib_path).tsg_int8_stage
    fn.argtypes, fn.restype = [_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _P], ctypes.c_int

    problem = NodeProblem(bench_store(cache_dir="0"))
    graph = problem.device_graph(train=True, dtype=torch.bfloat16, device="cuda")
    qf = problem.device_graph(train=True, dtype=torch.bfloat16, device="cuda",
                              quantize=True).feats
    q, scale = qf.q, qf.scale
    n, d = q.shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    roots = torch.as_tensor(problem.folds["train"][:512], dtype=torch.int32, device="cuda")
    step_ids = sample_tree(graph.adj, graph.degrees, roots, (25, 10), generator=gen)[2]
    nce_roots = torch.randint(0, n, (6144,), generator=gen, device="cuda", dtype=torch.int32)
    nce_ids = sample_tree(graph.adj, graph.degrees, nce_roots, (25, 10), generator=gen)[2]

    report = {}
    for shape, ids in (("step", step_ids), ("NCE", nce_ids)):
        r = ids.shape[0] // 10

        def stage(k, ids=ids, r=r):
            out = torch.empty((r, d), dtype=torch.int32, device="cuda")
            _build.check_launch(fn(q.data_ptr(), ids.data_ptr(), scale.data_ptr(),
                                   out.data_ptr(), n, r, d, 10, k,
                                   torch.cuda.current_stream().cuda_stream), "tsg_int8_stage")
            return out

        outs = [stage(k) for k in range(len(STAGES))]
        torch.cuda.synchronize()
        agree = {f"{a} = {b}": bool(torch.equal(outs[a], outs[b])) for a, b in ((1, 2), (3, 4),
                                                                                (5, 6))}
        row = {"roots": r, "ids": ids.shape[0], "agree": agree,
               "stage_ms": {STAGES[k]: cuda_ms(lambda k=k: stage(k)) for k in range(len(STAGES))}}
        row["kernel_ms"] = {
            f"{str(dt)[6:]} {'int32 sum' if sm else 'dequantize then mean'}": cuda_ms(
                lambda dt=dt, sm=sm: gather_mean.gather_fanout_mean_int8(q, scale, ids, 10, dt, sm))
            for dt in (torch.bfloat16, torch.float32) for sm in (True, False)}
        report[shape] = row
    counts = sass_counts(lib_path)
    report["sass"] = {STAGES[k]: dict(sorted(c.items(), key=lambda kv: -kv[1]))
                      for k, c in sorted(counts.items())}
    print(smi)
    print(json.dumps({"int8_stages": report, "device": torch.cuda.get_device_name(0),
                      "timing": "median of 20 CUDA-event timings, each L2-cold"}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
