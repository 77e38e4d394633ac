"""Time this checkout's kernels against another checkout's, in turns on one
card, L2-cold, at the main path's shapes.

    python -m tpu_sage_torch.bench.kernel_ab --other DIR [--pairs gather,hop]

``DIR`` holds another checkout of the repository. Each pair needs the C
interface named below from the other checkout's
``tpu_sage_torch/kernels/csrc/*.cu``; only the sources of the pairs asked
for are built, with this checkout's ``nvcc`` flags, into
``build/tpu_sage_torch/ab/``.

- ``gather`` (the default, with ``hop``): the two feature gathers (bf16
  rows of the store, q = 512 and 12,800) and one of the first 51,200 ids of
  the deepest level (the two larger cases give the marginal rate per row),
  this ``gather_rows`` against
  ``tsg_gather_rows(table, ids, out, n_table, q, row_bytes, word_bytes,
  oob_zero, stream)`` with the widest word that divides the row and both
  bases (the interface before ``gather_plan``).
- ``hop``: each sampler hop (512 × 25, then 12,800 × 10) as that interface
  ran it, a ``tsg_gather_rows`` of the degrees as an ``(n, 1)`` view, the
  column arithmetic in PyTorch, a ``tsg_gather_rows`` of the adjacency rows
  and ``tsg_select_columns(rows, cols, out, b, d, k, stream)``, against this
  ``sample_hop``, with the same uniforms.
- ``fanout_mean`` and ``mean_project``: ``tsg_gather_fanout_mean(table,
  ids, out, n_table, n_roots, d, fanout, is_bf16, stream)`` and
  ``tsg_mean_project(x, w, out, b, f, d, o, is_bf16, stream)``, the first
  interface of both kernels.
- ``gather11``: ``tsg_gather_rows(table, ids, out, n_table, q, row_bytes,
  word_bytes, lanes_per_row, words_per_lane, oob_zero, stream)`` launched
  with the other checkout's own ``gather_plan`` (its
  ``tpu_sage_torch/kernels/gather.py``, loaded by path), against this
  ``gather_rows``: the main path's feature gathers (q = 512, 12,800), the
  int8 step's 602-byte rows (q = 512, 12,800), PPI-shaped 200-byte f32
  rows (56,944 x 50, q = 64,000) and exact inference's chunk of 524,288
  ids from f32 tables 128, 256, 512 and 602 wide and the bf16 one.
- ``mean_project13``: ``tsg_mean_project_bf16(x, w, out, b, f, d, o_pad,
  x_bytes, word_bytes, g_rows, n_wbufs, smem_bytes, stream)`` launched with
  the other checkout's own ``bf16_plan``, against this ``mean_project``:
  the main path's two layers (512, 25, 602 / 256) at O = 128 and at a model
  axis of 2's O = 64, the NCE step's layers (6,144 roots), and the preps'
  f32 rows (512 x 25 and 12,800 x 10, 64 and 666 wide).
- ``mean_project_f32``: ``tsg_mean_project_f32(x, w, out, b, f, d, o,
  stream)``, the f32-W kernel of ``ffdaddb`` (4 roots a block, W read from
  L2), against this ``mean_project`` with an f32 W: the main path's two
  layers (512, 25, 602) x (602, 128) and (512, 25, 256) x (256, 128) and
  the f32 NCE step's layer 0 (6,144, 25, 602) x (602, 128).
- ``owned``: ``tsg_gather_fanout_mean_owned(table, ids, out, lo, m,
  n_roots, d, fanout, kind, vec, stream)`` of ``ffdaddb`` (one warp a root,
  5 ids in flight, the widest word that divides the row), against this
  ``gather_fanout_mean_owned``: the partitioned step's deepest level
  (25,600 roots x 10 from a 1,024-root tree) at world 1 and for each of 4
  owners of the bf16 and the int8 table, and the partitioned NCE step's
  (153,600 roots x 10 from a 6,144-root tree) at world 1 and as owner 1 of
  4 ((2, 2) layout), as ``chip_smoke.py`` phases 10 and 11 build them.
- ``select_hop``: the composition the hops on fetched rows ran before
  ``tsg_select_hop`` (``clamp_min``, the column arithmetic of
  ``hop_columns``, the shift add, ``tsg_select_columns(rows, cols, out, b,
  d, ld, k, stream)`` of the other checkout, then ``== 0`` and ``where``
  for the self-loop), against this ``select_hop``: the packed sampler's two
  hops (512 x 25, 12,800 x 10, no self-loop), the partitioned step's
  (1,024 x 25, 25,600 x 10 from a 1,024-root tree, with the frontier ids),
  its hop 2 on the CSR pair view (the shift and degree columns in place)
  and at the owner (the window pair, offsets and degrees as tensors), and
  the partitioned NCE step's deepest hop (153,600 x 10), all on rows of
  ``pack_adjacency``'s stride 129 or the pair view's.
- ``csr_tree``: a CSR tree hop by hop, one ``tsg_sample_hop_csr(indptr,
  indices, degrees, ids, u, out, n_nodes, n_indices, b, k, stream)`` of the
  other checkout a hop, each reading the level the last one wrote, against
  this ``csr_tree`` (every hop in one launch), on ``bench_store``'s CSR
  (window form, as the trainer uploads it) with the same uniforms: the
  supervised tree (512 roots, (25, 10)), the walk (512 walkers, 3 hops of
  fanout 1, the last level kept) and the NCE tree (6,144 roots, (25, 10)).
  Each side returns its deepest level as it wrote it (no copy timed).
- ``int8_mean``: ``tsg_gather_fanout_mean_int8(table, ids, scale, out,
  n_table, n_roots, d, fanout, out_bf16, summean, vec, stream)`` of
  ``cd99898`` (one warp a root, each row in the widest word that divides it
  and the table's address: 2-byte words for the 602-byte rows, the bytes
  summed one by one), against this ``gather_fanout_mean_int8``, in its
  four modes (bf16 or f32 out; int32 sum or dequantize then mean) on
  ``bench_store``'s int8 table at the int8 step's deepest level (12,800
  roots x 10) and the NCE step's (153,600 roots x 10 from a 6,144-root
  tree).

The inputs are the ones ``chip_smoke.py`` phase 3 uses (Reddit-shaped
``bench_store``, batch 512, fanouts (25, 10), seed 0), and at the other
shapes rows of its table or random values made from a seeded generator on
the card. Each pair is timed in the order other, this, this, other
(``bench.timing.cuda_ms``, median of 20 L2-cold calls each); one JSON line
reports both times of each side and the largest difference of their
outputs, after the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess

import torch

from tpu_sage_torch.bench.timing import cuda_ms
from tpu_sage_torch.kernels import _build, gather, gather_mean, mean_project, sample_hop, select

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_GATHER = ("gather", "tsg_gather_rows", (_P, _P, _P, _LL, _LL, _LL, _I, _I, _P))
_OTHER = {  # pair -> the other checkout's (source, entry point, argtypes) it calls
    "gather": (_GATHER,),
    "hop": (_GATHER, ("select", "tsg_select_columns", (_P, _P, _P, _LL, _I, _I, _P))),
    "fanout_mean": (("gather_mean", "tsg_gather_fanout_mean",
                     (_P, _P, _P, _LL, _LL, _I, _I, _I, _P)),),
    "mean_project": (("mean_project", "tsg_mean_project", (_P, _P, _P, _LL, _I, _I, _I, _I, _P)),),
    "gather11": (("gather", "tsg_gather_rows",
                  (_P, _P, _P, _LL, _LL, _LL, _I, _I, _I, _I, _P)),),
    "mean_project13": (("mean_project", "tsg_mean_project_bf16",
                        (_P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _LL, _P)),),
    "mean_project_f32": (("mean_project", "tsg_mean_project_f32",
                          (_P, _P, _P, _LL, _I, _I, _I, _P)),),
    "owned": (("gather_mean", "tsg_gather_fanout_mean_owned",
               (_P, _P, _P, _LL, _LL, _LL, _I, _I, _I, _I, _P)),),
    "select_hop": (("select", "tsg_select_columns", (_P, _P, _P, _LL, _I, _LL, _I, _P)),),
    "csr_tree": (("select", "tsg_sample_hop_csr",
                  (_P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _P)),),
    "int8_mean": (("gather_mean", "tsg_gather_fanout_mean_int8",
                   (_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _P)),),
}
OWNERS, DIST_BATCH, NCE_ROOTS = 4, 1024, 6144  # chip_smoke.py phases 10 and 11
PPI_ROWS, EXACT_CHUNK = (56_944, 50), 4096  # chip_smoke.py's PPI stand-in; a node chunk


def _other_module(root: str, name: str):
    """The other checkout's ``tpu_sage_torch/kernels/<name>.py``, loaded by
    path under a name of its own (its plan functions are pure)."""
    path = os.path.join(root, "tpu_sage_torch", "kernels", name + ".py")
    spec = importlib.util.spec_from_file_location(f"_kernel_ab_other_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_OTHER_LIBS = {}  # source name -> the other checkout's library, built once a run


def _build_other(root: str, name: str, entry: str, argtypes):
    lib = _OTHER_LIBS.get(name)
    if lib is None:
        src = os.path.join(root, "tpu_sage_torch", "kernels", "csrc", name + ".cu")
        out_dir = os.path.join(_build.BUILD_DIR, "ab")
        os.makedirs(out_dir, exist_ok=True)
        lib_path = os.path.join(out_dir, f"lib{name}_other.so")
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib_path, src],
                       check=True, capture_output=True)
        lib = _OTHER_LIBS[name] = ctypes.CDLL(lib_path)
    fn = lib[entry]  # a function object of its own, whatever argtypes another took
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def main(argv=None) -> int:
    from tpu_sage_torch.data.problem import NodeProblem
    from tpu_sage_torch.data.synthetic import bench_store
    from tpu_sage_torch.sample.sampler import sample_tree

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True, help="root of the other checkout")
    parser.add_argument("--pairs", default="gather,hop",
                        help=f"comma-separated, of {', '.join(_OTHER)}")
    args = parser.parse_args(argv)
    pairs_wanted = args.pairs.split(",")
    unknown = sorted(set(pairs_wanted) - set(_OTHER))
    if unknown:
        parser.error(f"unknown pairs {unknown}; choose from {list(_OTHER)}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.build()
    other = {}
    for pair in pairs_wanted:
        for name, entry, argtypes in _OTHER[pair]:
            if (entry, len(argtypes)) not in other:
                other[entry, len(argtypes)] = _build_other(args.other, name, entry, argtypes)

    store = bench_store(cache_dir="0")
    graph = NodeProblem(store).device_graph(train=True, dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    roots = torch.as_tensor(store.folds["train"][:512], dtype=torch.int32, device="cuda")
    l0, l1, l2 = sample_tree(graph.adj, graph.degrees, roots, (25, 10), generator=gen)
    feats, adj, degrees = graph.feats, graph.adj, graph.degrees
    n, d = feats.shape

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def other_gather(table, ids):
        q, row_bytes = ids.shape[0], table.shape[1] * table.element_size()
        out = torch.empty((q, table.shape[1]), dtype=table.dtype, device="cuda")
        word = gather._word_bytes(row_bytes, table.data_ptr(), out.data_ptr())
        _build.check_launch(other["tsg_gather_rows", 9](
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), table.shape[0], q, row_bytes,
            word, 0, stream()), "other tsg_gather_rows")
        return out

    def other_hop(ids, u):
        deg = other_gather(degrees.view(-1, 1), ids).view(-1).clamp_min(1)
        cols = sample_hop.hop_columns(u, deg).contiguous()
        rows = other_gather(adj, ids)
        out = torch.empty(cols.shape, dtype=torch.int32, device="cuda")
        _build.check_launch(other["tsg_select_columns", 7](
            rows.data_ptr(), cols.data_ptr(), out.data_ptr(), rows.shape[0], rows.shape[1],
            cols.shape[1], stream()), "other tsg_select_columns")
        return out

    def other_fanout_mean():
        out = torch.empty((l2.shape[0] // 10, d), dtype=torch.float32, device="cuda")
        _build.check_launch(other["tsg_gather_fanout_mean", 9](
            feats.data_ptr(), l2.data_ptr(), out.data_ptr(), n, out.shape[0], d, 10, 1,
            stream()), "other tsg_gather_fanout_mean")
        return out

    def other_mean_project(x, w):
        b, f, dx = x.shape
        out = torch.empty((b, w.shape[1]), dtype=x.dtype, device="cuda")
        _build.check_launch(other["tsg_mean_project", 9](
            x.data_ptr(), w.data_ptr(), out.data_ptr(), b, f, dx, w.shape[1], 1, stream()),
            "other tsg_mean_project")
        return out

    def other_gather11(table, ids, oob="clamp"):
        q, row_bytes = ids.shape[0], table.shape[1] * table.element_size()
        out = torch.empty((q, table.shape[1]), dtype=table.dtype, device="cuda")
        plan = other_gather_mod.gather_plan(row_bytes, table.data_ptr() % 16,
                                            out.data_ptr() % 16)
        _build.check_launch(other["tsg_gather_rows", 11](
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), table.shape[0], q, row_bytes,
            plan["word"], plan["lanes_per_row"], plan["words_per_lane"], int(oob == "zero"),
            stream()), "other tsg_gather_rows (11 arguments)")
        return out

    def other_mean_project13(x, w):
        b, f, dx = x.shape
        plan = other_mp_mod.bf16_plan(f, dx, w.shape[1], x.data_ptr(), x.element_size())
        out = torch.empty((b, plan["o_pad"]), dtype=torch.bfloat16, device="cuda")
        _build.check_launch(other["tsg_mean_project_bf16", 13](
            x.data_ptr(), w.data_ptr(), out.data_ptr(), b, f, dx, plan["o_pad"],
            x.element_size(), plan["word"], plan["g_rows"], plan["n_wbufs"], plan["smem"],
            stream()), "other tsg_mean_project_bf16 (13 arguments)")
        return out[:, :w.shape[1]]

    def other_mean_project_f32(x, w):
        b, f, dx = x.shape
        out = torch.empty((b, w.shape[1]), dtype=torch.float32, device="cuda")
        _build.check_launch(other["tsg_mean_project_f32", 8](
            x.data_ptr(), w.data_ptr(), out.data_ptr(), b, f, dx, w.shape[1], stream()),
            "other tsg_mean_project_f32 (8 arguments)")
        return out

    def other_owned(table, ids, fanout, lo):
        m, dt = table.shape
        out = torch.empty((ids.shape[0] // fanout, dt), dtype=torch.float32, device="cuda")
        int8 = table.dtype == torch.int8
        vec = gather_mean.int8_word_bytes(table) if int8 else gather_mean.word_elements(table)
        _build.check_launch(other["tsg_gather_fanout_mean_owned", 11](
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), lo, m, out.shape[0], dt, fanout,
            2 if int8 else 1, vec, stream()), "other tsg_gather_fanout_mean_owned")
        return out

    def other_select_hop(rows, deg, u, shift=None, ids=None):
        cols = sample_hop.hop_columns(u, deg.clamp_min(1))
        if shift is not None:
            cols = shift[:, None] + cols
        cols = cols.contiguous()
        out = torch.empty(cols.shape, dtype=torch.int32, device="cuda")
        _build.check_launch(other["tsg_select_columns", 8](
            rows.data_ptr(), cols.data_ptr(), out.data_ptr(), rows.shape[0], rows.shape[1],
            rows.stride(0), cols.shape[1], stream()), "other tsg_select_columns")
        if ids is not None:
            out = torch.where(deg[:, None] == 0, ids[:, None], out)
        return out

    def other_csr_tree(g, roots, us):
        cur = roots
        for u in us:
            out = torch.empty(u.shape, dtype=torch.int32, device="cuda")
            _build.check_launch(other["tsg_sample_hop_csr", 11](
                g.indptr.data_ptr(), g.indices.data_ptr(), g.degrees.data_ptr(),
                cur.data_ptr(), u.data_ptr(), out.data_ptr(), g.degrees.shape[0],
                g.indices.shape[0], u.shape[0], u.shape[1], stream()),
                "other tsg_sample_hop_csr")
            cur = out.view(-1)
        return cur

    def other_int8_mean(qf, ids, dtype, summean):
        out = torch.empty((ids.shape[0] // 10, d), dtype=dtype, device="cuda")
        _build.check_launch(other["tsg_gather_fanout_mean_int8", 12](
            qf.q.data_ptr(), ids.data_ptr(), qf.scale.data_ptr(), out.data_ptr(), n,
            out.shape[0], d, 10, int(dtype == torch.bfloat16), int(summean),
            gather_mean.int8_word_bytes(qf.q), stream()),
            "other tsg_gather_fanout_mean_int8 (12 arguments)")
        return out

    pairs = {}
    if "int8_mean" in pairs_wanted:
        qf = NodeProblem(store).device_graph(train=True, dtype=torch.bfloat16, device="cuda",
                                             quantize=True).feats
        nce_roots = torch.randint(0, n, (NCE_ROOTS,), generator=gen, device="cuda",
                                  dtype=torch.int32)
        nce_ids = sample_tree(adj, degrees, nce_roots, (25, 10), generator=gen)[2]
        for label, ids in (("step", l2), ("NCE", nce_ids)):
            for dt in (torch.bfloat16, torch.float32):
                for sm in (True, False):
                    mode = "int32 sum" if sm else "dequantize then mean"
                    pairs[f"int8_mean {label} int8 {tuple(qf.shape)} ids={ids.shape[0]} F=10 -> "
                          f"{str(dt)[6:]}, {mode}"] = (
                        lambda i=ids, dt=dt, sm=sm: other_int8_mean(qf, i, dt, sm),
                        lambda i=ids, dt=dt, sm=sm: gather_mean.gather_fanout_mean_int8(
                            qf.q, qf.scale, i, 10, dt, sm))
    if "select_hop" in pairs_wanted:
        from tpu_sage_torch.dist.halo import CSRPairRows
        from tpu_sage_torch.sample.csr import gather_window_pair
        from tpu_sage_torch.sample.sampler import pack_adjacency

        packed = pack_adjacency(adj, degrees)
        dist_roots = torch.randperm(n, generator=gen, device="cuda")[:DIST_BATCH].int()
        dist_tree = sample_tree(adj, degrees, dist_roots, (25, 10), generator=gen)
        nce_roots = torch.randint(0, n, (NCE_ROOTS,), generator=gen, device="cuda",
                                  dtype=torch.int32)
        nce_l1 = sample_tree(adj, degrees, nce_roots, (25,), generator=gen)[1]
        for label, ids, f, self_loop in (("packed hop 1", l0, 25, False),
                                         ("packed hop 2", l1, 10, False),
                                         ("partitioned hop 1", dist_tree[0], 25, True),
                                         ("partitioned hop 2", dist_tree[1], 10, True),
                                         ("partitioned NCE hop 2", nce_l1, 10, True)):
            rows = packed[ids.long()]
            u = torch.rand((ids.shape[0], f), generator=gen, device="cuda")
            i = ids if self_loop else None
            pairs[f"select_hop {label} rows {tuple(rows[:, :-1].shape)} (row stride 129) u "
                  f"{tuple(u.shape)}{', ids' if self_loop else ''}"] = (
                lambda r=rows, u=u, i=i: other_select_hop(r[:, :-1], r[:, -1], u, ids=i),
                lambda r=rows, u=u, i=i: select.select_hop(r[:, :-1], r[:, -1], u, ids=i))
        csr_g = NodeProblem(store).device_graph(train=True, dtype=torch.bfloat16, device="cuda",
                                                csr=True)
        w, ids = csr_g.window, dist_tree[1]
        u = torch.rand((ids.shape[0], 10), generator=gen, device="cuda")
        prow = CSRPairRows(csr_g.indptr, csr_g.indices, csr_g.degrees, w).rows(ids)
        pairs[f"select_hop partitioned hop 2 CSR pair rows {tuple(prow.shape)}, shift, ids"] = (
            lambda: other_select_hop(prow[:, :2 * w], prow[:, 2 * w + 1], u,
                                     shift=prow[:, 2 * w], ids=ids),
            lambda: select.select_hop(prow[:, :2 * w], prow[:, 2 * w + 1], u,
                                      shift=prow[:, 2 * w], ids=ids))
        pair, off, _ = gather_window_pair(csr_g.indptr, csr_g.indices, ids, w)
        o_deg = csr_g.degrees[ids.long()].contiguous()
        pairs[f"select_hop partitioned hop 2 owner pick, window pair {tuple(pair.shape)}"] = (
            lambda: other_select_hop(pair, o_deg, u, shift=off),
            lambda: select.select_hop(pair, o_deg, u, shift=off))
    if "csr_tree" in pairs_wanted:
        csr_g = NodeProblem(store).device_graph(train=True, dtype=torch.bfloat16, device="cuda",
                                                csr=True)
        nce_roots = torch.randint(0, n, (NCE_ROOTS,), generator=gen, device="cuda",
                                  dtype=torch.int32)
        for label, r_ids, fos, last in (("tree", roots, (25, 10), False),
                                        ("walk", roots, (1, 1, 1), True),
                                        ("NCE tree", nce_roots, (25, 10), False)):
            us, q = [], r_ids.shape[0]
            for f in fos:
                us.append(torch.rand((q, f), generator=gen, device="cuda"))
                q *= f
            pairs[f"csr_tree {label} roots ({r_ids.shape[0]},) fanouts {fos}: hop by hop vs "
                  f"one launch"] = (
                lambda r=r_ids, us=us: other_csr_tree(csr_g, r, us),
                lambda r=r_ids, us=us, last=last: sample_hop.csr_tree(
                    csr_g.indptr, csr_g.indices, csr_g.degrees, r, us, last_only=last)[-1])
    if "mean_project_f32" in pairs_wanted:
        ids_u = torch.randint(0, n, (NCE_ROOTS * 25,), generator=gen, device="cuda",
                              dtype=torch.int32)
        for label, x in (("layer 0", feats[l1.long()].view(512, 25, d).float()),
                         ("layer 1", torch.relu(torch.randn((512, 25, 256), generator=gen,
                                                            device="cuda"))),
                         ("NCE layer 0", feats[ids_u.long()].view(NCE_ROOTS, 25, d).float())):
            w = torch.randn((x.shape[2], 128), generator=gen, device="cuda") / x.shape[2] ** 0.5
            pairs[f"mean_project f32 {label} x {tuple(x.shape)}, W {tuple(w.shape)}"] = (
                lambda x=x, w=w: other_mean_project_f32(x, w),
                lambda x=x, w=w: mean_project.mean_project(x, w))
    if "owned" in pairs_wanted:
        q8 = torch.clamp(torch.round(feats.float() / (feats.float().abs().amax(0) / 127)),
                         -127, 127).to(torch.int8)
        dist_roots = torch.randperm(n, generator=gen, device="cuda")[:DIST_BATCH].int()
        dist_ids = sample_tree(adj, degrees, dist_roots, (25, 10), generator=gen)[2]
        nce_roots = torch.randint(0, n, (NCE_ROOTS,), generator=gen, device="cuda",
                                  dtype=torch.int32)
        nce_ids = sample_tree(adj, degrees, nce_roots, (25, 10), generator=gen)[2]
        m = -(-n // OWNERS)
        cases = [("4d world 1", feats, dist_ids, 0)]
        for label, table in (("bf16", feats), ("int8", q8)):
            cases += [(f"4d {label} owner {s_}/{OWNERS}", table[lo:lo + m], dist_ids, lo)
                      for s_, lo in enumerate(range(0, n, m))]
        cases += [("4n world 1", feats, nce_ids, 0),
                  ("4n (2, 2) owner 1 of 4", feats[m:2 * m], nce_ids, m)]
        for label, table, ids, lo in cases:
            pairs[f"owned {label} {str(table.dtype)[6:]} {tuple(table.shape)} "
                  f"ids={ids.shape[0]} F=10"] = (
                lambda t=table, i=ids, lo=lo: other_owned(t, i, 10, lo),
                lambda t=table, i=ids, lo=lo: gather_mean.gather_fanout_mean_owned(t, i, 10, lo))
    if "gather11" in pairs_wanted:
        other_gather_mod = _other_module(args.other, "gather")
        q8 = torch.randint(-128, 128, feats.shape, generator=gen, device="cuda",
                           dtype=torch.int8)
        ppi = torch.randn(PPI_ROWS, generator=gen, device="cuda")
        ppi_ids = torch.randint(0, PPI_ROWS[0], (256 * 25 * 10,), generator=gen, device="cuda",
                                dtype=torch.int32)
        cols = torch.arange(adj.shape[1], dtype=torch.int32, device="cuda")
        chunk = torch.where(cols < degrees[:EXACT_CHUNK, None], adj[:EXACT_CHUNK],
                            -1).reshape(-1)
        cases = [("feats bf16", feats, l0, "clamp"), ("feats bf16", feats, l1, "clamp"),
                 ("int8 rows", q8, l0, "clamp"), ("int8 rows", q8, l1, "clamp"),
                 ("PPI-shaped f32", ppi, ppi_ids, "zero")]
        for width in (128, 256, 512):
            cases.append((f"exact f32 {width} wide", torch.randn(
                (n, width), generator=gen, device="cuda"), chunk, "zero"))
        cases += [("exact f32 602 wide", feats.float(), chunk, "zero"),
                  ("exact bf16 602 wide", feats, chunk, "zero")]
        for label, table, ids, oob in cases:
            pairs[f"gather_rows {label} {tuple(table.shape)} q={ids.shape[0]}"] = (
                lambda t=table, i=ids, o=oob: other_gather11(t, i, o),
                lambda t=table, i=ids, o=oob: gather.gather_rows(t, i, o))
    if "mean_project13" in pairs_wanted:
        other_mp_mod = _other_module(args.other, "mean_project")
        ids_u = torch.randint(0, n, (6144 * 25,), generator=gen, device="cuda",
                              dtype=torch.int32)
        prep_w = torch.randn((d, 64), generator=gen, device="cuda") / d ** 0.5
        xs = [("layer 0", feats[l1.long()].view(512, 25, d)),
              ("layer 1", torch.relu(torch.randn((512, 25, 256), generator=gen,
                                                 device="cuda")).to(torch.bfloat16)),
              ("NCE layer 0", feats[ids_u.long()].view(6144, 25, d)),
              ("NCE layer 1", torch.relu(torch.randn((6144, 25, 256), generator=gen,
                                                     device="cuda")).to(torch.bfloat16))]
        for ids, f in ((l1, 25), (l2, 10)):
            rows = feats[ids.long()].float()
            xs.append(("linear prep f32", (rows @ prep_w).view(-1, f, 64)))
            emb = torch.randn((ids.shape[0], 64), generator=gen, device="cuda") / 8
            xs.append(("node_embedding prep f32", torch.cat([rows, emb], 1).view(-1, f, d + 64)))
            del rows, emb
        for label, x in xs:
            for o in ((128, 64) if label.startswith("layer") else (128,)):
                w = (torch.randn((x.shape[2], o), generator=gen, device="cuda")
                     / x.shape[2] ** 0.5).to(torch.bfloat16)
                pairs[f"mean_project {label} x {tuple(x.shape)}, W {tuple(w.shape)}"] = (
                    lambda x=x, w=w: other_mean_project13(x, w),
                    lambda x=x, w=w: mean_project.mean_project(x, w))
    if "gather" in pairs_wanted:
        for ids in (l0, l1, l2[:51200]):
            pairs[f"gather_rows feats bf16 {tuple(feats.shape)} q={ids.shape[0]}"] = (
                lambda i=ids: other_gather(feats, i), lambda i=ids: gather.gather_rows(feats, i))
    if "hop" in pairs_wanted:
        for hop, (ids, f) in enumerate(((l0, 25), (l1, 10)), 1):
            u = torch.rand((ids.shape[0], f), generator=gen, device="cuda")
            pairs[f"hop {hop} ids ({ids.shape[0]},) u {tuple(u.shape)}: gathers + select "
                  f"vs sample_hop"] = (
                lambda i=ids, u=u: other_hop(i, u),
                lambda i=ids, u=u: sample_hop.sample_hop(adj, degrees, i, u))
    if "fanout_mean" in pairs_wanted:
        pairs["gather_fanout_mean bf16 ids=128000 F=10"] = (
            other_fanout_mean, lambda: gather_mean.gather_fanout_mean(feats, l2, 10))
    if "mean_project" in pairs_wanted:
        x1 = torch.relu(torch.randn((512, 25, 256), generator=gen, device="cuda")).to(
            torch.bfloat16)
        for label, x in (("layer 0", feats[l1.long()].view(512, 25, d)), ("layer 1", x1)):
            w = (torch.randn((x.shape[2], 128), generator=gen, device="cuda")
                 / x.shape[2] ** 0.5).to(torch.bfloat16)
            pairs[f"mean_project {label} x {tuple(x.shape)}"] = (
                lambda x=x, w=w: other_mean_project(x, w),
                lambda x=x, w=w: mean_project.mean_project(x, w))

    report = {}
    for label, (fn_other, fn_this) in pairs.items():
        a, b = fn_other(), fn_this()
        torch.cuda.synchronize()
        err = (a.double() - b.double()).abs().max().item()
        t = [cuda_ms(fn) for fn in (fn_other, fn_this, fn_this, fn_other)]
        report[label] = {"other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]],
                         "max_abs_diff": err}
    print(smi)
    print(json.dumps({"kernel_ab": report, "device": torch.cuda.get_device_name(0),
                      "timing": "median of 20 CUDA-event timings, each L2-cold"}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
