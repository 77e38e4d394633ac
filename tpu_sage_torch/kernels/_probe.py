"""The body of ``kernels.probe``: load every kernel library (building any
that is missing) from the build directory given, launch each kernel of
``kernels.KERNELS`` once at a tiny shape on the card, and hold it against its
plain version on the same inputs (the wrapper on CPU tensors). Exits 0 only if
every kernel launched once and matched; run in a subprocess by
``probe()``::

    python -m tpu_sage_torch.kernels._probe [BUILD_DIR]
"""

from __future__ import annotations

import json
import sys

import torch

MEAN_PROJECT_TOL = (2.0 ** -7, 1e-4)  # rtol (one bf16 ulp), atol as a share of the scale


def cases(g: torch.Generator) -> dict:
    """``{kernel: (wrapper, CPU arguments)}``, one tiny case per kernel."""
    from tpu_sage_torch.kernels import (gather, gather_blockspec, gather_mean, mean_project,
                                        neighbor_max, neighbor_mean, sample_hop, select)
    from tpu_sage_torch.sample.csr import csr_from_padded

    n, width, d, fanout, b, o = 64, 16, 40, 5, 8, 24
    adj = torch.randint(0, n, (n, width), generator=g, dtype=torch.int32)
    deg = torch.randint(0, width + 1, (n,), generator=g, dtype=torch.int32)
    ids = torch.randint(0, n, (b,), generator=g, dtype=torch.int32)
    u = torch.rand((b, fanout), generator=g)
    fids = torch.randint(0, n, (b * fanout,), generator=g, dtype=torch.int32)
    table = torch.randn((n, d), generator=g).to(torch.bfloat16)
    q = torch.randint(-127, 128, (n, d), generator=g, dtype=torch.int8)
    scale = torch.rand(d, generator=g) + 0.01
    indptr, indices = (torch.from_numpy(a).to(torch.int32)
                       for a in csr_from_padded(adj.numpy(), deg.numpy()))
    x = torch.randn((b, fanout, d), generator=g).to(torch.bfloat16)
    w = (torch.randn((d, o), generator=g) / d ** 0.5).to(torch.bfloat16)
    neigh = torch.randn((b, width, d), generator=g)
    nm_deg = torch.tensor([0, 1, width - 1, width, 3, 7, 0, width], dtype=torch.int32)
    # multiples of 1/4, zero past each degree: every order of the sum is exact,
    # so the kernel's sum equals torch's bitwise
    quarters = (neigh * 4).round() / 4 * (torch.arange(width) < nm_deg[:, None])[..., None]
    return {
        "select_columns": (select.select_columns,
                           (adj[ids.long()], torch.randint(0, width, (b, fanout), generator=g,
                                                           dtype=torch.int32))),
        "sample_hop": (sample_hop.sample_hop, (adj, deg, ids, u)),
        "gather_rows": (gather.gather_rows, (table, fids)),
        "gather_rows_blockspec": (gather_blockspec.gather_rows_blockspec, (table, fids)),
        "gather_fanout_mean": (gather_mean.gather_fanout_mean, (table, fids, fanout)),
        "mean_project": (mean_project.mean_project, (x, w)),
        "gather_fanout_mean_int8": (gather_mean.gather_fanout_mean_int8,
                                    (q, scale, fids, fanout, torch.bfloat16)),
        "sample_hop_csr": (sample_hop.sample_hop_csr, (indptr, indices, deg, ids, u)),
        "gather_fanout_mean_owned": (gather_mean.gather_fanout_mean_owned,
                                     (table[16:48].contiguous(), fids, fanout, 16)),
        "select_hop": (lambda rows, u, i: select.select_hop(rows[:, :-1], rows[:, -1], u, ids=i),
                       (torch.cat([adj[ids.long()], deg[ids.long(), None]], 1), u, ids)),
        "csr_tree": (lambda p, x, dg, i, u0, u1: torch.cat(sample_hop.csr_tree(p, x, dg, i,
                                                                              [u0, u1])),
                     (indptr, indices, deg, ids, u, torch.rand((b * fanout, 3), generator=g))),
        "neighbor_max": (neighbor_max.neighbor_max, (neigh, nm_deg, neigh[:, 0] + 1.0)),
        "neighbor_mean": (neighbor_mean.neighbor_mean, (quarters, nm_deg, neigh[:, 0] + 1.0)),
        # ids past both ends of the table: their own bucket; shift 3: 9 buckets
        "gather_order": (lambda i: torch.stack(gather.gather_order(i, n, 3)),
                         (torch.randint(-2, n + 2, (3000,), generator=g, dtype=torch.int32),)),
    }


def run() -> dict:
    """``{kernel: {"launches", "max_abs_err", "ok"}}`` for every kernel."""
    from tpu_sage_torch import kernels
    from tpu_sage_torch.kernels import _build

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: torch.cuda.is_available() is false")
    _build.build()
    todo = cases(torch.Generator().manual_seed(0))
    if set(todo) != set(kernels.KERNELS):
        raise RuntimeError(f"probe cases {sorted(todo)} are not the kernels "
                           f"{sorted(kernels.KERNELS)}")
    out = {}
    for name, (fn, args) in todo.items():
        want = fn(*args)
        on_card = [a.cuda() if isinstance(a, torch.Tensor) else a for a in args]
        kernels.reset_launch_counts()
        got = fn(*on_card)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()[name]
        got = got.cpu()
        err = (got.double() - want.double()).abs().max().item()
        if name == "mean_project":
            rtol, atol = MEAN_PROJECT_TOL
            ok = torch.allclose(got.float(), want.float(), rtol=rtol,
                                atol=atol * want.float().abs().max().item())
        else:
            ok = got.dtype == want.dtype and torch.equal(got, want)
        out[name] = {"launches": launches, "max_abs_err": err, "ok": bool(ok and launches == 1)}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        from tpu_sage_torch.kernels import _build

        _build.BUILD_DIR = argv[0]
    result = run()
    print(json.dumps(result))
    return 0 if all(r["ok"] for r in result.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
