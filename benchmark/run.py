"""Run one cell of ``BENCHMARK.json`` on the card and print its result line::

    python3 -m benchmark.run --workload reddit-sup.exact-embed --seed 7 \\
        --seconds 10 --trace 0

Set-up, then ``--seconds`` of measured steps, then (``--trace 1``) a short
profiled stretch, then the comparison with the plain reference. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each compared number beside its limit; the same numbers are
the last lines of standard error. Without a CUDA card, or with fewer cards
than the cell asks for, or with JAX or the JAX package loaded, it prints no
result and exits with a code other than 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# kernel caches of the libraries the program may use, at fixed paths in the checkout
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(HERE, "..", "build", "benchmark", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(HERE, "..", "build", "benchmark", "torch_extensions"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    spec = harness.load_cell(args.workload)
    if torch.cuda.device_count() < spec["chips"]:
        print(f"benchmark: {args.workload} needs {spec['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0))
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {found}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
