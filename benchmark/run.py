#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload pt4-still --seed 7 --seconds 10 --trace 0

From the root of a checkout.  Needs CUDA with as many cards as the cell
asks for; prints nothing and exits 1 otherwise.  With --trace 0 the result
carries the cell's end-to-end metrics, with --trace 1 its per-layer
metrics read from a profiled window.  The last line on standard output is
the result (JSON); the lines before it break set-up down by stage.  The
numbers compared for `correct`, each beside its limit, end standard error
and the result line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# One process with few threads: the frame's host work is one Python thread
# issuing kernels; idle worker pools only compete with it for the cores.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "2")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nebulae_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of FORBIDDEN, compared whole: nebulae_tpu_torch is not
    nebulae_tpu."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # The script's own directory would put the benchmark's modules at the
    # top level beside the standard ones: import the benchmark as a package.
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(here)]
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 1

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    from benchmark.harness import run_cell

    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 1
    print(json.dumps({"diagnostics": out["diagnostics"], "readings": out["readings"]}))
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
