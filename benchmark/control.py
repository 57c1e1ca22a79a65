#!/usr/bin/env python3
"""Readings of the numbers that decide `correct`, for the program and for
its precision control, on several seeds in one process.

    python3 benchmark/control.py --workload pt4-still --seeds 11,12,13 --seconds 2

For each seed: the cell's set-up and a short window of its traffic, then
the plain reference on the kept frames' tiles (a training cell: its first
steps) in float32 (the yardstick) and in bfloat16 (the control: the
reference put in the program's place in the nearest precision below
float32, which the configuration states).  A training cell also reads the
fault of half of the batch left out, the mean taken over the rest,
planted in the reference.
Prints, a line a seed, the program's readings against the yardstick and
the control's.  The limits in limits/<workload>.json lie between the
largest program reading and the smallest control reading.  Needs CUDA,
as the benchmark does; tests call `readings` on the CPU at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(bench: dict, workload: str, seed: int, seconds: float, device, overrides=None) -> dict:
    """{"program": {...}, "control": {...}} for one seed."""
    import torch

    from benchmark import harness

    device = torch.device(device)
    p = harness.prepare(bench, workload, seed, device, overrides)
    out = harness.DRIVERS[p["traffic"]["kind"]](p["prog"], p["traffic"], p["sc"], p["conf"], p["limits"], seed,
                                                seconds, False, device, p["stages"], time.perf_counter())
    keep = out["keep"]
    t0 = time.perf_counter()
    if p["traffic"]["kind"] == "steps":
        ref = harness.follow_steps(keep, p["sc"], p["sun"], p["conf"], device)
        ref_s = time.perf_counter() - t0
        low = harness.follow_steps(keep, p["sc"], p["sun"], p["conf"], device, dtype=torch.bfloat16)
        half = harness.follow_steps(keep, p["sc"], p["sun"], p["conf"], device,
                                    rows=int(p["conf"]["render"]["height"]) // 2)
        return {"seed": seed, "program": harness.compare_steps(keep, ref),
                "control": harness.compare_steps(keep, ref, cand=low),
                "fault_half_batch": harness.compare_steps(keep, ref, cand=half), "reference_s": ref_s}
    ref = harness.reference_tiles(keep, p["sc"], p["sun"], p["conf"], device)
    ref_s = time.perf_counter() - t0
    low = harness.reference_tiles(keep, p["sc"], p["sun"], p["conf"], device, dtype=torch.bfloat16)
    prog = harness.compare(harness.program_tiles(keep, device), ref["tiles"])
    prog.update(harness.compare_caches(keep, ref))
    ctrl = harness.compare(low["tiles"], ref["tiles"])
    ctrl.update(harness.compare_caches(keep, ref, cand=low))
    for c in (prog, ctrl):
        c.pop("per_frame")
    return {"seed": seed, "frames": sorted(keep.kept), "program": prog, "control": ctrl, "reference_s": ref_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("the control runs on CUDA", file=sys.stderr)
        return 1
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for s in args.seeds.split(","):
        print(json.dumps(readings(bench, args.workload, int(s), args.seconds, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
