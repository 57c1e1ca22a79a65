"""Metrics export: structured counters for frames, rays, losses.

As `nebulae_tpu/utils/metrics.py`: scalars and counts gathered between
flushes, each flush one JSON row {"time", "step", scalars..., counts...}
appended to a JSONL stream (counts accumulate across flushes).

Besides, one process-wide table of integer counters that the program
advances where the number is already on the host (no sync, no device op):
`count(name, n)` and `totals()`.  Its names:

  * "lanes.full", "lanes.walked": lanes offered to and kept by each live-lane
    compaction of a path vertex's walk (tracer/sorting.py);
  * "rays.closest", "rays.combo", "rays.any": rays into each of the tracer's
    callables (tracer/trace.py; a combo ray is a lane's shadow and bounce);
  * "atrous.passes", "atrous.pixels": a-trous passes and the pixels they
    filter (kernels/svgf.py);
  * "nrc.query_rows", "nrc.query_full": rows the query pass's inline
    resolve gave the cache, and the lanes times resolves a full-width
    resolve would have given it (passes/nrc_pathtrace.py);
  * "refit.calls", "refit.triangles", "refit.levels": scene updates, the
    triangle rows each rewrote and the BVH levels each walked
    (engine/renderer.py, update_instances and update_geometry).
"""

from __future__ import annotations

import json
import time
from pathlib import Path

_totals: dict[str, int] = {}


def count(name: str, n: int = 1):
    """Add n to the process-wide counter `name` (from the thread that
    issues the work: no lock)."""
    _totals[name] = _totals.get(name, 0) + n


def totals() -> dict[str, int]:
    """A copy of every process-wide counter."""
    return dict(_totals)


class MetricsLogger:
    def __init__(self, path: str | Path | None = None):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
        self._scalars: dict[str, float] = {}
        self._counts: dict[str, int] = {}
        self.t0 = time.time()

    def scalar(self, name: str, value: float):
        self._scalars[name] = float(value)

    def count(self, name: str, inc: int = 1):
        self._counts[name] = self._counts.get(name, 0) + inc

    def flush(self, step: int | None = None) -> dict:
        rec = {
            "time": round(time.time() - self.t0, 3),
            **({"step": step} if step is not None else {}),
            **self._scalars,
            **self._counts,
        }
        if self.path:
            with self.path.open("a") as f:
                f.write(json.dumps(rec) + "\n")
        self._scalars.clear()
        return rec
