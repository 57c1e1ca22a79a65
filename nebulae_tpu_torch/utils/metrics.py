"""Metrics export: structured counters for frames, rays, losses.

As `nebulae_tpu/utils/metrics.py`: scalars and counts gathered between
flushes, each flush one JSON row {"time", "step", scalars..., counts...}
appended to a JSONL stream (counts accumulate across flushes).
"""

from __future__ import annotations

import json
import time
from pathlib import Path


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
