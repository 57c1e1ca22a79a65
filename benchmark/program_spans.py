"""What the readers of the program's own ranges share: where the host waits
on the device, and the device time launched inside a range, read from the
window that records the host's ranges (run["trace"]).

The program opens a range "nebulae/<phase>" around each phase of a frame
or step and "nebulae/sync/<site>" around each place where the host waits
on the device (nebulae_tpu_torch/utils/profiling.py).  A runtime
synchronize call belongs to a range when it starts inside it; a device
idle gap opens where a busy interval ends.  Ranges are matched by time
alone, on any thread: autograd's device thread syncs while the calling
thread waits inside "nebulae/backward".
"""

from __future__ import annotations

import bisect

from benchmark.chrometrace import Trace

PROGRAM = "nebulae/"
SYNC = "nebulae/sync/"


class Spans:
    """The union of a set of intervals, for point queries."""

    def __init__(self, spans):
        self.starts, self.ends = [], []
        for s, e in sorted(spans):
            if self.ends and s <= self.ends[-1]:
                self.ends[-1] = max(self.ends[-1], e)
            else:
                self.starts.append(s)
                self.ends.append(e)

    def __contains__(self, t) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def ranges_named(trace: Trace, prefix: str) -> Spans:
    """Every host range whose name starts with `prefix`."""
    return Spans((e["ts"], e["ts"] + e["dur"]) for e in trace.events
                 if e.get("cat") == "user_annotation" and e.get("name", "").startswith(prefix) and "dur" in e)


def sync_starts(trace: Trace) -> list:
    """Start of each runtime synchronize call (the calls Trace.syncs counts)."""
    return [e["ts"] for e in trace.events
            if (e.get("cat") or "").startswith("cuda_") and "Synchronize" in e.get("name", "")]


def _traced(run, kind: str) -> bool:
    return run["kind"] == kind and run.get("trace") is not None


def unnamed_syncs(run, kind: str):
    """Synchronize calls an item that start inside a "nebulae/" range and
    inside no "nebulae/sync/" one: the host waits the program has not
    named.  0.0 where there are none."""
    if not _traced(run, kind):
        return None
    tr = run["trace"]
    program, named = ranges_named(tr, PROGRAM), ranges_named(tr, SYNC)
    n = sum(1 for t in sync_starts(tr) if t in program and t not in named)
    return n / run["count"]


def sync_idle(run, kind: str):
    """% of the device's idle time between its operations that falls in
    gaps opening while the host is inside a "nebulae/sync/" range: the
    device drained while the host waited at a named sync.  0.0 where no
    such range ran (a program that names no syncs) or nothing idled."""
    if not _traced(run, kind) or not run["trace"].device:
        return None
    tr = run["trace"]
    named = ranges_named(tr, SYNC)
    busy = Spans((e["ts"], e["ts"] + e["dur"]) for e in tr.device)
    idle = at_sync = 0.0
    for end, nxt in zip(busy.ends, busy.starts[1:]):
        idle += nxt - end
        if end in named:
            at_sync += nxt - end
    return at_sync / idle * 100.0 if idle > 0 else 0.0


def range_busy_ms(run, kind: str, name: str):
    """Device ms an item launched inside the program's range `name`.  0.0
    where no such range ran (a program that does not open it)."""
    if not _traced(run, kind):
        return None
    return run["trace"].device_s_in(name) / run["count"] * 1e3
