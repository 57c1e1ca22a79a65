"""Reading a torch.profiler Chrome trace: device busy time, device time by
the host range that launched it, syncs, and the breakdown the result
line carries.

A device operation is a kernel, a copy or a set.  Its launch is the
runtime event with the same correlation id; it belongs to a host range
(`record_function`) when the launch lies inside that range.  Busy time is
the union of the device operations' spans.  Times in a Chrome trace are
microseconds; everything here returns seconds.
"""

from __future__ import annotations

import bisect
import json
import tempfile
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def export_events(prof) -> list:
    """A finished profiler's events, through a Chrome trace written under
    the temporary directory (TMPDIR) and removed again."""
    with tempfile.TemporaryDirectory(prefix="nebulae-bench-") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())["traceEvents"]


class Trace:
    """The events of one traced window."""

    def __init__(self, events: list):
        self.events = events
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        self.launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                          if (e.get("cat") or "").startswith("cuda_") and "correlation" in e.get("args", {})}

    @staticmethod
    def union_s(spans) -> float:
        total, end = 0.0, float("-inf")
        for s, e in sorted(spans):
            if e > end:
                total += e - max(s, end)
                end = e
        return total / 1e6

    def busy_s(self) -> float:
        return self.union_s((e["ts"], e["ts"] + e["dur"]) for e in self.device)

    def ranges(self, name: str) -> list:
        """(start, end) of every host range called `name`."""
        return [(e["ts"], e["ts"] + e["dur"]) for e in self.events
                if e.get("cat") == "user_annotation" and e.get("name") == name and "dur" in e]

    def launched_in(self, name: str, cats=DEVICE_CATS) -> list:
        """The device operations of `cats` whose launch lies inside a host
        range called `name`."""
        spans = sorted(self.ranges(name))
        out = []
        for e in self.device:
            if e.get("cat") not in cats:
                continue
            ts = self.launch_ts.get(e.get("args", {}).get("correlation"))
            if ts is not None and any(s <= ts <= t for s, t in spans):
                out.append(e)
        return out

    def device_s_in(self, *names: str, cats=DEVICE_CATS) -> float:
        """Device seconds launched inside any of the ranges `names`, each
        operation counted once."""
        seen = {}
        for n in names:
            for e in self.launched_in(n, cats):
                seen[id(e)] = e["dur"]
        return sum(seen.values()) / 1e6

    def syncs(self) -> int:
        """Host waits on the device: the runtime's synchronize calls."""
        return sum(1 for e in self.events if (e.get("cat") or "").startswith("cuda_")
                   and "Synchronize" in e.get("name", ""))

    def device_ops(self) -> int:
        return len(self.device)

    def top_device_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time,
        summed by name."""
        by = {}
        for e in self.device:
            by[e["name"]] = by.get(e["name"], 0.0) + e["dur"] / 1e6
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    @staticmethod
    def _innermost(events, starts, t, reach: int = 256):
        """Name of the latest-starting event of `events` (sorted by start)
        that spans time t, looking back `reach` events."""
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - reach, -1), -1):
            if events[j]["ts"] + events[j]["dur"] >= t:
                return events[j]["name"]
        return None

    def idle_gaps(self, n: int = 10) -> list:
        """[[what the host was doing, seconds]]: the gaps between device
        operations inside the traced window, each named by the innermost
        host range and operator running at its middle, summed by name."""
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        ops = sorted((e for e in self.events if e.get("cat") == "cpu_op" and "dur" in e), key=lambda e: e["ts"])
        starts = [e["ts"] for e in ops]
        ranges = sorted((e for e in self.events if e.get("cat") == "user_annotation" and "dur" in e),
                        key=lambda e: e["ts"])
        r_starts = [e["ts"] for e in ranges]
        by = {}
        end = None
        for s, t in spans:
            if end is not None and s > end:
                mid = 0.5 * (end + s)
                op = self._innermost(ops, starts, mid)
                inner = self._innermost(ranges, r_starts, mid)
                label = " > ".join(x for x in (inner, op) if x) or "host outside any operator"
                by[label] = by.get(label, 0.0) + (s - end) / 1e6
            end = t if end is None else max(end, t)
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
