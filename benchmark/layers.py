"""What the per-layer readers share: each reads one quantity of a traced
run of one kind of cell ("frames" or "steps") and returns None where the
run has nothing of it to read.

The device's busy time, its operations and the host's syncs come from
the first traced window, which records device activity alone; the
profiler slows the host's issue (by 20-40% a frame on the H100), not the
device's operations, so the idle share sets the busy time an item
against the wall time of an untraced item of the same run.  Device time
by the host range that launched it, and the ray and a-trous counts, come
from the second window, which records the host's operators and ranges
too."""

from __future__ import annotations

import re

from benchmark.work.atrous import bwd_pass_bytes, pass_bytes, pass_ops
from benchmark.work.peaks import bound_s
from benchmark.work.trace import call_bytes

ATROUS_BWD = re.compile(r"atrous\w*bwd|bwd\w*atrous")


def _traced(run, kind: str) -> bool:
    return run["kind"] == kind and run.get("device_trace") is not None


def device_idle(run, kind: str):
    """% of an untraced item's wall time in which no operation ran on the
    device: 1 - (busy seconds an item, traced) / (seconds an item,
    untraced)."""
    if not _traced(run, kind) or not run["device_trace"].device:
        return None
    busy = run["device_trace"].busy_s() / run["device_count"]
    return (1.0 - busy / run["untraced_item_s"]) * 100.0


def device_ops(run, kind: str):
    """Kernels, copies and sets an item, in the device-only window."""
    if not _traced(run, kind) or not run["device_trace"].device:
        return None
    return run["device_trace"].device_ops() / run["device_count"]


def host_syncs(run, kind: str):
    """The runtime's synchronize calls an item, in the device-only window."""
    if not _traced(run, kind):
        return None
    return run["device_trace"].syncs() / run["device_count"]


def busy_ms(run, kind: str, *ranges: str):
    """Device ms an item launched inside any of the host `ranges`."""
    if not _traced(run, kind):
        return None
    s = run["trace"].device_s_in(*ranges)
    return s / run["count"] * 1e3 if s > 0 else None


def trace_roofline(run, kind: str):
    """% of its roofline the ray casting reaches: the least time of the
    rays cast through the tracer's entry over the device time of the
    kernels launched inside those calls."""
    if not _traced(run, kind) or not run["trace_calls"]:
        return None
    kernel_s = run["trace"].device_s_in("benchmark/trace", cats=("kernel",))
    if kernel_s <= 0:
        return None
    least = sum(bound_s(call_bytes(k, n, run["n_tris"])) for k, n in run["trace_calls"] if n > 0)
    return least / kernel_s * 100.0


def atrous_roofline(run, kind: str, backward: bool = False):
    """% of its roofline the a-trous passes reach: each pass over its h x w
    image (with `backward`, also its transposed stencil, as many as the
    forward passes, on the kernels named like the backward's) over the
    device time of those kernels."""
    if not _traced(run, kind) or not run["atrous_calls"]:
        return None
    tr = run["trace"]
    kernel_s = tr.device_s_in("benchmark/atrous", cats=("kernel",))
    least = sum(bound_s(pass_bytes(h, w), pass_ops(h, w)) for h, w in run["atrous_calls"])
    if backward:
        bwd_s = sum(e["dur"] for e in tr.device if e.get("cat") == "kernel" and ATROUS_BWD.search(e["name"])) / 1e6
        if bwd_s <= 0:
            return None
        kernel_s += bwd_s
        least += sum(bound_s(bwd_pass_bytes(h, w), pass_ops(h, w)) for h, w in run["atrous_calls"])
    return least / kernel_s * 100.0 if kernel_s > 0 else None
