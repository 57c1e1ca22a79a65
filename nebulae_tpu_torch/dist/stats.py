"""Collective volume and shard balance (as `nebulae_tpu/dist/stats.py`).

JAX counts the bytes of the collectives the partitioner put in a compiled
step by parsing its HLO.  The port issues its collectives itself, through
dist/comm.py, which logs each call; `collective_stats` sums that log.  A
step whose collective bytes stay small beside its work, with equal shards,
is the precondition for scaling over ranks.
"""

from __future__ import annotations

from collections import defaultdict

import torch

from nebulae_tpu_torch.dist.comm import all_gather_rows
from nebulae_tpu_torch.dist.mesh import World


def collective_stats(log) -> dict:
    """{op: {"count", "bytes", "sent", "ms", "tags": {tag: bytes}}} over the
    entries of a World.log (or a slice of one), plus "total_bytes",
    "total_sent" and "total_ms".  "bytes" are the results' bytes on the
    rank (JAX's measure), "sent" the bytes the rank put in."""
    out: dict = defaultdict(lambda: {"count": 0, "bytes": 0, "sent": 0, "ms": 0.0, "tags": defaultdict(int)})
    for e in log:
        s = out[e["op"]]
        s["count"] += 1
        s["bytes"] += e["bytes"]
        s["sent"] += e["sent"]
        s["ms"] += e["ms"]
        s["tags"][e["tag"]] += e["bytes"]
    result = {k: {**v, "tags": dict(v["tags"])} for k, v in out.items()}
    result["total_bytes"] = sum(v["bytes"] for v in out.values())
    result["total_sent"] = sum(v["sent"] for v in out.values())
    result["total_ms"] = sum(v["ms"] for v in out.values())
    return result


def shard_balance(world: World, shard) -> dict:
    """{"shards": n, "rows": [rows on each rank], "balanced": bool} of a
    row-sharded tensor, read from every rank (a collective).  Ray work is
    uniform in rows (one primary ray a pixel), so equal rows are equal
    ray counts."""
    rows = all_gather_rows(world, torch.tensor([shard.shape[0]], device=world.device), "balance")
    rows = [int(r) for r in rows.tolist()]
    return {"shards": len(rows), "rows": rows, "balanced": len(set(rows)) == 1}
