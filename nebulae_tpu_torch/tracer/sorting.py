"""Live-lane compaction for the per-vertex traces.

Counterpart of what `nebulae_tpu/tracer/sorting.py` means for
`sorted_any` and `sorted_shadow_closest`: trace only the lanes that take
part, run `compact_post` on their hits while they are compact, and scatter
every channel back to pixel order with a fill for the other lanes.  On the
GPU compaction is exact (`torch.nonzero`): there are no static buckets and
no bucket schedule.  With a key, the live lanes are traced in key order
(`kernels/vertex.py` ray_sort_key) for coherence; no output depends on that
order.  Each compaction waits on the device for its count
("nebulae/sync/compact") and adds the lanes it was offered and kept to the
counters "lanes.full" and "lanes.walked" (utils/metrics.py).
"""

from __future__ import annotations

import torch

from nebulae_tpu_torch.utils.metrics import count
from nebulae_tpu_torch.utils.profiling import span

DEAD_ORIGIN = 1.0e14  # far outside any scene: the traversal misses at once


def live_lanes(mask, key=None):
    """Indices of the lanes in `mask`, in key order when a key is given."""
    with span("nebulae/sync/compact"):
        idx = torch.nonzero(mask)[:, 0]
    count("lanes.full", mask.shape[0])
    count("lanes.walked", idx.numel())
    if key is not None and idx.numel() > 1:
        idx = idx[torch.argsort(key[idx], stable=True)]
    return idx


def _scatter(n, idx, values, fill):
    out = torch.full((n,) + values.shape[1:], fill, dtype=values.dtype, device=values.device)
    out[idx] = values
    return out


def sorted_any(any_fn, o, d, live, key=None):
    """Occlusion of the `live` lanes; False elsewhere."""
    idx = live_lanes(live, key)
    return _scatter(o.shape[0], idx, any_fn(o[idx], d[idx]), False)


def sorted_shadow_closest(combo_fn, o, l, b, shoot, alive, key=None,
                          compact_post=None, post_fills: dict | None = None):
    """Shadow ray l (lanes in `shoot`) and bounce ray b (lanes in `alive`)
    from the same origins o, in one fused walk over the participating lanes.

    Without `compact_post` returns (occluded [N], dict(t, tri, u, v),
    walked) with miss records on lanes that do not bounce.  With it,
    `compact_post(hit, o, b)` runs on the compact hits and must return a
    dict holding "mat" (-1 on a miss) plus float channels; the result is
    then (occluded, dict of t, mat, found and the post channels, walked),
    each lane not traced holding `post_fills.get(name, 0)`.  `walked` holds
    the traced lanes' indices (live_lanes of shoot | alive; their count is
    on the host)."""
    n = o.shape[0]
    idx = live_lanes(shoot | alive, key)
    cap_b = torch.where(alive[idx], float("inf"), 0.0)
    cap_l = torch.where(shoot[idx], float("inf"), 0.0)
    hit, occ_c = combo_fn(o[idx], b[idx], l[idx], cap_b, cap_l)
    hit = {k: v.detach() for k, v in hit.items()}
    occ = _scatter(n, idx, occ_c, False)
    if compact_post is None:
        fills = {"t": float("inf"), "tri": -1, "u": 0.0, "v": 0.0}
        return occ, {k: _scatter(n, idx, hit[k], fills[k]) for k in ("t", "tri", "u", "v")}, idx
    fills = dict(post_fills or {})
    extras = compact_post(hit, o[idx], b[idx])
    mat = _scatter(n, idx, torch.round(extras.pop("mat")).to(torch.int64), -1)
    out = {"t": _scatter(n, idx, hit["t"], float("inf")), "mat": mat, "found": mat >= 0}
    for k, v in extras.items():
        out[k] = _scatter(n, idx, v.detach(), float(fills.get(k, 0.0)))
    return occ, out, idx
