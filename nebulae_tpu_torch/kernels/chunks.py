"""Large-scene tables and their chained walks: subtree chunks (K6c, fat4 or
fat2) and triangle chunks (K6b), with the routing limits.

Replaces `nebulae_tpu/kernels/pallas_trace.py`'s pack_bvh_chunks,
pack_bvh_tri_chunks, pallas_{closest,any,shadow_closest}_tri_chunks and
pallas_{closest,any,shadow_closest}_chunks.  The limits are module
attributes read at call time, so a caller (or a test) can shrink them.
They size the TPU's VMEM; the port keeps them so that a scene takes the
route the JAX renderer gives it.

The chains keep JAX's cap rules: each pass's closest cap is
min(best t, t_max) and its hit is taken only where tri >= 0; occluded rays
are ejected to 10 * DEAD_RAY_ORIGIN before the next any-hit pass; in the
fused walk the shadow cap drops to 0 once a ray is occluded.  The chunk
count is fixed per scene and no pass reads a result back to the host.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from nebulae_tpu_torch.kernels import trace as kt

MAX_CHUNK_TRIS = 150 * 1024
SINGLE_TABLE_MAX_TRIS = 160 * 1024
SINGLE_TABLE_MAX_BYTES = 80 * 1024 * 1024
TRI_CHUNK_TABLE_BUDGET = 13 * 1024 * 1024
LANES = 128  # the TPU tables' row padding, for byte counts in JAX's layout


def _padded_rows(n: int) -> int:
    return max(-(-n // LANES), 1) * LANES


def jax_table_bytes(packed: dict) -> int:
    """Bytes of the same fat4 tables in the JAX package's layout, whose
    rows are padded to a multiple of 128: the single-table byte gate
    compares these, so a scene takes JAX's route at the boundary."""
    n_slots, g = packed["tris"].shape[:2]
    return (_padded_rows(n_slots) * g * kt.TRI_STRIDE * 4
            + _padded_rows(packed["fat4nodes"].shape[0]) * kt.NODE_STRIDE * 4)


def _subtree_counts(bvh) -> np.ndarray:
    """Triangles under each node (children follow parents in pre-order)."""
    n = int(bvh.node_lo.shape[0])
    count = np.asarray(bvh.node_count, np.int64)
    right = np.asarray(bvh.node_right, np.int64)
    counts = np.zeros(n, np.int64)
    for i in range(n - 1, -1, -1):
        counts[i] = count[i] if count[i] > 0 else counts[i + 1] + counts[right[i]]
    return counts


def _cut_roots(bvh, counts, max_tris: int) -> list[int]:
    """Pre-order roots of the subtrees holding at most max_tris triangles
    (or single leaves), as JAX cuts them."""
    is_leaf = np.asarray(bvh.node_count) > 0
    cuts, stack = [], [0]
    while stack:
        i = stack.pop()
        if is_leaf[i] or counts[i] <= max_tris:
            cuts.append(i)
        else:
            stack.append(int(bvh.node_right[i]))
            stack.append(i + 1)
    return sorted(cuts)


def pack_bvh_chunks(bvh, tri_pos: np.ndarray, max_tris: int | None = None,
                    tri_group: int = 8, wide: int = 4) -> list[dict]:
    """pack_bvh_chunks: cut the BVH into subtrees of at most max_tris
    (default MAX_CHUNK_TRIS) triangles; each becomes an independent table,
    fat4 (wide=4) or fat2 (any other width, as JAX packs it) when its root
    is inner and one-node (K8) when it is a single leaf.  Triangle ids stay
    global; each chunk has its own stack_depth."""
    max_tris = MAX_CHUNK_TRIS if max_tris is None else max_tris
    pack_fat = kt.pack_bvh_fat4 if wide == 4 else kt.pack_bvh_fat
    is_leaf = np.asarray(bvh.node_count) > 0
    counts = _subtree_counts(bvh)
    chunks = []
    for r in _cut_roots(bvh, counts, max_tris):
        e = int(bvh.node_skip[r])
        leaf_mask = is_leaf[r:e]
        tri_base = int(bvh.node_first[r:e][leaf_mask].min())
        sub = SimpleNamespace(
            node_lo=bvh.node_lo[r:e],
            node_hi=bvh.node_hi[r:e],
            node_first=np.where(leaf_mask, bvh.node_first[r:e] - tri_base, 0).astype(np.int64),
            node_count=bvh.node_count[r:e],
            node_right=np.where(leaf_mask, -1, bvh.node_right[r:e] - r).astype(np.int64),
            tri_index=bvh.tri_index[tri_base:tri_base + int(counts[r])],
        )
        chunks.append(pack_fat(sub, tri_pos, tri_group) or kt.pack_bvh_nodes(sub, tri_pos, tri_group))
    return chunks


def pack_bvh_tri_chunks(bvh, tri_pos: np.ndarray, tri_group: int = 8) -> dict | None:
    """pack_bvh_tri_chunks: whole-tree fat4 nodes plus triangle chunks.
    Returns the fat4 tables with "tri_chunks", the global slot ranges
    [(lo, hi), ...] of pre-order subtree cuts sized to
    TRI_CHUNK_TABLE_BUDGET (in JAX's padded bytes); tables_to makes each
    chunk the view tris[lo:hi].  None when the root is a leaf, when the
    nodes leave no room, or when the whole table fits (JAX's cases)."""
    full = kt.pack_bvh_fat4(bvh, tri_pos, tri_group)
    if full is None:
        return None
    g = int(tri_group)
    budget = TRI_CHUNK_TABLE_BUDGET - _padded_rows(full["fat4nodes"].shape[0]) * kt.NODE_STRIDE * 4
    max_slots = budget // (kt.TRI_STRIDE * g * 4)
    if max_slots < LANES:
        return None
    counts = _subtree_counts(bvh)
    if counts[0] <= max_slots * g:
        return None
    node_count = np.asarray(bvh.node_count, np.int64)
    leaf_nodes = np.nonzero(node_count > 0)[0]
    sc = (node_count[leaf_nodes] + g - 1) // g
    sf = np.zeros_like(sc)
    sf[1:] = np.cumsum(sc)[:-1]
    ranges = []
    for r in _cut_roots(bvh, counts, int(max_slots) * g):
        inside = (leaf_nodes >= r) & (leaf_nodes < int(bvh.node_skip[r]))
        if inside.any():
            ranges.append((int(sf[inside].min()), int((sf + sc)[inside].max())))
    return {**full, "tri_chunks": ranges}


# ---------------------------------------------------------------------------
# Chained walks
# ---------------------------------------------------------------------------


def _tighten(t, t_max):
    """min(t, t_max) for a Python or per-ray t_max, without a host copy."""
    if isinstance(t_max, torch.Tensor):
        return torch.minimum(t, t_max)
    return torch.clamp(t, max=float(t_max))


def _per_ray(t_max, ref):
    if isinstance(t_max, torch.Tensor):
        return torch.broadcast_to(t_max.to(ref.device, torch.float32), ref.shape[:1])
    return torch.full(ref.shape[:1], float(t_max), dtype=torch.float32, device=ref.device)


def _merge(best, hit):
    if best is None:
        return hit
    take = hit["tri"] >= 0
    return {k: torch.where(take, hit[k], best[k]) for k in ("t", "tri", "u", "v")}


def _eject(o, occ):
    return torch.where(occ[:, None], 10.0 * kt.DEAD_RAY_ORIGIN, o)


def closest_tri_chunks(o, d, tables: dict, t_max=float("inf")):
    """Closest hit over whole-tree nodes and triangle chunks: one K6b walk
    per chunk under the caps the earlier chunks tightened."""
    best = None
    for c in tables["tri_chunks"]:
        cap = t_max if best is None else _tighten(best["t"], t_max)
        best = _merge(best, kt.closest_hit_fat4_slots(o, d, c, cap))
    return best


def any_tri_chunks(o, d, tables: dict, t_max=float("inf")):
    occ = None
    for c in tables["tri_chunks"]:
        o_live = o if occ is None else _eject(o, occ)
        hit = kt.any_hit_fat4_slots(o_live, d, c, t_max)
        occ = hit if occ is None else occ | hit
    return occ


def shadow_closest_tri_chunks(o, b, l, tables: dict, t_max_b=float("inf"), t_max_l=float("inf")):
    tb, tl = _per_ray(t_max_b, o), _per_ray(t_max_l, o)
    best = None
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for c in tables["tri_chunks"]:
        cap_b = tb if best is None else torch.minimum(best["t"], tb)
        cap_l = torch.where(occ, 0.0, tl)
        hit, o2 = kt.shadow_closest_fat4_slots(o, b, l, c, cap_b, cap_l)
        occ = occ | o2
        best = _merge(best, hit)
    return best, occ


def _chunk_closest(o, d, c, t_max):
    if "fat4nodes" in c:
        return kt.closest_hit_fat4(o, d, c, t_max)
    if "fatnodes" in c:
        return kt.closest_hit_fat(o, d, c, t_max)
    return kt.closest_hit_node(o, d, c, t_max)


def _chunk_any(o, d, c, t_max):
    if "fat4nodes" in c:
        return kt.any_hit_fat4(o, d, c, t_max)
    if "fatnodes" in c:
        return kt.any_hit_fat(o, d, c, t_max)
    return kt.any_hit_node(o, d, c, t_max)


def closest_chunks(o, d, chunks: list, t_max=float("inf")):
    """Closest hit over subtree chunks (pack_bvh_chunks): K1, K7a or K8 per
    chunk with tightening caps."""
    best = None
    for c in chunks:
        cap = t_max if best is None else _tighten(best["t"], t_max)
        best = _merge(best, _chunk_closest(o, d, c, cap))
    return best


def any_chunks(o, d, chunks: list, t_max=float("inf")):
    """Any hit over subtree chunks: K3, K7c or K8 per chunk, occluded rays
    ejected between chunks."""
    occ = _chunk_any(o, d, chunks[0], t_max)
    for c in chunks[1:]:
        occ = occ | _chunk_any(_eject(o, occ), d, c, t_max)
    return occ


def shadow_closest_chunks(o, b, l, chunks: list, t_max_b=float("inf"), t_max_l=float("inf")):
    """Fused shadow+bounce over subtree chunks: K2 per fat4 chunk, K7b per
    fat2 chunk, K8 closest then K8 any on a single-leaf chunk."""
    tb, tl = _per_ray(t_max_b, o), _per_ray(t_max_l, o)
    best = None
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for c in chunks:
        cap_b = tb if best is None else torch.minimum(best["t"], tb)
        cap_l = torch.where(occ, 0.0, tl)
        if "fat4nodes" in c:
            hit, o2 = kt.shadow_closest_fat4(o, b, l, c, cap_b, cap_l)
        elif "fatnodes" in c:
            hit, o2 = kt.shadow_closest_fat(o, b, l, c, cap_b, cap_l)
        else:
            hit, o2 = kt.closest_hit_node(o, b, c, cap_b), kt.any_hit_node(o, l, c, cap_l)
        occ = occ | o2
        best = _merge(best, hit)
    return best, occ
