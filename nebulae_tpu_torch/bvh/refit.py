"""BVH refit: new node bounds for moved triangles, and the traversal tables
rewritten in place.

Counterpart of `nebulae_tpu/bvh/refit.py`.  The topology (tree, skip
links, triangle permutation, the tables' enc and order-meta columns) stays
as built; only the boxes and the triangle vertices move.  Leaf bounds are
the masked min/max over up to `max_leaf` triangles; inner bounds are built
level by level from the deepest (`compute_levels` groups the nodes on the
host), so a refit is ~tree-depth rounds of device gathers and scatters.

The repacks write columns of the port's row-major tables in place:
fat2 rows [n_inner, 16] (both children's boxes), fat4 rows [n, 32] (four
slot boxes from `fat4_slots`), one-node rows [n, 8] and triangle slots
[n_slots, G, 10] (v0, e1, e2 from `grouped_tri_ids`; the id column stays).
Index arguments may be numpy or tensors; a caller that refits every frame
passes tensors already on the device, so a refit makes no host copy.
"""

from __future__ import annotations

import numpy as np
import torch


def compute_levels(bvh) -> list[np.ndarray]:
    """Node indices grouped by depth (root = level 0), on the host."""
    count = np.asarray(bvh.node_count)
    first = np.asarray(bvh.node_first, np.int64)
    right = np.asarray(bvh.node_right, np.int64)
    n = count.shape[0]
    depth = np.zeros(n, np.int32)
    for i in range(n):  # pre-order: parents precede their children
        if count[i] == 0:
            depth[first[i]] = depth[right[i]] = depth[i] + 1
    return [np.nonzero(depth == d)[0].astype(np.int64) for d in range(int(depth.max(initial=0)) + 1)]


def _index(x, device):
    return torch.as_tensor(x, dtype=torch.long, device=device)


def refit_bvh(topo: dict, tri_pos, levels, max_leaf: int = 4):
    """(node_lo, node_hi) [N, 3] for world triangles tri_pos [T, 3, 3].

    topo holds node_first, node_count, node_right and tri_index (tensors or
    numpy); levels is compute_levels' output."""
    dev = tri_pos.device
    node_first = _index(topo["node_first"], dev)
    node_count = _index(topo["node_count"], dev)
    node_right = _index(topo["node_right"], dev)
    tri_index = _index(topo["tri_index"], dev)
    n = node_first.shape[0]
    t = tri_pos.shape[0]
    tlo = tri_pos.amin(dim=1)
    thi = tri_pos.amax(dim=1)
    is_leaf = node_count > 0
    lo = torch.full((n, 3), float("inf"), dtype=torch.float32, device=dev)
    hi = torch.full((n, 3), float("-inf"), dtype=torch.float32, device=dev)
    for k in range(max_leaf):
        valid = (is_leaf & (k < node_count))[:, None]
        tid = tri_index[torch.clamp(node_first + k, 0, max(t - 1, 0))]
        lo = torch.where(valid, torch.minimum(lo, tlo[tid]), lo)
        hi = torch.where(valid, torch.maximum(hi, thi[tid]), hi)
    for level in reversed(levels):
        idx = _index(level, dev)
        inner = (node_count[idx] == 0)[:, None]
        left = torch.clamp(node_first[idx], 0, n - 1)
        right = torch.clamp(node_right[idx], 0, n - 1)
        lo[idx] = torch.where(inner, torch.minimum(lo[left], lo[right]), lo[idx])
        hi[idx] = torch.where(inner, torch.maximum(hi[left], hi[right]), hi[idx])
    return lo, hi


def repack_fat_bounds(fatnodes, node_lo, node_hi, inner_idx, node_right):
    """Write refit bounds into fat2 rows (pack_bvh_fat): row i holds the
    boxes of inner node inner_idx[i]'s children, inner_idx[i] + 1 and
    node_right[inner_idx[i]].  Returns fatnodes."""
    inner = _index(inner_idx, fatnodes.device)
    right = _index(node_right, fatnodes.device)[inner]
    left = inner + 1
    fatnodes[:, 0:12] = torch.cat([node_lo[left], node_hi[left], node_lo[right], node_hi[right]], dim=1)
    return fatnodes


def repack_fat4_bounds(fat4nodes, node_lo, node_hi, fat4_slots):
    """Write refit bounds into fat4 rows (pack_bvh_fat4): slot k of a row
    takes the box of node fat4_slots[row, k]; an empty slot (-1) keeps the
    zero box that never hits.  Returns fat4nodes."""
    slots = _index(fat4_slots, fat4nodes.device)
    n = node_lo.shape[0]
    for k in range(4):
        sid = slots[:, k]
        valid = (sid >= 0)[:, None]
        sid = torch.clamp(sid, 0, max(n - 1, 0))
        fat4nodes[:, 6 * k:6 * k + 3] = torch.where(valid, node_lo[sid], 0.0)
        fat4nodes[:, 6 * k + 3:6 * k + 6] = torch.where(valid, node_hi[sid], 0.0)
    return fat4nodes


def repack_node_bounds(nodes, node_lo, node_hi):
    """Write refit bounds into one-node rows (pack_bvh_nodes).  Returns nodes."""
    nodes[:, 0:6] = torch.cat([node_lo, node_hi], dim=1)
    return nodes


def repack_tris(tris, tri_pos, slot_tri):
    """Rewrite the triangle slots' v0, e1 and e2 (grouped_tris layout) for
    moved triangles; slot_tri [n_slots, G] is grouped_tri_ids' map (-1
    empty, written as zeros).  The id column stays.  Returns tris."""
    ids = _index(slot_tri, tris.device)
    valid = (ids >= 0)[..., None]
    tp = tri_pos[torch.clamp(ids, 0, max(tri_pos.shape[0] - 1, 0))]
    tris[..., 0:3] = torch.where(valid, tp[..., 0, :], 0.0)
    tris[..., 3:6] = torch.where(valid, tp[..., 1, :] - tp[..., 0, :], 0.0)
    tris[..., 6:9] = torch.where(valid, tp[..., 2, :] - tp[..., 0, :], 0.0)
    return tris
