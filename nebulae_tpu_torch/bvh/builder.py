"""Binned-SAH BVH2 builder with a skip-link flat layout (numpy).

The port's own copy of `nebulae_tpu/bvh/builder.py`: a test checks that
both give the same tree bit for bit.  The engine builds the same layout
with the C++ builder on both devices (`bvh/cbuilder.py`,
`csrc/bvh_builder.cpp`); this one builds the empty scene's tree.

Flat arrays (N nodes, T triangles, reordered):
  node_lo, node_hi  [N, 3] f32   node AABBs
  node_first        [N]    i32   inner: left-child index (== i+1); leaf: first tri
  node_count        [N]    i32   0 for inner, #tris for leaf
  node_skip         [N]    i32   next pre-order node after this subtree (N = done)
  node_right        [N]    i32   inner: right-child index; leaf: -1
  tri_index         [T]    i32   permutation into the original triangle order
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

N_BINS = 16
MAX_LEAF = 4
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0


@dataclass
class FlatBVH:
    node_lo: np.ndarray
    node_hi: np.ndarray
    node_first: np.ndarray
    node_count: np.ndarray
    node_skip: np.ndarray
    node_right: np.ndarray
    tri_index: np.ndarray

    @property
    def num_nodes(self) -> int:
        return int(self.node_lo.shape[0])

    def device_arrays(self) -> dict:
        return {
            "node_lo": self.node_lo,
            "node_hi": self.node_hi,
            "node_first": self.node_first,
            "node_count": self.node_count,
            "node_skip": self.node_skip,
            "node_right": self.node_right,
            "tri_index": self.tri_index,
        }


def _sah_split(ids, cent, tlo, thi):
    """Find the best binned-SAH split for triangle subset `ids`.

    Returns (axis, left_ids, right_ids) or None if a leaf is better/forced.
    """
    n = ids.shape[0]
    c = cent[ids]
    clo, chi = c.min(0), c.max(0)
    ext = chi - clo
    axis = int(np.argmax(ext))
    if ext[axis] <= 1e-12:
        return None  # degenerate: all centroids identical
    # Bin triangle centroids along the chosen axis.
    scale = N_BINS * (1.0 - 1e-6) / ext[axis]
    bin_ids = ((c[:, axis] - clo[axis]) * scale).astype(np.int32)
    lo_t, hi_t = tlo[ids], thi[ids]
    # Per-bin counts + bounds.
    counts = np.bincount(bin_ids, minlength=N_BINS)
    blo = np.full((N_BINS, 3), np.inf)
    bhi = np.full((N_BINS, 3), -np.inf)
    np.minimum.at(blo, bin_ids, lo_t)
    np.maximum.at(bhi, bin_ids, hi_t)
    # Prefix/suffix sweep for SAH.
    lcnt = np.cumsum(counts)[:-1]
    rcnt = n - lcnt
    llo = np.minimum.accumulate(blo, 0)[:-1]
    lhi = np.maximum.accumulate(bhi, 0)[:-1]
    rlo = np.minimum.accumulate(blo[::-1], 0)[::-1][1:]
    rhi = np.maximum.accumulate(bhi[::-1], 0)[::-1][1:]

    def area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

    cost = area(llo, lhi) * lcnt + area(rlo, rhi) * rcnt
    cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
    best = int(np.argmin(cost))
    mask = bin_ids <= best
    if not mask.any() or mask.all():
        # Shouldn't happen given the inf guard, but fall back to median.
        order = np.argsort(c[:, axis], kind="stable")
        half = n // 2
        return axis, ids[order[:half]], ids[order[half:]]
    return axis, ids[mask], ids[~mask]


def build_bvh(tri_pos: np.ndarray, max_leaf: int = MAX_LEAF) -> FlatBVH:
    """Build a flat skip-link BVH from world-space triangles [T, 3, 3]."""
    t = tri_pos.shape[0]
    if t == 0:
        return FlatBVH(
            np.zeros((1, 3), np.float32),
            np.zeros((1, 3), np.float32),
            np.zeros(1, np.int32),
            np.zeros(1, np.int32),
            np.ones(1, np.int32),
            np.full(1, -1, np.int32),
            np.zeros(0, np.int32),
        )
    tlo = tri_pos.min(axis=1).astype(np.float64)
    thi = tri_pos.max(axis=1).astype(np.float64)
    cent = 0.5 * (tlo + thi)

    node_lo, node_hi, node_first, node_count, node_right = [], [], [], [], []
    tri_order: list[np.ndarray] = []
    # Iterative DFS; parent fix-ups recorded as (node_idx, 'right').
    # Each stack entry: (ids, parent_idx_to_patch_or_None)
    stack: list[tuple[np.ndarray, int | None]] = [(np.arange(t, dtype=np.int64), None)]
    n_emitted_tris = 0

    while stack:
        ids, patch = stack.pop()
        ni = len(node_lo)
        if patch is not None:
            node_right[patch] = ni
        lo = tlo[ids].min(0)
        hi = thi[ids].max(0)
        node_lo.append(lo)
        node_hi.append(hi)
        split = _sah_split(ids, cent, tlo, thi) if ids.shape[0] > max_leaf else None
        if split is None and ids.shape[0] > 4 * max_leaf:
            # Degenerate centroid cluster but too many tris for one leaf:
            # force a median split on the largest AABB axis.
            axis = int(np.argmax(hi - lo))
            order = np.argsort(cent[ids][:, axis], kind="stable")
            half = ids.shape[0] // 2
            split = axis, ids[order[:half]], ids[order[half:]]
        if split is None:
            node_first.append(n_emitted_tris)
            node_count.append(ids.shape[0])
            node_right.append(-1)
            tri_order.append(ids)
            n_emitted_tris += ids.shape[0]
        else:
            _, left_ids, right_ids = split
            node_first.append(ni + 1)  # left child follows in pre-order
            node_count.append(0)
            node_right.append(-2)  # patched when right child is emitted
            # DFS order: push right first so left pops first (pre-order).
            stack.append((right_ids, ni))
            stack.append((left_ids, None))

    n = len(node_lo)
    node_lo = np.asarray(node_lo, np.float32)
    node_hi = np.asarray(node_hi, np.float32)
    node_first = np.asarray(node_first, np.int32)
    node_count = np.asarray(node_count, np.int32)
    node_right = np.asarray(node_right, np.int32)
    tri_index = np.concatenate(tri_order).astype(np.int32)

    # Skip links: left child's skip is its right sibling; right child (and the
    # root) inherit the parent's skip. O(n) stack walk using node_right.
    node_skip = np.full(n, n, np.int32)

    def assign(i: int, skip: int):
        stack2 = [(i, skip)]
        while stack2:
            j, s = stack2.pop()
            node_skip[j] = s
            if node_count[j] == 0:
                left, right = node_first[j], node_right[j]
                stack2.append((left, right))
                stack2.append((right, s))

    assign(0, n)
    return FlatBVH(node_lo, node_hi, node_first, node_count, node_skip, node_right, tri_index)


def validate_bvh(bvh: FlatBVH, tri_pos: np.ndarray) -> None:
    """Check a tree against its triangles: tri_index is a permutation,
    each leaf's box holds its triangles, each inner node's left child
    follows it in pre-order, its box holds its children's, and the skip
    links chain as the walks expect, within 1e-4.  Raises AssertionError
    on the first broken rule."""
    tol = 1e-4
    tri_pos = np.asarray(tri_pos, np.float32)
    t = tri_pos.shape[0]
    lo, hi = np.asarray(bvh.node_lo), np.asarray(bvh.node_hi)
    first, count = np.asarray(bvh.node_first), np.asarray(bvh.node_count)
    right, skip = np.asarray(bvh.node_right), np.asarray(bvh.node_skip)
    if not np.array_equal(np.sort(bvh.tri_index), np.arange(t)):
        raise AssertionError("tri permutation broken")
    tlo, thi = tri_pos.min(axis=1), tri_pos.max(axis=1)
    leaf = np.nonzero(count > 0)[0]
    per_leaf = count[leaf]
    owner = np.repeat(leaf, per_leaf)
    slot = np.repeat(first[leaf], per_leaf) + np.arange(per_leaf.sum()) - np.repeat(np.cumsum(per_leaf) - per_leaf,
                                                                                      per_leaf)
    tids = np.asarray(bvh.tri_index)[slot]
    if not ((tlo[tids] >= lo[owner] - tol).all() and (thi[tids] <= hi[owner] + tol).all()):
        raise AssertionError("a leaf's box does not hold its triangles")
    inner = np.nonzero(count == 0)[0]
    if t == 0:
        return
    left, rgt = first[inner], right[inner]
    if not (left == inner + 1).all():
        raise AssertionError("left child must follow parent in pre-order")
    if not ((lo[inner] <= lo[left] + tol).all() and (hi[inner] >= hi[rgt] - tol).all()):
        raise AssertionError("an inner box does not hold its children's")
    if not ((skip[left] == rgt).all() and (skip[rgt] == skip[inner]).all()):
        raise AssertionError("skip links broken")
