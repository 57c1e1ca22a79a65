"""Traversal tables and kernels K1-K3, K6a, K6b, K7 and K8, with their
plain PyTorch versions.

Replaces `nebulae_tpu/kernels/pallas_trace.py` (pack_bvh_fat4, pack_bvh_fat,
pack_bvh_for_pallas, _grouped_tris, grouped_tri_ids, the fat4 closest /
combo / any kernels with their slot_range and paged builds, the fat2
closest / combo / any kernels, and the one-node closest / any kernels).
The tables hold the same values as the JAX packers, in a row-major layout
one GPU thread can load:

  fat4nodes [n_nodes, 32] f32: slot k box at [6k, 6k+6) (lo.xyz, hi.xyz);
      [24 + k] the slot's enc as int32 bits: leaf -> first_slot*32 + count
      (1..15), inner -> fat4_id*32 + 16, empty -> 0; [28] the order meta
      om_self*36 + om_left*6 + om_right as int32 bits; [29:32] zero.
  fatnodes [n_inner, 16] f32 (fat2, K7): the left child's box at [0, 6),
      the right child's at [6, 12); [12], [13] the children's enc as int32
      bits (leaf -> first_slot*32 + count, inner -> inner_id*32 + 16);
      [14] the order meta axis*2 + left_is_lower as int32 bits; [15] zero.
  nodes [n_nodes, 8] f32 (one-node layout, K8): lo.xyz, hi.xyz, enc as
      int32 bits (leaf -> first_slot*32 + count, inner -> right*32 + 16 +
      axis*2 + left_is_lower; the left child is the next row), zero.
  tris [n_slots, G, 10] f32: v0, e1, e2 and the original triangle id as
      int32 bits; short leaves repeat their last triangle.

Each wrapper launches its CUDA kernel (csrc/trace.cu) for CUDA tensors,
adds one to its own `launches` count, and runs the plain version for CPU
tensors; it raises on anything else.  K6a (`*_paged`) launches K1-K3 over
the one table in device memory and counts apart; K6b (`*_slots`) is K1-K3
with a leaf slot gate; K7 (`*_fat`) walks the fat2 tables.  The plain versions walk the same tree in the same
per-ray order with the same float32 arithmetic (one rounding per multiply
and add), so on one device kernel and plain version agree bit for bit in
tri and occ.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nebulae_tpu_torch.kernels.build import check, native

TRI_STRIDE = 10
NODE_STRIDE = 32
FAT_STRIDE = 16
ONE_NODE_STRIDE = 8
META_SHIFT = 5
MAX_LEAF_FIELD = 15
INNER_FIELD = 16
EPS = 1e-7
DEAD_RAY_ORIGIN = 1.0e13
STACK_MAX = 128  # csrc/trace.cu kStackMax


# ---------------------------------------------------------------------------
# Host-side packing
# ---------------------------------------------------------------------------


def _slot_layout(bvh, G: int):
    """Leaves in node order, each holding ceil(count / G) consecutive slots
    of G triangles: (leaf nodes, their counts, slot counts, first slots)."""
    counts = np.asarray(bvh.node_count, np.int64)
    leaf_nodes = np.nonzero(counts > 0)[0]
    c = counts[leaf_nodes]
    sc = (c + G - 1) // G
    sf = np.zeros_like(sc)
    if sc.size:
        sf[1:] = np.cumsum(sc)[:-1]
    return leaf_nodes, c, sc, sf


def grouped_tris(bvh, tri_pos: np.ndarray, tri_group: int):
    """Each leaf's triangle range in ceil(c/G) slots of G triangles.

    Returns (tris [n_slots, G, 10] f32, slot_first [n], slot_count [n]) with
    slot_first/slot_count per node (0 for inner nodes)."""
    G = int(tri_group)
    n = bvh.node_lo.shape[0]
    leaf_nodes, _, sc, sf = _slot_layout(bvh, G)
    slot_first = np.zeros(n, np.int64)
    slot_count = np.zeros(n, np.int64)
    slot_first[leaf_nodes] = sf
    slot_count[leaf_nodes] = sc
    if slot_count.max(initial=0) > MAX_LEAF_FIELD:
        raise ValueError("leaf slots exceed the 15-slot encoding: raise bvh_tri_group or lower max_leaf")
    ids = grouped_tri_ids(bvh, G)
    tris = np.zeros(ids.shape + (TRI_STRIDE,), np.float32)
    if sc.sum():
        tp = tri_pos[ids]
        tris[..., 0:3] = tp[..., 0, :]
        tris[..., 3:6] = tp[..., 1, :] - tp[..., 0, :]
        tris[..., 6:9] = tp[..., 2, :] - tp[..., 0, :]
        tris[..., 9] = ids.astype(np.int32).view(np.float32)
    return tris, slot_first, slot_count


def grouped_tri_ids(bvh, tri_group: int) -> np.ndarray:
    """The slot -> triangle map of grouped_tris' table: [n_slots, G] original
    triangle ids (int64; a leaf's last slot repeats its last triangle; -1
    marks the empty row of a scene without triangles).  The topology part of
    the table, which a refit keeps while it rewrites the vertices
    (bvh/refit.py::repack_tris)."""
    G = int(tri_group)
    leaf_nodes, c, sc, sf = _slot_layout(bvh, G)
    ns = int(sc.sum())
    ids = np.full((max(ns, 1), G), -1, np.int64)
    if ns:
        tri_index = np.asarray(bvh.tri_index, np.int64)
        leaf_of_slot = np.repeat(np.arange(leaf_nodes.shape[0]), sc)
        slot_in_leaf = np.arange(ns) - sf[leaf_of_slot]
        base = np.asarray(bvh.node_first, np.int64)[leaf_nodes]
        for g in range(G):
            off = np.minimum(slot_in_leaf * G + g, c[leaf_of_slot] - 1)
            ids[:ns, g] = tri_index[base[leaf_of_slot] + off]
    return ids


def _tree_stack_depth(bvh) -> int:
    """Tree levels + 1: the deepest stack a walk that pushes at most both
    children of each visited node can need."""
    is_leaf = np.asarray(bvh.node_count) > 0
    node_right = np.asarray(bvh.node_right, np.int64)
    n = is_leaf.shape[0]
    level = np.ones(n, np.int64)
    for i in range(n):  # children follow their parent in pre-order
        if not is_leaf[i]:
            level[i + 1] = level[node_right[i]] = level[i] + 1
    stack_depth = int(level.max(initial=0)) + 1
    if stack_depth > STACK_MAX:
        raise ValueError(f"BVH needs a {stack_depth}-entry stack; the kernels hold {STACK_MAX}")
    return stack_depth


def pack_bvh_fat4(bvh, tri_pos: np.ndarray, tri_group: int = 8) -> dict | None:
    """FlatBVH + world triangles -> fat4 tables (numpy), or None when the
    root is a leaf (that tree takes the one-node tables of pack_bvh_nodes
    and kernel K8).

    Fat4 node i expands BVH2 inner node i into its grandchildren: slots 0, 1
    are the children of i's left child (or [left child, empty] when it is a
    leaf), slots 2, 3 likewise for the right child.  Rows are numbered in
    breadth-first order from the root.  Also returns `stack_depth`, the
    deepest traversal stack the tree can need (3 per fat4 level + 1), and
    `fat4_slots` [n_nodes, 4] int32, the BVH node in each slot (-1 empty),
    which a refit rewrites the boxes from (bvh/refit.py)."""
    n = int(bvh.node_lo.shape[0])
    is_leaf = np.asarray(bvh.node_count) > 0
    if n == 0 or is_leaf[0]:
        return None
    tris, slot_first, slot_count = grouped_tris(bvh, tri_pos, tri_group)
    node_lo = np.asarray(bvh.node_lo, np.float32)
    node_hi = np.asarray(bvh.node_hi, np.float32)
    node_right = np.asarray(bvh.node_right)

    def order_meta(a, b):
        ca = (node_lo[a] + node_hi[a]) * 0.5
        cb = (node_lo[b] + node_hi[b]) * 0.5
        axis = int(np.argmax(np.abs(cb - ca)))
        return axis * 2 + int(ca[axis] <= cb[axis])

    def pair_of(c):
        if is_leaf[c]:
            return [c, -1], 0
        gl, gr = c + 1, int(node_right[c])
        return [gl, gr], order_meta(gl, gr)

    fat_id = {0: 0}
    order = [0]
    level = [1]
    slots_all, oms = [], []
    qi = 0
    while qi < len(order):
        i = order[qi]
        l, r = i + 1, int(node_right[i])
        pl_, om_l = pair_of(l)
        pr_, om_r = pair_of(r)
        slots = pl_ + pr_
        for s in slots:
            if s >= 0 and not is_leaf[s] and s not in fat_id:
                fat_id[s] = len(order)
                order.append(s)
                level.append(level[qi] + 1)
        slots_all.append(slots)
        oms.append((order_meta(l, r), om_l, om_r))
        qi += 1

    ni = len(order)
    nodes = np.zeros((ni, NODE_STRIDE), np.float32)
    enc = np.zeros((ni, 5), np.int32)
    for row, (slots, (om_s, om_l, om_r)) in enumerate(zip(slots_all, oms)):
        for k, s in enumerate(slots):
            if s < 0:
                continue
            nodes[row, 6 * k: 6 * k + 3] = node_lo[s]
            nodes[row, 6 * k + 3: 6 * k + 6] = node_hi[s]
            if is_leaf[s]:
                enc[row, k] = int(slot_first[s]) * (1 << META_SHIFT) + int(slot_count[s])
            else:
                enc[row, k] = fat_id[s] * (1 << META_SHIFT) + INNER_FIELD
        enc[row, 4] = om_s * 36 + om_l * 6 + om_r
    nodes[:, 24:29] = enc.view(np.float32)
    stack_depth = 3 * max(level) + 1
    if stack_depth > STACK_MAX:
        raise ValueError(f"fat4 tree needs a {stack_depth}-entry stack; the kernels hold {STACK_MAX}")
    return {"fat4nodes": nodes, "tris": tris, "stack_depth": stack_depth,
            "fat4_slots": np.asarray(slots_all, np.int32).reshape(ni, 4)}


def pack_bvh_fat(bvh, tri_pos: np.ndarray, tri_group: int = 8) -> dict | None:
    """FlatBVH + world triangles -> fat2 tables (numpy) for K7, the
    counterpart of pack_bvh_fat: one row per inner node, in pre-order,
    holding both children's boxes, or None when the root is a leaf.  Also
    returns `stack_depth` (tree levels + 1) and `inner_idx`, the BVH node
    of each row, which a refit rewrites the boxes from."""
    n = int(bvh.node_lo.shape[0])
    is_leaf = np.asarray(bvh.node_count) > 0
    if n == 0 or is_leaf[0]:
        return None
    tris, slot_first, slot_count = grouped_tris(bvh, tri_pos, tri_group)
    node_lo = np.asarray(bvh.node_lo, np.float32)
    node_hi = np.asarray(bvh.node_hi, np.float32)
    inner_idx = np.nonzero(~is_leaf)[0]
    ni = inner_idx.shape[0]
    inner_id = np.full(n, -1, np.int64)
    inner_id[inner_idx] = np.arange(ni)
    enc = np.where(is_leaf, slot_first * (1 << META_SHIFT) + slot_count,
                   inner_id * (1 << META_SHIFT) + INNER_FIELD)
    left = inner_idx + 1
    right = np.asarray(bvh.node_right, np.int64)[inner_idx]
    # Split axis and side from the children's box centres, as JAX derives them.
    c_l = (node_lo[left] + node_hi[left]) * 0.5
    c_r = (node_lo[right] + node_hi[right]) * 0.5
    axis = np.argmax(np.abs(c_r - c_l), axis=-1)
    lower = (c_l[np.arange(ni), axis] <= c_r[np.arange(ni), axis]).astype(np.int64)
    nodes = np.zeros((ni, FAT_STRIDE), np.float32)
    nodes[:, 0:3] = node_lo[left]
    nodes[:, 3:6] = node_hi[left]
    nodes[:, 6:9] = node_lo[right]
    nodes[:, 9:12] = node_hi[right]
    meta = np.stack([enc[left], enc[right], axis * 2 + lower], axis=1).astype(np.int32)
    nodes[:, 12:15] = meta.view(np.float32)
    return {"fatnodes": nodes, "tris": tris, "stack_depth": _tree_stack_depth(bvh),
            "inner_idx": inner_idx}


def pack_bvh_nodes(bvh, tri_pos: np.ndarray, tri_group: int = 8) -> dict:
    """FlatBVH + world triangles -> one-node tables (numpy) for K8, the
    counterpart of pack_bvh_for_pallas: the same rows and enc values,
    row-major.  Also returns `stack_depth`, the deepest stack a walk can
    need (tree levels + 1)."""
    n = int(bvh.node_lo.shape[0])
    tris, slot_first, slot_count = grouped_tris(bvh, tri_pos, tri_group)
    node_lo = np.asarray(bvh.node_lo, np.float32)
    node_hi = np.asarray(bvh.node_hi, np.float32)
    node_right = np.asarray(bvh.node_right, np.int64)
    is_leaf = np.asarray(bvh.node_count) > 0
    first_or_right = np.where(is_leaf, slot_first, node_right)
    # Split axis and side from the children's box centres, as JAX derives them.
    left = np.minimum(np.arange(n) + 1, max(n - 1, 0))
    right = np.clip(node_right, 0, max(n - 1, 0))
    c_l = (node_lo[left] + node_hi[left]) * 0.5
    c_r = (node_lo[right] + node_hi[right]) * 0.5
    axis = np.argmax(np.abs(c_r - c_l), axis=-1)
    lower = (c_l[np.arange(n), axis] <= c_r[np.arange(n), axis]).astype(np.int64)
    field = np.where(is_leaf, slot_count, INNER_FIELD + axis * 2 + lower)
    enc = (first_or_right * (1 << META_SHIFT) + field).astype(np.int32)
    nodes = np.zeros((n, ONE_NODE_STRIDE), np.float32)
    nodes[:, 0:3] = node_lo
    nodes[:, 3:6] = node_hi
    nodes[:, 6] = enc.view(np.float32)
    return {"nodes": nodes, "tris": tris, "stack_depth": _tree_stack_depth(bvh)}


def empty_tables() -> dict:
    """Tables of a scene without triangles: every trace misses."""
    return {
        "fat4nodes": np.zeros((0, NODE_STRIDE), np.float32),
        "tris": np.zeros((1, 1, TRI_STRIDE), np.float32),
        "stack_depth": 1,
        "paged": False,
    }


def tables_to(packed: dict, device) -> dict:
    """Move packed numpy tables (any route: one table, "chunks" of subtree
    tables, or "tri_chunks" slot ranges over one triangle table) onto a
    device.  A tri chunk becomes a dict of the whole-tree nodes and the
    view tris[lo:hi] of the triangle table, with its slot range."""
    out = {}
    for k, v in packed.items():
        if k in ("fat4nodes", "fatnodes", "nodes", "tris"):
            out[k] = torch.as_tensor(v).to(device).contiguous()
        elif k == "chunks":
            out[k] = [tables_to(c, device) for c in v]
        elif k != "tri_chunks":
            out[k] = v
    if "tri_chunks" in packed:
        tris = out.pop("tris")
        out["tri_chunks"] = [
            {"fat4nodes": out["fat4nodes"], "tris": tris[lo:hi], "stack_depth": out["stack_depth"],
             "slot_lo": int(lo), "slot_hi": int(hi)}
            for lo, hi in packed["tri_chunks"]
        ]
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch traversal (the reference for the kernels; the CPU path)
# ---------------------------------------------------------------------------


class _Rays:
    """Per-ray constants of the slab test (subset-indexable)."""

    def __init__(self, o, d):
        self.o = o
        self.d = d
        sign = torch.where(d >= 0.0, 1.0, -1.0)
        self.inv = sign / torch.clamp(torch.abs(d), min=1e-12)
        self.oi = o * self.inv
        self.pos = d >= 0.0


def _dead(o, d):
    return (torch.abs(o[:, 0]) >= DEAD_RAY_ORIGIN) | (
        (torch.abs(d[:, 0]) + torch.abs(d[:, 1])) + torch.abs(d[:, 2]) < 1e-6
    )


def _slab4(rows, inv, oi, cap):
    """Slab test of the 4 slot boxes of node rows [M, 32] -> [M, 4] bool."""
    return _slab(rows[:, :24].reshape(-1, 4, 6), inv, oi, cap)


def _slab(box, inv, oi, cap):
    """Slab test of boxes [M, K, 6] (lo.xyz, hi.xyz) -> [M, K] bool."""
    ix, iy, iz = inv[:, 0:1], inv[:, 1:2], inv[:, 2:3]
    oix, oiy, oiz = oi[:, 0:1], oi[:, 1:2], oi[:, 2:3]
    t0x = box[..., 0] * ix - oix
    t1x = box[..., 3] * ix - oix
    t0y = box[..., 1] * iy - oiy
    t1y = box[..., 4] * iy - oiy
    t0z = box[..., 2] * iz - oiz
    t1z = box[..., 5] * iz - oiz
    tenter = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)), torch.minimum(t0z, t1z)
    )
    texit = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)), torch.maximum(t0z, t1z)
    )
    return (tenter <= texit) & (texit > EPS) & (tenter < cap[:, None])


def _moller(tv, o, d):
    """Moller-Trumbore of rays [M] against slot triangles tv [M, G, 10];
    returns (valid [M, G] without the t cap, t, u, v)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z = tv[..., 0], tv[..., 1], tv[..., 2]
    e1x, e1y, e1z = tv[..., 3], tv[..., 4], tv[..., 5]
    e2x, e2y, e2z = tv[..., 6], tv[..., 7], tv[..., 8]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = torch.where(torch.abs(det) < EPS, 0.0, 1.0 / torch.where(det == 0.0, 1.0, det))
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = (torch.abs(det) >= EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
    return valid, t, u, v


def _decode(rows):
    enc = rows[:, 24:29].contiguous().view(torch.int32).long()
    field = enc[:, :4] & 31
    meta = enc[:, :4] >> META_SHIFT
    om = enc[:, 4]
    return field, meta, om // 36, (om % 36) // 6, om % 6


def _near_first(om, pos):
    return torch.gather(pos, 1, (om >> 1)[:, None])[:, 0] == ((om & 1) == 1)


def _push_order(meta_k, om_s, om_l, om_r, pos):
    """Slot indices [M, 4] in push order (last pushed = popped first)."""
    ns = _near_first(om_s, pos)
    nl = _near_first(om_l, pos)
    nr = _near_first(om_r, pos)
    ln, lf = torch.where(nl, 0, 1), torch.where(nl, 1, 0)
    rn, rf = torch.where(nr, 2, 3), torch.where(nr, 3, 2)
    return torch.stack(
        [torch.where(ns, rf, lf), torch.where(ns, rn, ln), torch.where(ns, lf, rf), torch.where(ns, ln, rn)],
        dim=1,
    )


class _Walk:
    """Per-ray stacks for the lockstep plain traversal."""

    def __init__(self, n, depth, start, device):
        self.stack = torch.zeros((n, max(depth, 1)), dtype=torch.long, device=device)
        self.sp = start.long()

    def active(self):
        return torch.nonzero(self.sp > 0)[:, 0]

    def pop(self, ids):
        self.sp[ids] -= 1
        return self.stack[ids, self.sp[ids]]

    def push(self, ids, node_ids, ok):
        if bool(ok.any()):
            sel = ids[ok]
            self.stack[sel, self.sp[sel]] = node_ids[ok]
            self.sp[sel] += 1


def _leaf_slots(field_k, meta_k, hit_k, slot_range=None):
    """Yield (local index, table row) per slot iteration s of leaves hit.
    With slot_range=(lo, hi) only leaves whose first slot lies in [lo, hi)
    are taken, at row first - lo (the K6b gate)."""
    leaf = hit_k & (field_k > 0) & (field_k <= MAX_LEAF_FIELD)
    first = meta_k
    if slot_range is not None:
        lo, hi = slot_range
        leaf = leaf & (meta_k >= lo) & (meta_k < hi)
        first = meta_k - lo
    loc = torch.nonzero(leaf)[:, 0]
    if loc.numel() == 0:
        return
    nsl = field_k[loc]
    for s in range(int(nsl.max())):
        sel = loc[nsl > s]
        yield sel, first[sel] + s


def _closest_step(tv, o, d, bt, btri, bu, bv, gate=None):
    """Sequential-in-G closest update of rays vs a slot (strict t < best)."""
    valid, t, u, v = _moller(tv, o, d)
    if gate is not None:
        valid = valid & gate[:, None]
    ids = tv[..., 9].contiguous().view(torch.int32)
    for g in range(tv.shape[1]):
        take = valid[:, g] & (t[:, g] < bt)
        bt = torch.where(take, t[:, g], bt)
        btri = torch.where(take, ids[:, g], btri)
        bu = torch.where(take, u[:, g], bu)
        bv = torch.where(take, v[:, g], bv)
    return bt, btri, bu, bv


def _miss_t(btri, bt):
    return torch.where(btri >= 0, bt, torch.full_like(bt, float("inf")))


def _as_cap(t_max, n, ref):
    return torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=ref.device), (n,)).clone()


def _count(work, visits=0, box_tests=0, tri_tests=0):
    """Accumulate the traversal work of a plain run (for a kernel's bound)."""
    if work is not None:
        work["visits"] = work.get("visits", 0) + visits
        work["box_tests"] = work.get("box_tests", 0) + box_tests
        work["tri_tests"] = work.get("tri_tests", 0) + tri_tests


def closest_hit_fat4_plain(o, d, tables: dict, t_max=float("inf"), work=None, slot_range=None):
    """Plain version of K1: dict(t, tri, u, v) per ray (t inf and tri -1 on a
    miss).  `work`, if a dict, receives the node visits, box tests and
    triangle tests this run needed.  With slot_range=(lo, hi), the plain
    version of K6b: only leaves whose first slot lies in [lo, hi) are
    intersected, and tables["tris"] holds those slots from row 0."""
    n = o.shape[0]
    nodes, tris = tables["fat4nodes"], tables["tris"]
    bt = _as_cap(t_max, n, o)
    btri = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    bu = torch.zeros(n, dtype=torch.float32, device=o.device)
    bv = torch.zeros_like(bu)
    live = ~_dead(o, d) & (bt > EPS) & (nodes.shape[0] > 0)
    walk = _Walk(n, tables["stack_depth"], live, o.device)
    rays = _Rays(o, d)
    while True:
        ids = walk.active()
        if ids.numel() == 0:
            break
        rows = nodes[walk.pop(ids)]
        box = _slab4(rows, rays.inv[ids], rays.oi[ids], bt[ids])
        _count(work, ids.numel(), 4 * ids.numel())
        field, meta, om_s, om_l, om_r = _decode(rows)
        for k in range(4):
            for sel, slot in _leaf_slots(field[:, k], meta[:, k], box[:, k], slot_range):
                r = ids[sel]
                _count(work, tri_tests=sel.numel() * tris.shape[1])
                bt[r], btri[r], bu[r], bv[r] = _closest_step(
                    tris[slot], o[r], d[r], bt[r], btri[r], bu[r], bv[r]
                )
        ok = box & (field >= INNER_FIELD)
        order = _push_order(meta, om_s, om_l, om_r, rays.pos[ids])
        for i in range(4):
            k = order[:, i:i + 1]
            walk.push(ids, torch.gather(meta, 1, k)[:, 0], torch.gather(ok, 1, k)[:, 0])
    return {"t": _miss_t(btri, bt), "tri": btri, "u": bu, "v": bv}


def any_hit_fat4_plain(o, d, tables: dict, t_max=float("inf"), work=None, slot_range=None):
    """Plain version of K3 (of K6b with slot_range): occluded [N] bool."""
    n = o.shape[0]
    nodes, tris = tables["fat4nodes"], tables["tris"]
    cap = _as_cap(t_max, n, o)
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    live = ~_dead(o, d) & (cap > EPS) & (nodes.shape[0] > 0)
    walk = _Walk(n, tables["stack_depth"], live, o.device)
    rays = _Rays(o, d)
    while True:
        ids = walk.active()
        if ids.numel() == 0:
            break
        rows = nodes[walk.pop(ids)]
        box = _slab4(rows, rays.inv[ids], rays.oi[ids], cap[ids])
        _count(work, ids.numel(), 4 * ids.numel())
        field, meta, _, _, _ = _decode(rows)
        for k in range(4):
            for sel, slot in _leaf_slots(field[:, k], meta[:, k], box[:, k], slot_range):
                r = ids[sel]
                _count(work, tri_tests=sel.numel() * tris.shape[1])
                valid, t, _, _ = _moller(tris[slot], o[r], d[r])
                occ[r] |= (valid & (t < cap[r][:, None])).any(dim=1)
        ok = box & (field >= INNER_FIELD) & ~occ[ids][:, None]
        for k in range(4):
            walk.push(ids, meta[:, k], ok[:, k])
        walk.sp[occ] = 0
    return occ


def shadow_closest_fat4_plain(o, b, l, tables: dict, t_max_b=float("inf"), t_max_l=float("inf"),
                              work=None, slot_range=None):
    """Plain version of K2 (of K6b with slot_range): (hit dict along b,
    occluded [N] along l)."""
    n = o.shape[0]
    nodes, tris = tables["fat4nodes"], tables["tris"]
    bt = _as_cap(t_max_b, n, o)
    cap_l = _as_cap(t_max_l, n, o)
    btri = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    bu = torch.zeros(n, dtype=torch.float32, device=o.device)
    bv = torch.zeros_like(bu)
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    has_nodes = nodes.shape[0] > 0
    live_b = ~_dead(o, b) & (bt > EPS) & has_nodes
    live_l = ~_dead(o, l) & (cap_l > EPS) & has_nodes
    walk = _Walk(n, tables["stack_depth"], live_b | live_l, o.device)
    rb, rl = _Rays(o, b), _Rays(o, l)
    while True:
        ids = walk.active()
        if ids.numel() == 0:
            break
        rows = nodes[walk.pop(ids)]
        gate_b, gate_l = live_b[ids], live_l[ids] & ~occ[ids]
        box_b = _slab4(rows, rb.inv[ids], rb.oi[ids], bt[ids]) & gate_b[:, None]
        box_l = _slab4(rows, rl.inv[ids], rl.oi[ids], cap_l[ids]) & gate_l[:, None]
        _count(work, ids.numel(), 4 * (int(gate_b.sum()) + int(gate_l.sum())))
        field, meta, om_s, om_l, om_r = _decode(rows)
        for k in range(4):
            tested = box_b[:, k] | box_l[:, k]
            for sel, slot in _leaf_slots(field[:, k], meta[:, k], tested, slot_range):
                r = ids[sel]
                gates = int(box_b[sel, k].sum()) + int(box_l[sel, k].sum())
                _count(work, tri_tests=gates * tris.shape[1])
                tv = tris[slot]
                bt[r], btri[r], bu[r], bv[r] = _closest_step(
                    tv, o[r], b[r], bt[r], btri[r], bu[r], bv[r], gate=box_b[sel, k]
                )
                valid, t, _, _ = _moller(tv, o[r], l[r])
                hit_l = (valid & (t < cap_l[r][:, None])).any(dim=1) & box_l[sel, k]
                occ[r] |= hit_l
        ok = (box_b | box_l) & (field >= INNER_FIELD)
        order = _push_order(meta, om_s, om_l, om_r, rb.pos[ids])
        for i in range(4):
            k = order[:, i:i + 1]
            walk.push(ids, torch.gather(meta, 1, k)[:, 0], torch.gather(ok, 1, k)[:, 0])
    return {"t": _miss_t(btri, bt), "tri": btri, "u": bu, "v": bv}, occ


def _decode_fat(rows):
    enc = rows[:, 12:15].contiguous().view(torch.int32).long()
    return enc[:, :2] & 31, enc[:, :2] >> META_SHIFT, enc[:, 2]


def _slab2(rows, inv, oi, cap):
    """Slab test of the 2 child boxes of fat2 rows [M, 16] -> [M, 2] bool."""
    return _slab(rows[:, :12].reshape(-1, 2, 6), inv, oi, cap)


def _push_far_near(walk, ids, meta, ok, om, pos):
    """Push the hit inner children far first, near on top (K7a/K7b order)."""
    near = torch.where(_near_first(om, pos), 0, 1)[:, None]
    for k in (1 - near, near):
        walk.push(ids, torch.gather(meta, 1, k)[:, 0], torch.gather(ok, 1, k)[:, 0])


def closest_hit_fat_plain(o, d, tables: dict, t_max=float("inf"), work=None):
    """Plain version of K7a over fat2 tables: dict(t, tri, u, v).  Both
    children are slab-tested against the cap the visit starts with; the left
    leaf child's triangles are intersected, then the right one's, each test
    under the running best t."""
    n = o.shape[0]
    nodes, tris = tables["fatnodes"], tables["tris"]
    bt = _as_cap(t_max, n, o)
    btri = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    bu = torch.zeros(n, dtype=torch.float32, device=o.device)
    bv = torch.zeros_like(bu)
    live = ~_dead(o, d) & (bt > EPS) & (nodes.shape[0] > 0)
    walk = _Walk(n, tables["stack_depth"], live, o.device)
    rays = _Rays(o, d)
    while True:
        ids = walk.active()
        if ids.numel() == 0:
            break
        rows = nodes[walk.pop(ids)]
        box = _slab2(rows, rays.inv[ids], rays.oi[ids], bt[ids])
        _count(work, ids.numel(), 2 * ids.numel())
        field, meta, om = _decode_fat(rows)
        for k in range(2):
            for sel, slot in _leaf_slots(field[:, k], meta[:, k], box[:, k]):
                r = ids[sel]
                _count(work, tri_tests=sel.numel() * tris.shape[1])
                bt[r], btri[r], bu[r], bv[r] = _closest_step(
                    tris[slot], o[r], d[r], bt[r], btri[r], bu[r], bv[r]
                )
        _push_far_near(walk, ids, meta, box & (field >= INNER_FIELD), om, rays.pos[ids])
    return {"t": _miss_t(btri, bt), "tri": btri, "u": bu, "v": bv}


def any_hit_fat_plain(o, d, tables: dict, t_max=float("inf"), work=None):
    """Plain version of K7c: occluded [N] bool.  Hit inner children are
    pushed left, then right (right on top), as JAX's any-hit walk does."""
    n = o.shape[0]
    nodes, tris = tables["fatnodes"], tables["tris"]
    cap = _as_cap(t_max, n, o)
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    live = ~_dead(o, d) & (cap > EPS) & (nodes.shape[0] > 0)
    walk = _Walk(n, tables["stack_depth"], live, o.device)
    rays = _Rays(o, d)
    while True:
        ids = walk.active()
        if ids.numel() == 0:
            break
        rows = nodes[walk.pop(ids)]
        box = _slab2(rows, rays.inv[ids], rays.oi[ids], cap[ids])
        _count(work, ids.numel(), 2 * ids.numel())
        field, meta, _ = _decode_fat(rows)
        for k in range(2):
            for sel, slot in _leaf_slots(field[:, k], meta[:, k], box[:, k]):
                r = ids[sel]
                _count(work, tri_tests=sel.numel() * tris.shape[1])
                valid, t, _, _ = _moller(tris[slot], o[r], d[r])
                occ[r] |= (valid & (t < cap[r][:, None])).any(dim=1)
        ok = box & (field >= INNER_FIELD) & ~occ[ids][:, None]
        for k in range(2):
            walk.push(ids, meta[:, k], ok[:, k])
        walk.sp[occ] = 0
    return occ


def shadow_closest_fat_plain(o, b, l, tables: dict, t_max_b=float("inf"), t_max_l=float("inf"),
                             work=None):
    """Plain version of K7b: (hit dict along b, occluded [N] along l).  A
    child is entered when either ray's box is hit; near order follows b."""
    n = o.shape[0]
    nodes, tris = tables["fatnodes"], tables["tris"]
    bt = _as_cap(t_max_b, n, o)
    cap_l = _as_cap(t_max_l, n, o)
    btri = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    bu = torch.zeros(n, dtype=torch.float32, device=o.device)
    bv = torch.zeros_like(bu)
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    has_nodes = nodes.shape[0] > 0
    live_b = ~_dead(o, b) & (bt > EPS) & has_nodes
    live_l = ~_dead(o, l) & (cap_l > EPS) & has_nodes
    walk = _Walk(n, tables["stack_depth"], live_b | live_l, o.device)
    rb, rl = _Rays(o, b), _Rays(o, l)
    while True:
        ids = walk.active()
        if ids.numel() == 0:
            break
        rows = nodes[walk.pop(ids)]
        gate_b, gate_l = live_b[ids], live_l[ids] & ~occ[ids]
        box_b = _slab2(rows, rb.inv[ids], rb.oi[ids], bt[ids]) & gate_b[:, None]
        box_l = _slab2(rows, rl.inv[ids], rl.oi[ids], cap_l[ids]) & gate_l[:, None]
        _count(work, ids.numel(), 2 * (int(gate_b.sum()) + int(gate_l.sum())))
        field, meta, om = _decode_fat(rows)
        for k in range(2):
            tested = box_b[:, k] | box_l[:, k]
            for sel, slot in _leaf_slots(field[:, k], meta[:, k], tested):
                r = ids[sel]
                gates = int(box_b[sel, k].sum()) + int(box_l[sel, k].sum())
                _count(work, tri_tests=gates * tris.shape[1])
                tv = tris[slot]
                bt[r], btri[r], bu[r], bv[r] = _closest_step(
                    tv, o[r], b[r], bt[r], btri[r], bu[r], bv[r], gate=box_b[sel, k]
                )
                valid, t, _, _ = _moller(tv, o[r], l[r])
                occ[r] |= (valid & (t < cap_l[r][:, None])).any(dim=1) & box_l[sel, k]
        _push_far_near(walk, ids, meta, (box_b | box_l) & (field >= INNER_FIELD), om, rb.pos[ids])
    return {"t": _miss_t(btri, bt), "tri": btri, "u": bu, "v": bv}, occ


def _decode_node(rows):
    enc = rows[:, 6].contiguous().view(torch.int32).long()
    return enc & 31, enc >> META_SHIFT


def closest_hit_node_plain(o, d, tables: dict, t_max=float("inf"), work=None):
    """Plain version of K8 closest over one-node tables: dict(t, tri, u, v).
    The near child (by the ray's own sign on the split axis) is walked
    first."""
    n = o.shape[0]
    nodes, tris = tables["nodes"], tables["tris"]
    bt = _as_cap(t_max, n, o)
    btri = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    bu = torch.zeros(n, dtype=torch.float32, device=o.device)
    bv = torch.zeros_like(bu)
    live = ~_dead(o, d) & (bt > EPS) & (nodes.shape[0] > 0)
    walk = _Walk(n, tables["stack_depth"], live, o.device)
    rays = _Rays(o, d)
    while True:
        ids = walk.active()
        if ids.numel() == 0:
            break
        node = walk.pop(ids)
        rows = nodes[node]
        box = _slab(rows[:, None, :6], rays.inv[ids], rays.oi[ids], bt[ids])[:, 0]
        _count(work, ids.numel(), ids.numel())
        field, meta = _decode_node(rows)
        for sel, slot in _leaf_slots(field, meta, box):
            r = ids[sel]
            _count(work, tri_tests=sel.numel() * tris.shape[1])
            bt[r], btri[r], bu[r], bv[r] = _closest_step(tris[slot], o[r], d[r], bt[r], btri[r], bu[r], bv[r])
        inner = box & (field >= INNER_FIELD)
        code = torch.clamp(field - INNER_FIELD, min=0)
        near_left = torch.gather(rays.pos[ids], 1, (code >> 1)[:, None])[:, 0] == ((code & 1) == 1)
        left = node + 1
        walk.push(ids, torch.where(near_left, meta, left), inner)
        walk.push(ids, torch.where(near_left, left, meta), inner)
    return {"t": _miss_t(btri, bt), "tri": btri, "u": bu, "v": bv}


def any_hit_node_plain(o, d, tables: dict, t_max=float("inf"), work=None):
    """Plain version of K8 any hit over one-node tables: occluded [N]."""
    n = o.shape[0]
    nodes, tris = tables["nodes"], tables["tris"]
    cap = _as_cap(t_max, n, o)
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    live = ~_dead(o, d) & (cap > EPS) & (nodes.shape[0] > 0)
    walk = _Walk(n, tables["stack_depth"], live, o.device)
    rays = _Rays(o, d)
    while True:
        ids = walk.active()
        if ids.numel() == 0:
            break
        node = walk.pop(ids)
        rows = nodes[node]
        box = _slab(rows[:, None, :6], rays.inv[ids], rays.oi[ids], cap[ids])[:, 0]
        _count(work, ids.numel(), ids.numel())
        field, meta = _decode_node(rows)
        for sel, slot in _leaf_slots(field, meta, box):
            r = ids[sel]
            _count(work, tri_tests=sel.numel() * tris.shape[1])
            valid, t, _, _ = _moller(tris[slot], o[r], d[r])
            occ[r] |= (valid & (t < cap[r][:, None])).any(dim=1)
        inner = box & (field >= INNER_FIELD) & ~occ[ids]
        walk.push(ids, meta, inner)
        walk.push(ids, node + 1, inner)
        walk.sp[occ] = 0
    return occ


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_rays(*arrs):
    n = arrs[0].shape[0]
    dev = arrs[0].device
    for a in arrs:
        if a.dtype != torch.float32 or a.dim() != 2 or a.shape != (n, 3) or a.device != dev:
            raise ValueError("rays must be float32 [N, 3] tensors on one device")
    return n, dev


def _check_tables(tables, dev, nodes_key="fat4nodes"):
    for k in (nodes_key, "tris"):
        t = tables[k]
        if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"table {k} must be a contiguous float32 tensor on {dev}")
    stride = {"fat4nodes": NODE_STRIDE, "fatnodes": FAT_STRIDE, "nodes": ONE_NODE_STRIDE}[nodes_key]
    if tables[nodes_key].dim() != 2 or tables[nodes_key].shape[1] != stride:
        raise ValueError(f"{nodes_key} must be [n_nodes, {stride}]")
    if tables["tris"].dim() != 3 or tables["tris"].shape[2] != TRI_STRIDE:
        raise ValueError("tris must be [n_slots, G, 10]")
    if not 1 <= tables["stack_depth"] <= STACK_MAX:
        raise ValueError(f"traversal stack depth {tables['stack_depth']} outside the kernels' 1..{STACK_MAX}")


def _check_wide_loads(tables, nodes_key="fat4nodes"):
    """K1-K3 (and their paged and slot-gated builds), K7a-K7c and K8 read a
    node row as 16-byte loads and a triangle as 8-byte loads: a table whose
    start is not so aligned (a view at an odd offset) is refused rather than
    read misaligned."""
    if tables[nodes_key].data_ptr() % 16 or tables["tris"].data_ptr() % 8:
        raise ValueError(f"{nodes_key} must be 16-byte and tris 8-byte aligned for the walks' wide loads")


def _cap_arg(t_max, n, dev):
    """(tensor, stride) for a scalar or per-ray [N] cap."""
    t = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    if t.dim() == 0:
        return t.reshape(1).contiguous(), 0
    if t.shape != (n,):
        raise ValueError("t_max must be a scalar or [N]")
    return t.contiguous(), 1


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _use_kernel(dev) -> bool:
    """CPU tensors take the plain version, CUDA tensors the kernel."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def _misses(n, dev):
    return {
        "t": torch.full((n,), float("inf"), dtype=torch.float32, device=dev),
        "tri": torch.full((n,), -1, dtype=torch.int32, device=dev),
        "u": torch.zeros(n, dtype=torch.float32, device=dev),
        "v": torch.zeros(n, dtype=torch.float32, device=dev),
    }


def _hit_out(n, dev):
    return {
        "t": torch.empty(n, dtype=torch.float32, device=dev),
        "tri": torch.empty(n, dtype=torch.int32, device=dev),
        "u": torch.empty(n, dtype=torch.float32, device=dev),
        "v": torch.empty(n, dtype=torch.float32, device=dev),
    }


def _closest(entry, counter, plain, o, d, tables, t_max, nodes_key="fat4nodes", gate=(),
             family_check=None):
    """Launch a closest-hit kernel (C entry `entry`, slot gate args after
    the ray count) and add one to counter.launches; CPU tensors run
    `plain()`.  `family_check(tables, nodes_key)` is the kernel family's own
    check of the tables.  No rays, or a scene without triangles, give miss records
    and launch nothing.  While counter.record is a list, each launch
    appends its rays and cap to it."""
    n, dev = _check_rays(o, d)
    _check_tables(tables, dev, nodes_key)
    if family_check is not None:
        family_check(tables, nodes_key)
    if not _use_kernel(dev):
        return plain()
    if n == 0 or tables[nodes_key].shape[0] == 0:
        return _misses(n, dev)
    o, d = o.contiguous(), d.contiguous()
    cap, stride = _cap_arg(t_max, n, dev)
    out = _hit_out(n, dev)
    check(getattr(native().lib, entry)(
        _ptr(o), _ptr(d), _ptr(cap), stride, _ptr(tables[nodes_key]), _ptr(tables["tris"]),
        int(tables["tris"].shape[1]), n, *gate, _ptr(out["t"]), _ptr(out["tri"]), _ptr(out["u"]),
        _ptr(out["v"]), _stream(),
    ), entry)
    counter.launches += 1
    _record(counter, o, d, t_max)
    return out


def _any(entry, counter, plain, o, d, tables, t_max, nodes_key="fat4nodes", gate=(),
         family_check=None):
    """As _closest, for an any-hit kernel -> occluded [N] bool."""
    n, dev = _check_rays(o, d)
    _check_tables(tables, dev, nodes_key)
    if family_check is not None:
        family_check(tables, nodes_key)
    if not _use_kernel(dev):
        return plain()
    if n == 0 or tables[nodes_key].shape[0] == 0:
        return torch.zeros(n, dtype=torch.bool, device=dev)
    o, d = o.contiguous(), d.contiguous()
    cap, stride = _cap_arg(t_max, n, dev)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    check(getattr(native().lib, entry)(
        _ptr(o), _ptr(d), _ptr(cap), stride, _ptr(tables[nodes_key]), _ptr(tables["tris"]),
        int(tables["tris"].shape[1]), n, *gate, _ptr(occ), _stream(),
    ), entry)
    counter.launches += 1
    _record(counter, o, d, t_max)
    return occ


def _combo(entry, counter, plain, o, b, l, tables, t_max_b, t_max_l, nodes_key="fat4nodes", gate=(),
           family_check=None):
    """As _closest, for the fused shadow+bounce kernel -> (hit, occluded).
    While counter.record is a list, each launch appends its rays and caps
    to it."""
    n, dev = _check_rays(o, b, l)
    _check_tables(tables, dev, nodes_key)
    if family_check is not None:
        family_check(tables, nodes_key)
    if not _use_kernel(dev):
        return plain()
    if n == 0 or tables[nodes_key].shape[0] == 0:
        return _misses(n, dev), torch.zeros(n, dtype=torch.bool, device=dev)
    o, b, l = o.contiguous(), b.contiguous(), l.contiguous()
    cap_b, sb = _cap_arg(t_max_b, n, dev)
    cap_l, sl = _cap_arg(t_max_l, n, dev)
    hit = _hit_out(n, dev)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    check(getattr(native().lib, entry)(
        _ptr(o), _ptr(b), _ptr(l), _ptr(cap_b), sb, _ptr(cap_l), sl, _ptr(tables[nodes_key]),
        _ptr(tables["tris"]), int(tables["tris"].shape[1]), n, *gate, _ptr(hit["t"]),
        _ptr(hit["tri"]), _ptr(hit["u"]), _ptr(hit["v"]), _ptr(occ), _stream(),
    ), entry)
    counter.launches += 1
    _record(counter, o, b, l, t_max_b, t_max_l)
    return hit, occ


def _record(counter, *inputs):
    """Append a launch's inputs to counter.record while it is a list."""
    if counter.record is not None:
        counter.record.append(tuple(x.clone() if torch.is_tensor(x) else x for x in inputs))


def group_rays() -> int:
    """The most rays for which K2, K3 (and their K6a / K6b builds), K7b and
    K7c run their group bodies, several lanes per ray, on the current CUDA
    device; above it, one thread per ray (K1, K7a and K8's any hit always
    take one)."""
    rays = ctypes.c_int64(0)
    check(native().lib.nb_group_rays(ctypes.byref(rays)), "nb_group_rays")
    return int(rays.value)


def node_group_rays() -> int:
    """The most rays for which K8's closest hit runs its group body on the
    current CUDA device: one wave of the group's lanes, a sixteenth of
    group_rays()."""
    rays = ctypes.c_int64(0)
    check(native().lib.nb_node_group_rays(ctypes.byref(rays)), "nb_node_group_rays")
    return int(rays.value)


def closest_hit_fat4(o, d, tables: dict, t_max=float("inf")):
    """K1: closest hit over the fat4 tables -> dict(t, tri, u, v)."""
    return _closest("nb_closest_fat4", closest_hit_fat4,
                    lambda: closest_hit_fat4_plain(o, d, tables, t_max), o, d, tables, t_max,
                    family_check=_check_wide_loads)


def any_hit_fat4(o, d, tables: dict, t_max=float("inf")):
    """K3: occlusion within t_max -> occluded [N] bool."""
    return _any("nb_any_fat4", any_hit_fat4,
                lambda: any_hit_fat4_plain(o, d, tables, t_max), o, d, tables, t_max,
                family_check=_check_wide_loads)


def shadow_closest_fat4(o, b, l, tables: dict, t_max_b=float("inf"), t_max_l=float("inf")):
    """K2: one walk for the bounce ray b (closest hit under t_max_b) and the
    shadow ray l (occlusion under t_max_l) from the same origins.
    Returns (hit dict, occluded [N])."""
    return _combo("nb_combo_fat4", shadow_closest_fat4,
                  lambda: shadow_closest_fat4_plain(o, b, l, tables, t_max_b, t_max_l),
                  o, b, l, tables, t_max_b, t_max_l, family_check=_check_wide_loads)


# K6a: the paged route (the `paged=True` builds of K1-K3).  On the GPU the
# triangle table stays in device memory behind the hardware caches, so
# these launch K1-K3 themselves; each counts its launches apart.


def closest_hit_fat4_paged(o, d, tables: dict, t_max=float("inf")):
    """K6a closest: K1 over the paged route's table."""
    return _closest("nb_closest_fat4", closest_hit_fat4_paged,
                    lambda: closest_hit_fat4_plain(o, d, tables, t_max), o, d, tables, t_max,
                    family_check=_check_wide_loads)


def any_hit_fat4_paged(o, d, tables: dict, t_max=float("inf")):
    """K6a any hit: K3 over the paged route's table."""
    return _any("nb_any_fat4", any_hit_fat4_paged,
                lambda: any_hit_fat4_plain(o, d, tables, t_max), o, d, tables, t_max,
                family_check=_check_wide_loads)


def shadow_closest_fat4_paged(o, b, l, tables: dict, t_max_b=float("inf"), t_max_l=float("inf")):
    """K6a fused walk: K2 over the paged route's table."""
    return _combo("nb_combo_fat4", shadow_closest_fat4_paged,
                  lambda: shadow_closest_fat4_plain(o, b, l, tables, t_max_b, t_max_l),
                  o, b, l, tables, t_max_b, t_max_l, family_check=_check_wide_loads)


# K6b: K1-K3 with the leaf slot gate, over one tri chunk of tables_to (the
# whole-tree fat4nodes, the chunk's tris view and its slot_lo / slot_hi).


def _slot_range(chunk):
    return int(chunk["slot_lo"]), int(chunk["slot_hi"])


def closest_hit_fat4_slots(o, d, chunk: dict, t_max=float("inf")):
    """K6b closest: K1 intersecting only the chunk's leaves."""
    sr = _slot_range(chunk)
    return _closest("nb_closest_fat4_slots", closest_hit_fat4_slots,
                    lambda: closest_hit_fat4_plain(o, d, chunk, t_max, slot_range=sr),
                    o, d, chunk, t_max, gate=sr, family_check=_check_wide_loads)


def any_hit_fat4_slots(o, d, chunk: dict, t_max=float("inf")):
    """K6b any hit: K3 intersecting only the chunk's leaves."""
    sr = _slot_range(chunk)
    return _any("nb_any_fat4_slots", any_hit_fat4_slots,
                lambda: any_hit_fat4_plain(o, d, chunk, t_max, slot_range=sr),
                o, d, chunk, t_max, gate=sr, family_check=_check_wide_loads)


def shadow_closest_fat4_slots(o, b, l, chunk: dict, t_max_b=float("inf"), t_max_l=float("inf")):
    """K6b fused walk: K2 intersecting only the chunk's leaves."""
    sr = _slot_range(chunk)
    return _combo("nb_combo_fat4_slots", shadow_closest_fat4_slots,
                  lambda: shadow_closest_fat4_plain(o, b, l, chunk, t_max_b, t_max_l, slot_range=sr),
                  o, b, l, chunk, t_max_b, t_max_l, gate=sr, family_check=_check_wide_loads)


# K7: fat2 walks over pack_bvh_fat's tables (bvh_wide=2).


def closest_hit_fat(o, d, tables: dict, t_max=float("inf")):
    """K7a: closest hit over fat2 tables -> dict(t, tri, u, v)."""
    return _closest("nb_closest_fat", closest_hit_fat,
                    lambda: closest_hit_fat_plain(o, d, tables, t_max), o, d, tables, t_max,
                    nodes_key="fatnodes", family_check=_check_wide_loads)


def any_hit_fat(o, d, tables: dict, t_max=float("inf")):
    """K7c: occlusion within t_max over fat2 tables -> occluded [N] bool."""
    return _any("nb_any_fat", any_hit_fat,
                lambda: any_hit_fat_plain(o, d, tables, t_max), o, d, tables, t_max,
                nodes_key="fatnodes", family_check=_check_wide_loads)


def shadow_closest_fat(o, b, l, tables: dict, t_max_b=float("inf"), t_max_l=float("inf")):
    """K7b: the fused bounce closest-hit and shadow any-hit walk over fat2
    tables.  Returns (hit dict, occluded [N])."""
    return _combo("nb_combo_fat", shadow_closest_fat,
                  lambda: shadow_closest_fat_plain(o, b, l, tables, t_max_b, t_max_l),
                  o, b, l, tables, t_max_b, t_max_l, nodes_key="fatnodes", family_check=_check_wide_loads)


# K8: one node per visit over pack_bvh_nodes' tables.


def closest_hit_node(o, d, tables: dict, t_max=float("inf")):
    """K8 closest hit over one-node tables -> dict(t, tri, u, v)."""
    return _closest("nb_closest_node", closest_hit_node,
                    lambda: closest_hit_node_plain(o, d, tables, t_max), o, d, tables, t_max,
                    nodes_key="nodes", family_check=_check_wide_loads)


def any_hit_node(o, d, tables: dict, t_max=float("inf")):
    """K8 any hit over one-node tables -> occluded [N] bool."""
    return _any("nb_any_node", any_hit_node,
                lambda: any_hit_node_plain(o, d, tables, t_max), o, d, tables, t_max,
                nodes_key="nodes", family_check=_check_wide_loads)


WRAPPERS = (
    closest_hit_fat4, shadow_closest_fat4, any_hit_fat4,
    closest_hit_fat4_paged, shadow_closest_fat4_paged, any_hit_fat4_paged,
    closest_hit_fat4_slots, shadow_closest_fat4_slots, any_hit_fat4_slots,
    closest_hit_fat, shadow_closest_fat, any_hit_fat,
    closest_hit_node, any_hit_node,
)
for _fn in WRAPPERS:
    _fn.launches = 0
    _fn.record = None
