"""Tracer factory: brute force for small scenes, the traversal kernels above.

Counterpart of `nebulae_tpu/tracer/trace.py`.  `make_tracer` keeps the
`(closest, any)` contract: `closest(o, d, t_max)` -> dict(t, tri, u, v),
`any(o, d, t_max)` -> occluded [N], and `closest.combo(o, b, l, t_max_b,
t_max_l)` -> (hit, occluded) for the fused shadow+bounce walk.  The tables'
route picks the kernels: K1-K3 over one fat4 table, K7 over one fat2 table
(bvh_wide=2), K6a on the paged route, chained K6b walks over triangle
chunks, chained K1-K3 / K7 / K8 walks over subtree chunks, or K8 over
one-node tables (whose combo is K8 closest then K8 any).
"""

from __future__ import annotations

import torch

from nebulae_tpu_torch.device import resolve_device
from nebulae_tpu_torch.kernels import chunks as kc
from nebulae_tpu_torch.kernels import trace as kt
from nebulae_tpu_torch.tracer.intersect import ray_triangle

# Rays per brute-force chunk scale inversely with the triangle count so the
# [rays, tris] temporaries stay bounded.
_BRUTE_ELEMS = 1 << 22


def _chunks(n, t_count):
    step = max(1, _BRUTE_ELEMS // max(t_count, 1))
    return [(s, min(s + step, n)) for s in range(0, n, step)]


def _cap_rows(t_max, s, e, ref):
    t = torch.as_tensor(t_max, dtype=torch.float32, device=ref.device)
    return t[s:e, None] if t.dim() == 1 else t


def bruteforce_closest_hit(o, d, tri_pos, t_max=float("inf")):
    """Every ray against every triangle; first minimum wins."""
    n = o.shape[0]
    t_out = torch.full((n,), float("inf"), dtype=torch.float32, device=o.device)
    tri_out = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    u_out = torch.zeros(n, dtype=torch.float32, device=o.device)
    v_out = torch.zeros_like(u_out)
    if tri_pos.shape[0] == 0:
        return {"t": t_out, "tri": tri_out, "u": u_out, "v": v_out}
    v0 = tri_pos[:, 0]
    e1 = tri_pos[:, 1] - v0
    e2 = tri_pos[:, 2] - v0
    for s, e in _chunks(n, tri_pos.shape[0]):
        _, t, u, v = ray_triangle(
            o[s:e, None, :], d[s:e, None, :], v0[None], e1[None], e2[None],
            t_max=_cap_rows(t_max, s, e, o),
        )
        tmin, arg = torch.min(t, dim=1)
        found = torch.isfinite(tmin)
        t_out[s:e] = tmin
        tri_out[s:e] = torch.where(found, arg.to(torch.int32), -1)
        u_out[s:e] = torch.where(found, torch.gather(u, 1, arg[:, None])[:, 0], 0.0)
        v_out[s:e] = torch.where(found, torch.gather(v, 1, arg[:, None])[:, 0], 0.0)
    return {"t": t_out, "tri": tri_out, "u": u_out, "v": v_out}


def bruteforce_any_hit(o, d, tri_pos, t_max=float("inf")):
    n = o.shape[0]
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    if tri_pos.shape[0] == 0:
        return occ
    v0 = tri_pos[:, 0]
    e1 = tri_pos[:, 1] - v0
    e2 = tri_pos[:, 2] - v0
    for s, e in _chunks(n, tri_pos.shape[0]):
        hit, _, _, _ = ray_triangle(
            o[s:e, None, :], d[s:e, None, :], v0[None], e1[None], e2[None],
            t_max=_cap_rows(t_max, s, e, o),
        )
        occ[s:e] = hit.any(dim=1)
    return occ


def _with_combo(closest, combo):
    def fn(o, d, t_max=float("inf")):
        return closest(o, d, t_max=t_max)

    fn.combo = combo
    return fn


def make_tracer(scene: dict, tables: dict | None, cfg, device=None):
    """(closest_fn, any_fn) for the scene: brute force at or below
    cfg.bruteforce_max_tris (or without tables), the kernels of the tables'
    route above.  The scene tensors must live on `device` (CUDA unless
    "cpu" is asked for)."""
    dev = resolve_device(device)
    if scene["tri_pos"].device.type != dev.type:
        raise ValueError(f"scene tensors are on {scene['tri_pos'].device}, expected {dev}")
    t_count = scene["tri_pos"].shape[0]
    # "bvh" names JAX's XLA walk over the same tree; here it is a strategy
    # knob for the tables' kernels, built even where "auto" goes brute force.
    mode = "pallas" if cfg.tracer == "bvh" else cfg.tracer
    if mode == "auto":
        mode = "bruteforce" if (tables is None or t_count <= cfg.bruteforce_max_tris) else "pallas"
    if mode == "bruteforce":
        tri_pos = scene["tri_pos"]

        def closest(o, d, t_max=float("inf")):
            return bruteforce_closest_hit(o, d, tri_pos, t_max)

        def any_hit(o, d, t_max=float("inf")):
            return bruteforce_any_hit(o, d, tri_pos, t_max)

        def combo(o, b, l, t_max_b, t_max_l):
            return closest(o, b, t_max_b), any_hit(o, l, t_max_l)

        return _with_combo(closest, combo), any_hit
    if mode != "pallas":
        raise ValueError(f"unknown tracer mode: {mode}")
    if tables is None:
        raise ValueError(f'tracer="{cfg.tracer}" needs traversal tables')
    if "tri_chunks" in tables:
        closest, any_hit, combo = kc.closest_tri_chunks, kc.any_tri_chunks, kc.shadow_closest_tri_chunks
    elif "chunks" in tables:
        closest, any_hit, combo = kc.closest_chunks, kc.any_chunks, kc.shadow_closest_chunks
        tables = tables["chunks"]
    elif "nodes" in tables:
        closest, any_hit = kt.closest_hit_node, kt.any_hit_node

        def combo(o, b, l, tabs, t_max_b, t_max_l):
            return kt.closest_hit_node(o, b, tabs, t_max_b), kt.any_hit_node(o, l, tabs, t_max_l)
    elif "fatnodes" in tables:
        closest, any_hit, combo = kt.closest_hit_fat, kt.any_hit_fat, kt.shadow_closest_fat
    elif tables.get("paged", False):
        closest, any_hit, combo = kt.closest_hit_fat4_paged, kt.any_hit_fat4_paged, kt.shadow_closest_fat4_paged
    else:
        closest, any_hit, combo = kt.closest_hit_fat4, kt.any_hit_fat4, kt.shadow_closest_fat4

    def closest_k(o, d, t_max=float("inf")):
        return closest(o, d, tables, t_max)

    def any_k(o, d, t_max=float("inf")):
        return any_hit(o, d, tables, t_max)

    def combo_k(o, b, l, t_max_b, t_max_l):
        return combo(o, b, l, tables, t_max_b, t_max_l)

    return _with_combo(closest_k, combo_k), any_k
