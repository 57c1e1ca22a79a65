"""Wavefront path tracing from the G-buffer.

Counterpart of `nebulae_tpu/passes/pathtrace.py`: at every vertex
sun-disk NEE, lobe Russian roulette and the bounce draw with the walk's
sort key (`kernels/vertex.py` bounce_vertex: kernel K9 on the card), one
fused shadow+bounce walk over the live lanes (kernel K2), next-vertex
surface reconstruction; NEE with an any-hit ray (kernel K3) at
the last vertex (its draws and key: last_vertex, K9 likewise).  The
next vertex's surface is reconstructed on the compact hits, with full
texture shading (`_full_shading_compact_post`) or, under
`fast_bounce_shading` with sorted rays, from the `tri_fast` rows and the
texture-averaged materials (`_fast_shading_compact_post`); fast shading
without sorted rays reconstructs at full width after the walk, as JAX does.

RNG contract (same as JAX): per vertex 2 draws NEE, then unless it is the
last vertex 1 draw Russian roulette and 2 draws bounce direction.
Gradient contract: hits and texture terms are detached; the material
factors are multiplied back at full width and keep their gradients.
"""

from __future__ import annotations

import torch

from nebulae_tpu_torch.core import brdf
from nebulae_tpu_torch.core.math import clip, cross, dot, normalize
from nebulae_tpu_torch.core.surface import (
    average_material,
    bary_packed,
    f32_int,
    gather_rows,
    has_textures,
    normal_mapped,
    reconstruct_surface_fast,
    sample_material_texels,
    take_rows,
)
from nebulae_tpu_torch.core.texture import srgb_to_linear
from nebulae_tpu_torch.kernels.vertex import bounce_vertex, last_vertex
from nebulae_tpu_torch.tracer.sorting import sorted_any, sorted_shadow_closest

SURF_KEYS = ("position", "normal_g", "normal_s", "albedo", "roughness", "metalness", "emissive")


def sort_box(scene, cfg):
    """The scene box that keys each walk's rays (cfg.sort_rays), or None."""
    return (scene["aabb_min"], scene["aabb_max"]) if cfg.sort_rays else None


def _full_shading_compact_post(scene):
    """compact_post for full-shading bounces: geometry row, bilinear atlas
    fetch and normal-map TBN on the compact hits; texture terms come back
    detached and apart from the differentiable material factors."""
    n_tris = scene["tri_pos"].shape[0]
    tex = has_textures(scene)
    fills = {"nsz": 1.0, "ngz": 1.0, "tax": 1.0, "tay": 1.0, "taz": 1.0,
             "tr": 1.0, "tm": 1.0, "tex": 0.0, "tey": 0.0, "tez": 0.0}
    names = ["px", "py", "pz", "nsx", "nsy", "nsz", "ngx", "ngy", "ngz"]
    if tex:
        names += ["tax", "tay", "taz", "tr", "tm", "tex", "tey", "tez"]

    def post(hit, os, bs):
        if n_tris == 0:
            m = hit["t"].shape[0]
            out = {k: torch.full((m,), fills.get(k, 0.0), device=os.device) for k in names}
            out["mat"] = torch.full((m,), -1.0, device=os.device)
            return out
        tid = torch.clamp(hit["tri"], 0, n_tris - 1).long()
        row = take_rows(scene["tri_geom"], tid)
        u, v = hit["u"], hit["v"]
        v0, e1, e2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
        pos = v0 + u[..., None] * e1 + v[..., None] * e2
        nrm = normalize(bary_packed(row[..., 9:18], u, v, 3))
        ng = normalize(cross(e1, e2))
        ng = ng * torch.where(dot(ng, nrm) < 0.0, -1.0, 1.0)
        out = {
            "mat": torch.where(hit["tri"] >= 0, row[..., 36], -1.0),
            "px": pos[..., 0], "py": pos[..., 1], "pz": pos[..., 2],
        }
        if tex:
            uv = bary_packed(row[..., 18:24], u, v, 2)
            tan4 = bary_packed(row[..., 24:36], u, v, 4)
            px = sample_material_texels(scene, f32_int(row[..., 38]), uv)
            ta = srgb_to_linear(px[..., 0:3])
            te = srgb_to_linear(px[..., 8:11])
            ns = normal_mapped(px, nrm, tan4, f32_int(row[..., 37]))
            out.update({
                "tax": ta[..., 0], "tay": ta[..., 1], "taz": ta[..., 2],
                "tr": px[..., 3], "tm": px[..., 4],
                "tex": te[..., 0], "tey": te[..., 1], "tez": te[..., 2],
            })
        else:
            ns = nrm
        flip = torch.where(dot(ns, -bs) < 0.0, -1.0, 1.0)
        ns = ns * flip
        ng = ng * flip
        out.update({
            "nsx": ns[..., 0], "nsy": ns[..., 1], "nsz": ns[..., 2],
            "ngx": ng[..., 0], "ngy": ng[..., 1], "ngz": ng[..., 2],
        })
        return {k: x.detach() for k, x in out.items()}

    return post, fills


def _compact_reconstruct_mode(scene, cfg):
    """"fast" | "full" | None: which compact-domain reconstruct applies.
    As in JAX, fast shading reconstructs in the compact domain only with
    sorted rays and a non-empty `tri_fast` table, else at full width (None).
    Full shading always runs in the compact domain: the port compacts the
    live lanes exactly with or without the sort, and no output depends on
    their order."""
    if cfg.fast_bounce_shading:
        return "fast" if cfg.sort_rays and scene["tri_fast"].shape[0] > 0 else None
    return "full"


def _fast_shading_compact_post(scene):
    """compact_post for fast-shading bounces: the `tri_fast` row (shading
    normal corners, face normal, material) read and interpolated on the
    compact hits.  Misses carry mat -1; dead lanes get unit normals."""
    n_tris = scene["tri_pos"].shape[0]

    def post(hit, os, bs):
        tid = torch.clamp(hit["tri"], 0, n_tris - 1).long()
        row = take_rows(scene["tri_fast"], tid)
        nrm = normalize(bary_packed(row[..., 0:9], hit["u"], hit["v"], 3))
        ng = row[..., 9:12]
        flip = torch.where(dot(nrm, -bs) < 0.0, -1.0, 1.0)
        ns = nrm * flip
        ng = ng * torch.where(dot(ng, ns) < 0.0, -1.0, 1.0)
        out = {
            "mat": torch.where(hit["tri"] >= 0, row[..., 12], -1.0),
            "nsx": ns[..., 0], "nsy": ns[..., 1], "nsz": ns[..., 2],
            "ngx": ng[..., 0], "ngy": ng[..., 1], "ngz": ng[..., 2],
        }
        return {k: x.detach() for k, x in out.items()}

    return post, {"nsz": 1.0, "ngz": 1.0}


def nee_bounce_step(scene, pre, alive_bounce, closest_fn, cfg):
    """One vertex's shadow + bounce traces and next-vertex surface, by
    _compact_reconstruct_mode, from bounce_vertex's `pre` (its "key", when
    there, orders the walk).  Returns (vis [N], found [N], hit_t [N], surf
    dict, walked): `walked` indexes the lanes the walk traced
    (sorted_shadow_closest's), and every lane outside it has found False."""
    origin = pre["origin"].detach()
    l = pre["l"].detach()
    b = pre["new_d"].detach()
    key = pre.get("key")
    mode = _compact_reconstruct_mode(scene, cfg)
    if mode is None:
        occ, hit, walked = sorted_shadow_closest(closest_fn.combo, origin, l, b, pre["shoot"], alive_bounce,
                                                 key=key)
        vis = torch.where(pre["shoot"] & ~occ, 1.0, 0.0)
        # Fast shading at full width after the walk (JAX's _reconstruct).
        surf = reconstruct_surface_fast(scene, hit["tri"], hit["u"], hit["v"], pre["origin"], pre["new_d"],
                                        hit["t"])
        return vis, hit["tri"] >= 0, hit["t"], surf, walked
    post, fills = (_fast_shading_compact_post if mode == "fast" else _full_shading_compact_post)(scene)
    occ, hit, walked = sorted_shadow_closest(
        closest_fn.combo, origin, l, b, pre["shoot"], alive_bounce, key=key,
        compact_post=post, post_fills=fills,
    )
    vis = torch.where(pre["shoot"] & ~occ, 1.0, 0.0)
    m = torch.clamp(hit["mat"], 0, scene["mat_base_color"].shape[0] - 1)
    ns = torch.stack([hit["nsx"], hit["nsy"], hit["nsz"]], dim=-1)
    ng = torch.stack([hit["ngx"], hit["ngy"], hit["ngz"]], dim=-1)
    if mode == "fast":
        tcl = torch.clamp(hit["t"], 0.0, 1e30)
        surf = {
            "position": pre["origin"] + tcl[..., None] * pre["new_d"],
            "normal_g": ng,
            "normal_s": ns,
            **average_material(scene, m),
        }
        return vis, hit["found"], hit["t"], surf, walked
    base = gather_rows(scene["mat_base_color"], m)
    rough = gather_rows(scene["mat_roughness"], m)
    metal = gather_rows(scene["mat_metallic"], m)
    emissive = gather_rows(scene["mat_emissive"], m)
    albedo = base[..., :3]
    if "tax" in hit:
        albedo = albedo * torch.stack([hit["tax"], hit["tay"], hit["taz"]], dim=-1)
        rough = rough * hit["tr"]
        metal = metal * hit["tm"]
        emissive = emissive * torch.stack([hit["tex"], hit["tey"], hit["tez"]], dim=-1)
    surf = {
        "position": torch.stack([hit["px"], hit["py"], hit["pz"]], dim=-1),
        "normal_g": ng,
        "normal_s": ns,
        "albedo": albedo,
        "roughness": clip(rough, 0.02, 1.0),
        "metalness": clip(metal, 0.0, 1.0),
        "emissive": emissive,
    }
    return vis, hit["found"], hit["t"], surf, walked


def _nee_direct(scene, surf, view, sun, alive, any_fn, rng_state, cfg):
    """Sun-disk NEE at the last vertex (2 draws): (direct, rng_state, shoot)."""
    rng_state, nee = last_vertex(surf, view, sun, alive, rng_state, sort_box(scene, cfg))
    shoot = nee["shoot"]
    occ = sorted_any(any_fn, nee["origin"].detach(), nee["l"].detach(), shoot, nee.get("key"))
    vis = torch.where(shoot & ~occ, 1.0, 0.0)
    direct = nee["f"] * (nee["n_dot_l"] * vis)[..., None] * sun.radiance[None, :]
    return direct, rng_state, shoot


def path_trace(scene, gbuf, sun, closest_fn, any_fn, rng_state, cfg):
    """Indirect GI from the G-buffer surfaces: max_bounces - 1 bounce
    vertices and NEE at the last one.  Returns (radiance [N, 3], rng_state)."""
    n_pix = gbuf["ray_d"].shape[0]
    surf = {k: gbuf[k] for k in SURF_KEYS}
    acc = torch.where(gbuf["hit"][..., None], surf["emissive"], 0.0)
    throughput = torch.ones((n_pix, 3), dtype=torch.float32, device=acc.device)
    alive = gbuf["hit"]
    view = gbuf["view"]
    for _ in range(cfg.max_bounces - 1):
        rng_state, pre = bounce_vertex(surf, view, sun, alive, rng_state, sort_box(scene, cfg))
        new_throughput = throughput * pre["weight"]
        alive_b = alive & pre["rr_continue"]
        if cfg.throughput_threshold > 0.0:
            alive_b = alive_b & (new_throughput.amax(dim=-1) > cfg.throughput_threshold)
        vis, found, _hit_t, surf, _walked = nee_bounce_step(scene, pre, alive_b, closest_fn, cfg)
        direct = pre["f"] * (pre["n_dot_l"] * vis)[..., None] * sun.radiance[None, :]
        acc = acc + torch.where(alive[..., None], throughput * direct, 0.0)
        throughput = new_throughput
        alive = alive_b
        sky = brdf.sky_eval(pre["new_d"], sun, scene, cfg)
        acc = acc + torch.where((alive & ~found)[..., None], throughput * sky, 0.0)
        alive = alive & found
        acc = acc + torch.where(alive[..., None], throughput * surf["emissive"], 0.0)
        view = -pre["new_d"]
    direct, rng_state, _shoot = _nee_direct(scene, surf, view, sun, alive, any_fn, rng_state, cfg)
    acc = acc + torch.where(alive[..., None], throughput * direct, 0.0)
    return acc, rng_state
