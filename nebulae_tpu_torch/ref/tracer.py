"""Reference path tracer: brute force, trusted by inspection.

Counterpart of `nebulae_tpu/ref/tracer.py` on torch tensors.  Every ray is
tested against every triangle with a two-sided Moller-Trumbore of its own
(EPS = 1e-7), written one component at a time so that each product and sum
rounds once, as NumPy's do; bounces and samples are a Python loop.  The
shading and sampling math is the pipeline's (core.brdf, core.surface,
core.rng), as JAX's reference tracer shares JAX's with `xp=np`.  The RNG
draws follow the pipeline's draw-order contract line for line, dead paths
included, so the frames match the pipeline's to float tolerance.

It never runs a traversal table or a kernel of the port, and no Renderer
path calls it: it is the oracle the port's frames and gradients are held
to, on the CPU and on the card (`device`: the card unless "cpu" is asked
for).  Inputs may be NumPy arrays or tensors; outputs are tensors on the
device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nebulae_tpu_torch.core import brdf
from nebulae_tpu_torch.core import rng as nrng
from nebulae_tpu_torch.core.math import clip, dot
from nebulae_tpu_torch.core.surface import mip_level_from_uv, reconstruct_surface, reconstruct_surface_fast
from nebulae_tpu_torch.device import resolve_device
from nebulae_tpu_torch.passes.gbuffer import camera_rays, make_camera_arrays

_EPS = 1e-7
# Triangles per block at least: a ray block is then chunk // block rays.
_MIN_TRI_BLOCK = 4096
# Elements of a block's temporaries on one CPU thread, where a block that
# stays in cache runs ~1.4x faster than JAX's 4M; several threads and the
# card take `chunk`, which they split better.
_CPU_BLOCK = 1 << 18


def _tensor(x, dev, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x, dtype=dtype).to(dev)


def _scene_on(scene: dict, dev) -> dict:
    return {k: _tensor(v, dev) for k, v in scene.items()}


def _blocks(n: int, t_count: int, chunk: int, dev):
    """(ray block, triangle block) sizes whose [rays, tris] temporaries hold
    about `chunk` elements.  The first minimum wins whatever the blocking."""
    if dev.type == "cpu" and torch.get_num_threads() == 1:
        chunk = min(chunk, _CPU_BLOCK)
    tc = max(1, min(t_count, max(chunk // max(n, 1), _MIN_TRI_BLOCK)))
    return max(1, chunk // tc), tc


def _edges(tri_pos):
    v0 = tri_pos[:, 0]
    return v0, tri_pos[:, 1] - v0, tri_pos[:, 2] - v0


def _moller_trumbore(o, d, v0, e1, e2, t_max):
    """Rays o, d [R, 3] against triangles v0, e1, e2 [Tc, 3]: (ok, t, u, v)
    [R, Tc].  NumPy's cross and left-to-right dot products, each operation
    its own rounding."""
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    ax, ay, az = (v0[None, :, k] for k in range(3))
    e1x, e1y, e1z = (e1[None, :, k] for k in range(3))
    e2x, e2y, e2z = (e2[None, :, k] for k in range(3))
    # pvec = d x e2
    p0 = dy * e2z - dz * e2y
    p1 = dz * e2x - dx * e2z
    p2 = dx * e2y - dy * e2x
    det = e1x * p0 + e1y * p1 + e1z * p2
    small = torch.abs(det) < _EPS
    # 1 / 0 = inf only where det is small: masked like JAX's det == 0 guard.
    inv_det = torch.where(small, 0.0, 1.0 / det)
    # tvec = o - v0
    t0, t1, t2 = ox - ax, oy - ay, oz - az
    u = (t0 * p0 + t1 * p1 + t2 * p2) * inv_det
    # qvec = tvec x e1
    q0 = t1 * e1z - t2 * e1y
    q1 = t2 * e1x - t0 * e1z
    q2 = t0 * e1y - t1 * e1x
    v = (dx * q0 + dy * q1 + dz * q2) * inv_det
    t = (e2x * q0 + e2y * q1 + e2z * q2) * inv_det
    ok = ~small & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > _EPS) & (t < t_max)
    return ok, t, u, v


def _caps(t_max, n: int, dev):
    """t_max as a [n, 1] column (a scalar broadcasts)."""
    return torch.broadcast_to(_tensor(t_max, dev, torch.float32).reshape(-1), (n,))[:, None]


def intersect_closest(o, d, tri_pos, t_max=math.inf, chunk=4_000_000, device=None):
    """Brute-force closest hit.  o, d: [N, 3]; tri_pos: [T, 3, 3]; t_max a
    scalar or [N].  Returns dict(t [N] (inf on a miss), tri [N] int32 (-1 =
    miss), u [N], v [N]); among equal t the lowest triangle index wins."""
    dev = resolve_device(device)
    o, d, tri_pos = (_tensor(x, dev, torch.float32) for x in (o, d, tri_pos))
    n, t_count = o.shape[0], tri_pos.shape[0]
    best_t = torch.full((n,), math.inf, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    if t_count == 0:
        return {"t": best_t, "tri": best_tri, "u": best_u, "v": best_v}
    caps = _caps(t_max, n, dev)
    v0, e1, e2 = _edges(tri_pos)
    rb, tc = _blocks(n, t_count, chunk, dev)
    for r in range(0, n, rb):
        rs = slice(r, min(r + rb, n))
        for s in range(0, t_count, tc):
            ts = slice(s, min(s + tc, t_count))
            ok, t, u, v = _moller_trumbore(o[rs], d[rs], v0[ts], e1[ts], e2[ts], caps[rs])
            t = torch.where(ok, t, math.inf)
            tmin, arg = torch.min(t, dim=1)
            better = tmin < best_t[rs]
            best_t[rs] = torch.where(better, tmin, best_t[rs])
            best_tri[rs] = torch.where(better, (arg + s).to(torch.int32), best_tri[rs])
            best_u[rs] = torch.where(better, torch.gather(u, 1, arg[:, None])[:, 0], best_u[rs])
            best_v[rs] = torch.where(better, torch.gather(v, 1, arg[:, None])[:, 0], best_v[rs])
    return {"t": best_t, "tri": best_tri, "u": best_u, "v": best_v}


def intersect_any(o, d, tri_pos, t_max=math.inf, chunk=4_000_000, device=None):
    """Brute-force any hit (shadow rays) under t_max (scalar or [N]).
    Returns occluded [N] bool."""
    dev = resolve_device(device)
    o, d, tri_pos = (_tensor(x, dev, torch.float32) for x in (o, d, tri_pos))
    n, t_count = o.shape[0], tri_pos.shape[0]
    occluded = torch.zeros(n, dtype=torch.bool, device=dev)
    if t_count == 0:
        return occluded
    caps = _caps(t_max, n, dev)
    v0, e1, e2 = _edges(tri_pos)
    rb, tc = _blocks(n, t_count, chunk, dev)
    for r in range(0, n, rb):
        rs = slice(r, min(r + rb, n))
        for s in range(0, t_count, tc):
            ts = slice(s, min(s + tc, t_count))
            ok, _, _, _ = _moller_trumbore(o[rs], d[rs], v0[ts], e1[ts], e2[ts], caps[rs])
            occluded[rs] |= ok.any(dim=1)
    return occluded


def _closest_where(o, d, tri_pos, live, device):
    """intersect_closest on the rays where `live`; the others miss.  Which
    rays are traced changes no traced ray's result."""
    n = o.shape[0]
    out = {
        "t": torch.full((n,), math.inf, device=o.device),
        "tri": torch.full((n,), -1, dtype=torch.int32, device=o.device),
        "u": torch.zeros(n, device=o.device),
        "v": torch.zeros(n, device=o.device),
    }
    if bool(live.any()):
        hit = intersect_closest(o[live], d[live], tri_pos, device=device)
        for k in out:
            out[k][live] = hit[k]
    return out


def _any_where(o, d, tri_pos, live, device):
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    if bool(live.any()):
        occ[live] = intersect_any(o[live], d[live], tri_pos, device=device)
    return occ


# ---------------------------------------------------------------------------
# Passes
# ---------------------------------------------------------------------------


def render_gbuffer(scene: dict, camera, width: int, height: int, jitter=None, texture_mips: bool = False,
                   device=None):
    """Primary-visibility G-buffer of `camera` (a core.camera.Camera): the
    surface attributes plus depth, hit mask, view and the rays, flat
    [H*W, ...].  `jitter` [H*W, 2] offsets each ray in its pixel;
    `texture_mips` selects atlas mips from the UV derivatives as the
    pipeline's pass does."""
    dev = resolve_device(device)
    scene = _scene_on(scene, dev)
    cam = make_camera_arrays(camera, width, height, dev)
    o, d = camera_rays(cam, width, height, jitter=None if jitter is None else _tensor(jitter, dev))
    hit = intersect_closest(o, d, scene["tri_pos"], device=dev)
    valid = hit["tri"] >= 0
    mip = None
    if texture_mips and "mat_tex_mip_ids" in scene and scene["textures"].shape[0] > 0:
        mip = mip_level_from_uv(scene, hit["tri"], hit["u"], hit["v"], height, width)
    surf = reconstruct_surface(scene, hit["tri"], hit["u"], hit["v"], view_dir=-d, mip_level=mip)
    out = {k: surf[k] for k in ("position", "normal_g", "normal_s", "albedo", "roughness", "metalness",
                                "emissive")}
    out.update(hit=valid, depth=torch.where(valid, hit["t"], math.inf), view=-d, ray_o=o.contiguous(), ray_d=d)
    return out


def shade_direct(scene: dict, gbuf: dict, sun, rng_state, device=None):
    """Sun NEE with one jittered sun-disk shadow ray per pixel (2 draws).
    Returns (radiance [N, 3], rng_state)."""
    dev = resolve_device(device)
    scene = _scene_on(scene, dev)
    sun = sun.to(dev)
    n = gbuf["normal_s"]
    v = gbuf["view"]
    rng_state, u1 = nrng.next_float(_tensor(rng_state, dev))
    rng_state, u2 = nrng.next_float(rng_state)
    l = brdf.sun_disk_sample(u1, u2, sun.direction[None, :], sun.tan_half_angle)
    n_dot_l = clip(dot(n, l, False), 0.0, 1.0)
    f = brdf.eval_brdf(n, v, l, gbuf["albedo"], gbuf["roughness"], gbuf["metalness"])
    origin = brdf.offset_ray_origin(gbuf["position"], gbuf["normal_g"])
    shoot = gbuf["hit"] & (n_dot_l > 0.0)
    occluded = _any_where(origin, l, scene["tri_pos"], shoot, dev)
    vis = torch.where(shoot & ~occluded, 1.0, 0.0)
    radiance = f * (n_dot_l * vis)[..., None] * sun.radiance
    return torch.where(gbuf["hit"][..., None], radiance + gbuf["emissive"], 0.0), rng_state


def _init_state(width: int, height: int, frame: int, dev):
    ys, xs = torch.meshgrid(torch.arange(height, device=dev), torch.arange(width, device=dev), indexing="ij")
    return nrng.init_rng(xs.reshape(-1), ys.reshape(-1), width, frame)


def render_direct(scene: dict, camera, cfg, sun, frame: int = 0, device=None):
    """G-buffer and the direct pass; misses show the sky.  Returns HDR
    [H, W, 3]."""
    dev = resolve_device(device)
    scene = _scene_on(scene, dev)
    w, h = cfg.width, cfg.height
    gbuf = render_gbuffer(scene, camera, w, h, texture_mips=cfg.texture_mips, device=dev)
    direct, _ = shade_direct(scene, gbuf, sun, _init_state(w, h, frame, dev), device=dev)
    sky = brdf.sky_eval(gbuf["ray_d"], sun.to(dev), scene, cfg)
    return torch.where(gbuf["hit"][..., None], direct, sky).reshape(h, w, 3)


def path_trace(scene: dict, camera, cfg, sun, frame: int = 0, device=None, return_rng: bool = False):
    """Full path trace: the G-buffer's primary hits, sun NEE at every
    vertex and cosine bounces through lobe Russian roulette, cfg.spp
    samples.  Returns HDR radiance [H, W, 3] (direct + indirect), and with
    `return_rng` the pixels' RNG states after the last draw."""
    dev = resolve_device(device)
    scene = _scene_on(scene, dev)
    sun = sun.to(dev)
    tri_pos = scene["tri_pos"]
    w, h = cfg.width, cfg.height
    gbuf = render_gbuffer(scene, camera, w, h, texture_mips=cfg.texture_mips, device=dev)
    n_pix = w * h
    state = _init_state(w, h, frame, dev)
    acc = torch.zeros((n_pix, 3), device=dev)

    for _ in range(cfg.spp):
        sample_gbuf = gbuf
        if cfg.jitter_primary:
            # 2 jitter draws, then the path's; each sample traces its own
            # primary hit and shows the sky along its own missed rays.
            state, jx = nrng.next_float(state)
            state, jy = nrng.next_float(state)
            sample_gbuf = render_gbuffer(scene, camera, w, h, jitter=torch.stack([jx, jy], -1),
                                         texture_mips=cfg.texture_mips, device=dev)
            sky_s = brdf.sky_eval(sample_gbuf["ray_d"], sun, scene, cfg)
            acc = acc + torch.where(sample_gbuf["hit"][..., None], 0.0, sky_s)
        throughput = torch.ones((n_pix, 3), device=dev)
        alive = sample_gbuf["hit"].clone()
        surf = {k: sample_gbuf[k] for k in ("position", "normal_g", "normal_s", "albedo", "roughness",
                                             "metalness", "emissive")}
        view = sample_gbuf["view"]
        acc = acc + torch.where(alive[..., None], surf["emissive"], 0.0) * throughput

        for bounce in range(cfg.max_bounces):
            # NEE: sun disk (2 draws).
            state, u1 = nrng.next_float(state)
            state, u2 = nrng.next_float(state)
            l = brdf.sun_disk_sample(u1, u2, sun.direction[None, :], sun.tan_half_angle)
            n_dot_l = clip(dot(surf["normal_s"], l, False), 0.0, 1.0)
            f = brdf.eval_brdf(surf["normal_s"], view, l, surf["albedo"], surf["roughness"], surf["metalness"])
            origin = brdf.offset_ray_origin(surf["position"], surf["normal_g"])
            shoot = alive & (n_dot_l > 0.0)
            occ = _any_where(origin, l, tri_pos, shoot, dev)
            vis = torch.where(shoot & ~occ, 1.0, 0.0)
            acc = acc + torch.where(alive[..., None], throughput * f * (n_dot_l * vis)[..., None] * sun.radiance, 0.0)

            if bounce == cfg.max_bounces - 1:
                break

            # Lobe-selection Russian roulette (1 draw): on through the
            # diffuse lobe with probability p_d, throughput boosted by 1/p_d.
            state, u_rr = nrng.next_float(state)
            n_dot_v = clip(dot(surf["normal_s"], view, False), 0.0, 1.0)
            p_d = brdf.diffuse_probability(surf["albedo"], surf["metalness"], n_dot_v)
            # Indirect: cosine hemisphere, Lambertian weight (2 draws).
            state, u1 = nrng.next_float(state)
            state, u2 = nrng.next_float(state)
            new_d = brdf.cosine_hemisphere_sample(u1, u2, surf["normal_s"])
            weight = brdf.diffuse_reflectance(surf["albedo"], surf["metalness"]) / p_d[..., None]
            throughput = throughput * weight
            alive = alive & (u_rr < p_d)
            if cfg.throughput_threshold > 0.0:
                alive = alive & (throughput.amax(dim=-1) > cfg.throughput_threshold)

            # Dead paths still drew above: each pixel's stream consumes the
            # same draws as the pipeline's.  Only live paths are traced.
            hit = _closest_where(origin, new_d, tri_pos, alive, dev)
            found = hit["tri"] >= 0
            # A miss shows the sky and ends the path.
            sky_b = brdf.sky_eval(new_d, sun, scene, cfg)
            acc = acc + torch.where((alive & ~found)[..., None], throughput * sky_b, 0.0)
            alive = alive & found
            if cfg.fast_bounce_shading:
                surf = reconstruct_surface_fast(scene, hit["tri"], hit["u"], hit["v"], origin, new_d, hit["t"])
            else:
                surf = reconstruct_surface(scene, hit["tri"], hit["u"], hit["v"], view_dir=-new_d)
            acc = acc + torch.where(alive[..., None], throughput * surf["emissive"], 0.0)
            view = -new_d

    img = acc / cfg.spp
    if not cfg.jitter_primary:
        # Primary misses show the sky (with jitter each sample added its own).
        sky_p = brdf.sky_eval(gbuf["ray_d"], sun, scene, cfg)
        img = torch.where(gbuf["hit"][..., None], img, sky_p)
    img = img.reshape(h, w, 3)
    return (img, state) if return_rng else img
