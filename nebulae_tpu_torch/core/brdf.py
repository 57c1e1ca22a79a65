"""Cook-Torrance + Lambert BRDF, sampling and sky, on torch tensors.

Same float32 formulas as `nebulae_tpu/core/brdf.py`, including the RNG
draw-order contract: per path vertex 2 draws sun-disk NEE, then (unless it
is the last vertex) 1 draw lobe-selection Russian roulette and 2 draws
cosine-hemisphere bounce direction.  The VNDF sampler is ported with the
same status as in JAX: nothing on the live path calls it.
"""

from __future__ import annotations

import torch

from nebulae_tpu_torch.core.math import (
    build_orthonormal_basis,
    clip,
    cross,
    dot,
    ipow,
    luminance,
    maximum,
    normalize,
)
from nebulae_tpu_torch.core.surface import gather_rows

F0_DIELECTRIC = 0.04
PI = 3.14159265358979


def fresnel_schlick(cos_theta, f0):
    c = clip(cos_theta, 0.0, 1.0)
    return f0 + (1.0 - f0) * ipow(1.0 - c, 5)


def ggx_ndf(n_dot_h, alpha):
    a2 = alpha * alpha
    d = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / maximum(PI * d * d, 1e-8)


def smith_g1(n_dot_x, alpha):
    k = alpha * 0.5
    return n_dot_x / maximum(n_dot_x * (1.0 - k) + k, 1e-8)


def base_f0(albedo, metalness):
    return F0_DIELECTRIC * (1.0 - metalness[..., None]) + albedo * metalness[..., None]


def eval_brdf(n, v, l, albedo, roughness, metalness):
    """f(v, l) without the cosine; n, v, l [..., 3] unit, pointing away."""
    h = normalize(v + l)
    n_dot_l = clip(dot(n, l, False), 0.0, 1.0)
    n_dot_v = clip(dot(n, v, False), 0.0, 1.0)
    n_dot_h = clip(dot(n, h, False), 0.0, 1.0)
    v_dot_h = clip(dot(v, h, False), 0.0, 1.0)
    alpha = maximum(roughness * roughness, 1e-3)
    f0 = base_f0(albedo, metalness)
    fres = fresnel_schlick(v_dot_h[..., None], f0)
    d = ggx_ndf(n_dot_h, alpha)
    g = smith_g1(n_dot_l, alpha) * smith_g1(n_dot_v, alpha)
    spec = fres * (d * g / maximum(4.0 * n_dot_l * n_dot_v, 1e-8))[..., None]
    kd = (1.0 - fres) * (1.0 - metalness[..., None])
    diffuse = kd * albedo / PI
    return diffuse + spec


def diffuse_reflectance(albedo, metalness):
    return albedo * (1.0 - metalness[..., None])


def specular_probability(albedo, metalness, n_dot_v):
    f0 = base_f0(albedo, metalness)
    fres = fresnel_schlick(n_dot_v[..., None], f0)
    s = luminance(fres)
    d = luminance(diffuse_reflectance(albedo, metalness))
    p = s / maximum(s + d, 1e-8)
    return clip(p, 0.1, 0.9)


def diffuse_probability(albedo, metalness, n_dot_v):
    """Probability of continuing through the diffuse lobe, in [0.1, 0.9]."""
    return 1.0 - specular_probability(albedo, metalness, n_dot_v)


def cosine_hemisphere_sample(u1, u2, n):
    """Cosine-weighted direction around unit normal n (pdf cos/pi)."""
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    t, b = build_orthonormal_basis(n)
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    return normalize(x[..., None] * t + y[..., None] * b + z[..., None] * n)


def sun_disk_sample(u1, u2, sun_dir, tan_half_angle):
    """Uniform direction in the sun's cone; sun_dir points toward the sun."""
    t, b = build_orthonormal_basis(sun_dir)
    r = torch.sqrt(u1) * tan_half_angle
    phi = 2.0 * PI * u2
    d = sun_dir + r[..., None] * (torch.cos(phi)[..., None] * t + torch.sin(phi)[..., None] * b)
    return normalize(d)


def sample_vndf_ggx(u1, u2, n, v, roughness):
    """GGX half-vector from the visible-normal distribution (Heitz 2018);
    unused on the live path, as in the JAX package."""
    alpha = roughness * roughness
    t, b = build_orthonormal_basis(n)
    vx = dot(v, t, False)
    vy = dot(v, b, False)
    vz = torch.clamp(dot(v, n, False), 1e-6, 1.0)
    vh = normalize(torch.stack([alpha * vx, alpha * vy, vz], dim=-1))
    lensq = vh[..., 0] * vh[..., 0] + vh[..., 1] * vh[..., 1]
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype, device=vh.device).expand(vh.shape)
    t1 = torch.where(
        (lensq > 1e-12)[..., None],
        torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv, torch.zeros_like(inv)], dim=-1),
        ex,
    )
    t2 = cross(vh, t1)
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    h_ts = normalize(
        torch.stack([alpha * nh[..., 0], alpha * nh[..., 1], torch.clamp(nh[..., 2], min=1e-6)], dim=-1)
    )
    return normalize(h_ts[..., 0:1] * t + h_ts[..., 1:2] * b + h_ts[..., 2:3] * n)


def smith_g1_exact(n_dot_x, alpha):
    a2 = alpha * alpha
    c = clip(n_dot_x, 1e-6, 1.0)
    return 2.0 * c / (c + torch.sqrt(a2 + (1.0 - a2) * c * c))


def vndf_pdf(n, v, h, roughness):
    """Solid-angle pdf of reflect(-v, h) under sample_vndf_ggx."""
    alpha = roughness * roughness
    n_dot_v = clip(dot(n, v, False), 1e-6, 1.0)
    n_dot_h = clip(dot(n, h, False), 0.0, 1.0)
    return smith_g1_exact(n_dot_v, alpha) * ggx_ndf(n_dot_h, alpha) / (4.0 * n_dot_v)


def offset_ray_origin(p, n, scale: float = 1e-4):
    """Self-intersection avoidance along the geometric normal."""
    return p + n * scale


def sky_radiance(d, sky_color):
    """Constant sky color."""
    return sky_color.to(torch.float32).expand(d.shape[:-1] + (3,))


def sky_envmap(d, env_map):
    """Lat-long environment-map lookup, bilinear (phi -> u, theta -> v).
    Differentiable in the map: its four texel gathers go through
    surface.gather_rows, whose backward is one bincount."""
    h, w = env_map.shape[0], env_map.shape[1]
    phi = torch.atan2(d[..., 2], d[..., 0])
    theta = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0))
    u = (phi / (2.0 * PI) + 0.5) * w - 0.5
    v = theta / PI * h - 0.5
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int32), w).long()
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.to(torch.int32), 0, h - 1).long()
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    texels = env_map.reshape(h * w, env_map.shape[2])
    lead = d.shape[:-1]

    def tap(y, x):
        return gather_rows(texels, (y * w + x).reshape(-1)).reshape(lead + (texels.shape[1],))

    c00 = tap(y0i, x0i)
    c01 = tap(y0i, x1i)
    c10 = tap(y1i, x0i)
    c11 = tap(y1i, x1i)
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def sky_eval(d, sun, scene, cfg):
    """Sky radiance along miss directions d: the scene's "env_map" when
    cfg.enable_envmap and the scene holds one, else the constant sky."""
    if cfg.enable_envmap and "env_map" in scene:
        return sky_envmap(d, scene["env_map"])
    return sky_radiance(d, sun.sky_color)
