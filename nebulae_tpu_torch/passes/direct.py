"""Direct lighting: sun-disk NEE with one shadow ray (2 RNG draws)."""

from __future__ import annotations

import torch

from nebulae_tpu_torch.core import brdf
from nebulae_tpu_torch.core import rng as nrng
from nebulae_tpu_torch.core.math import clip, dot
from nebulae_tpu_torch.tracer.sorting import DEAD_ORIGIN


def shade_direct(scene: dict, gbuf: dict, sun, any_fn, rng_state):
    """Returns (radiance [N, 3], new rng_state)."""
    n = gbuf["normal_s"]
    v = gbuf["view"]
    rng_state, u1 = nrng.next_float(rng_state)
    rng_state, u2 = nrng.next_float(rng_state)
    l = brdf.sun_disk_sample(u1, u2, sun.direction[None, :], sun.tan_half_angle)
    n_dot_l = clip(dot(n, l, False), 0.0, 1.0)
    f = brdf.eval_brdf(n, v, l, gbuf["albedo"], gbuf["roughness"], gbuf["metalness"])
    origin = brdf.offset_ray_origin(gbuf["position"], gbuf["normal_g"])
    shoot = gbuf["hit"] & (n_dot_l > 0.0)
    origin_sh = torch.where(shoot[..., None], origin, DEAD_ORIGIN)
    occluded = any_fn(origin_sh.detach().contiguous(), l.detach().contiguous())
    vis = torch.where(shoot & ~occluded, 1.0, 0.0)
    radiance = f * (n_dot_l * vis)[..., None] * sun.radiance[None, :]
    return torch.where(gbuf["hit"][..., None], radiance + gbuf["emissive"], 0.0), rng_state
