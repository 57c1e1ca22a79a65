"""Ray-triangle test on torch tensors (the brute-force tracer).

Counterpart of `nebulae_tpu/tracer/intersect.py`: two-sided
Moller-Trumbore with EPS = 1e-7.  (The slab test lives in the kernels.)
"""

from __future__ import annotations

import torch

from nebulae_tpu_torch.core.math import cross

EPS = 1e-7


def ray_triangle(o, d, v0, e1, e2, t_min=EPS, t_max=float("inf")):
    """Batched two-sided Moller-Trumbore over broadcastable [..., 3] inputs.
    Returns (hit, t (inf on miss), u, v)."""
    pvec = cross(d, e2)
    det = e1[..., 0] * pvec[..., 0] + e1[..., 1] * pvec[..., 1] + e1[..., 2] * pvec[..., 2]
    inv_det = torch.where(torch.abs(det) < EPS, 0.0, 1.0 / torch.where(det == 0.0, 1.0, det))
    tvec = o - v0
    u = (tvec[..., 0] * pvec[..., 0] + tvec[..., 1] * pvec[..., 1] + tvec[..., 2] * pvec[..., 2]) * inv_det
    qvec = cross(tvec, e1)
    v = (d[..., 0] * qvec[..., 0] + d[..., 1] * qvec[..., 1] + d[..., 2] * qvec[..., 2]) * inv_det
    t = (e2[..., 0] * qvec[..., 0] + e2[..., 1] * qvec[..., 1] + e2[..., 2] * qvec[..., 2]) * inv_det
    hit = (
        (torch.abs(det) >= EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return hit, torch.where(hit, t, torch.full_like(t, float("inf"))), u, v
