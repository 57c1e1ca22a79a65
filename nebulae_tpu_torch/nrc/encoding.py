"""Input encodings of the neural radiance cache.

Counterpart of `nebulae_tpu/nrc/encoding.py`: the position, normalised by
the scene's AABB, gets a triangle-wave encoding at N_FREQ frequencies; the
shading normal and the view direction, mapped to octahedral coordinates,
get a one-blob encoding of N_BLOB bins per coordinate; roughness becomes
1 - exp(-r); albedo and specular F0 pass through.  All elementwise.
"""

from __future__ import annotations

import numpy as np
import torch

from nebulae_tpu_torch.core.math import clip, maximum, oct_encode

N_FREQ = 12  # triangle-wave frequencies per position axis
N_BLOB = 4  # one-blob bins per direction coordinate


def normalize_position(p, aabb_min, aabb_max):
    ext = maximum(aabb_max - aabb_min, 1e-6)
    return clip((p - aabb_min) / ext, 0.0, 1.0)


def triangle_wave_encode(x, n_freq: int = N_FREQ):
    """x in [0, 1] [..., D] -> [..., D * n_freq] triangle waves at 2^k."""
    outs = []
    for k in range(n_freq):
        v = x * (2.0 ** k)
        outs.append((2.0 * (v - torch.floor(v + 0.5))).abs())
    return torch.cat(outs, dim=-1)


def oneblob_encode(x, n_bins: int = N_BLOB):
    """x in [0, 1] [..., D] -> [..., D * n_bins] Gaussian one-blob."""
    centers = torch.from_numpy((np.arange(n_bins, dtype=np.float32) + 0.5) / n_bins).to(x.device)
    sigma = 1.0 / n_bins
    d = x[..., :, None] - centers
    blob = torch.exp(-0.5 * (d / sigma) ** 2)
    return blob.reshape(*x.shape[:-1], x.shape[-1] * n_bins)


def unit_to_01(d):
    """Unit vectors -> octahedral coordinates in [0, 1]^2."""
    return oct_encode(d) * 0.5 + 0.5


def encode_query(position, normal, view, roughness, albedo, specular, aabb_min, aabb_max):
    """The cache MLP's input [..., encoded_dim()] from a query record."""
    parts = [
        triangle_wave_encode(normalize_position(position, aabb_min, aabb_max)),
        oneblob_encode(unit_to_01(normal)),
        oneblob_encode(unit_to_01(view)),
        1.0 - torch.exp(-roughness[..., None]),
        albedo,
        specular,
    ]
    return torch.cat(parts, dim=-1)


def encoded_dim() -> int:
    return 3 * N_FREQ + 2 * 2 * N_BLOB + 1 + 3 + 3
