"""ACES filmic tonemapping (Hill's fitted RRT+ODT), elementwise.

Same arithmetic as `nebulae_tpu/passes/tonemap.py`: the 3x3 colour
transforms are unrolled to multiply-adds instead of matmuls, on tensors
(`aces_tonemap`) or NumPy arrays (`aces_tonemap_np`).
"""

from __future__ import annotations

import numpy as np
import torch

_ACES_IN = (
    (0.59719, 0.35458, 0.04823),
    (0.07600, 0.90834, 0.01566),
    (0.02840, 0.13383, 0.83777),
)

_ACES_OUT = (
    (1.60475, -0.53108, -0.07367),
    (-0.10208, 1.10813, -0.00605),
    (-0.00327, -0.07276, 1.07602),
)


def _mat3(m, r, g, b):
    return (
        r * m[0][0] + g * m[0][1] + b * m[0][2],
        r * m[1][0] + g * m[1][1] + b * m[1][2],
        r * m[2][0] + g * m[2][1] + b * m[2][2],
    )


def _rrt_odt_fit(v):
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return a / b


def aces_tonemap(hdr):
    """[..., 3] linear HDR -> [..., 3] display-linear in [0, 1]."""
    v = _mat3(_ACES_IN, hdr[..., 0], hdr[..., 1], hdr[..., 2])
    v = [_rrt_odt_fit(c) for c in v]
    v = _mat3(_ACES_OUT, *v)
    return torch.clamp(torch.stack(v, dim=-1), 0.0, 1.0)


def aces_tonemap_np(hdr):
    """aces_tonemap on a NumPy array (float32)."""
    hdr = np.asarray(hdr, np.float32)
    v = _mat3(_ACES_IN, hdr[..., 0], hdr[..., 1], hdr[..., 2])
    v = [_rrt_odt_fit(c) for c in v]
    v = _mat3(_ACES_OUT, *v)
    return np.clip(np.stack(v, axis=-1), 0.0, 1.0)
