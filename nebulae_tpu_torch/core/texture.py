"""Bilinear sampling of the quad-packed material atlas, and sRGB conversion."""

from __future__ import annotations

import torch

from nebulae_tpu_torch.core.math import powf


def srgb_to_linear(c):
    """Exact piecewise sRGB EOTF on [0, 1] values."""
    lo = c / 12.92
    hi = powf((c + 0.055) / 1.055, 2.4)
    return torch.where(c <= 0.04045, lo, hi)


def linear_to_srgb(c):
    c = torch.clamp(c, 0.0, 1.0)
    lo = c * 12.92
    hi = 1.055 * powf(torch.clamp(c, min=1e-8), 1.0 / 2.4) - 0.055
    return torch.where(c <= 0.0031308, lo, hi)


def sample_bilinear_quad(quad_tex, tex_hw, tex_id, uv, row_off):
    """Bilinear sample with one row gather per lookup.

    quad_tex [R, 4C] uint8 rows, each holding a texel's 2x2 REPEAT-wrap
    neighbourhood (core.scene.quad_pack_atlas); row_off [K] int32 first row
    of each slot; tex_hw [K, 2] (h, w); tex_id [...]; uv [..., 2].
    Returns [..., C] float32."""
    n_slots = int(row_off.shape[0])
    tid = torch.clamp(tex_id, 0, max(n_slots - 1, 0)).long()
    hw = tex_hw[tid].long()
    h = hw[..., 0].to(torch.float32)
    w = hw[..., 1].to(torch.float32)
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]

    def wrap(i, n):
        return torch.where(i < 0, i + n, torch.where(i >= n, i - n, i))

    x0 = wrap(x0f.to(torch.int32).long(), hw[..., 1])
    y0 = wrap(y0f.to(torch.int32).long(), hw[..., 0])
    c4 = int(quad_tex.shape[-1])
    idx = row_off.long()[tid] + y0 * hw[..., 1] + x0
    rows = quad_tex[idx.reshape(-1)].reshape(*y0.shape, c4).to(torch.float32) / 255.0
    c = c4 // 4
    c00, c01, c10, c11 = rows[..., 0:c], rows[..., c: 2 * c], rows[..., 2 * c: 3 * c], rows[..., 3 * c:]
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy
