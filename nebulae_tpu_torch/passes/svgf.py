"""SVGF denoiser: temporal accumulation, reprojection and the a-trous cascade.

Counterpart of `nebulae_tpu/passes/svgf.py`; images are [H, W, C].  Each
a-trous pass is kernel K4 forward and K5 backward (`kernels/svgf.py`).  Where JAX skipped work
under `lax.cond` (the spatial-variance bootstrap once every pixel has 4
frames of history) the port takes the same branch on the host.

With a `world` (dist.mesh.World) the images are the rank's rows.  The
stencils then run on the rows padded with the halo they read (3 rows for
the variance bootstrap, 2 * (1 + 2 + ... + 2^(passes-1)) for the a-trous
cascade) from the ranks that own them, and are cropped back, so every
pixel sees what it sees in one process; at the image's real top and
bottom nothing is padded and the stencils' own edge handling applies.
Reprojection gathers the whole history (dist.comm).
"""

from __future__ import annotations

import torch

from nebulae_tpu_torch.core.math import luminance, powf, shift2d
from nebulae_tpu_torch.dist import comm
from nebulae_tpu_torch.kernels.svgf import atrous_step
from nebulae_tpu_torch.utils.profiling import span


def _finite_depth(depth, far=1e8):
    return torch.clamp(depth, max=far)


def svgf_temporal(radiance, depth, normal, hist_radiance, hist_depth, hist_normal,
                  hist_moments, cfg, histlen, world=None):
    """Temporal step -> (accum_radiance, moments, variance, new_histlen)."""
    dz = _finite_depth(depth) - _finite_depth(hist_depth)
    sigma = torch.clamp(0.02 * _finite_depth(depth), min=cfg.svgf_depth_sigma)
    w_depth = torch.exp(-(dz * dz) / (2.0 * sigma * sigma))
    w_normal = torch.clamp((normal * hist_normal).sum(-1), 0.0, 1.0)
    w = w_depth * w_normal
    alpha = cfg.svgf_temporal_alpha * w

    accum = radiance + (hist_radiance - radiance) * alpha[..., None]
    y = luminance(radiance)
    y_acc = y + (hist_moments[..., 0] - y) * alpha
    y2_acc = y * y + (hist_moments[..., 1] - y * y) * alpha
    variance = torch.clamp(y2_acc - y_acc * y_acc, min=cfg.svgf_variance_eps)
    new_histlen = torch.where(w > 0.5, histlen + 1.0, 1.0)

    short = new_histlen < 4.0
    with span("nebulae/sync/svgf_short"):
        any_short = bool(short.any()) if world is None else comm.any_rank(world, short.any())
    if any_short:
        # Spatial variance bootstrap: separable depth/normal-bilateral 7x7
        # estimate of the moments while history is short.
        z0, nrm, yb, top = _finite_depth(depth), normal, y, 0
        if world is not None:
            guides, top, _ = comm.exchange_rows(world, torch.cat([z0[..., None], nrm, yb[..., None]], -1), 3)
            z0, nrm, yb = (guides[..., a:b].squeeze(-1).contiguous() for a, b in ((0, 1), (1, 4), (4, 5)))

        def blur_axis(m1, m2, axis):
            sum_m1 = torch.zeros_like(m1)
            sum_m2 = torch.zeros_like(m2)
            sum_w = torch.zeros_like(m1)
            for o in range(-3, 4):
                dy, dx = (o, 0) if axis == 0 else (0, o)
                wz = torch.exp(
                    -torch.abs(z0 - shift2d(z0, dy, dx)) / max(cfg.svgf_phi_depth * 3.0, 1e-6)
                )
                wn = powf(
                    torch.clamp((nrm * shift2d(nrm, dy, dx)).sum(-1), 0.0, 1.0),
                    cfg.svgf_phi_normal,
                )
                ww = wz * wn
                sum_m1 = sum_m1 + shift2d(m1, dy, dx) * ww
                sum_m2 = sum_m2 + shift2d(m2, dy, dx) * ww
                sum_w = sum_w + ww
            denom = torch.clamp(sum_w, min=1e-6)
            return sum_m1 / denom, sum_m2 / denom

        m1s, m2s = blur_axis(yb, yb * yb, axis=1)
        m1s, m2s = blur_axis(m1s, m2s, axis=0)
        h = short.shape[0]
        var_spatial = torch.clamp(m2s - m1s * m1s, min=cfg.svgf_variance_eps)[top:top + h] * 4.0
        variance = torch.where(short, torch.maximum(variance, var_spatial), variance)

    moments = torch.stack([y_acc, y2_acc], dim=-1)
    return accum, moments, variance, new_histlen


def svgf_atrous(radiance, variance, depth, normal, cfg, world=None):
    """The a-trous cascade: passes at dilation 1, 2, 4, ... (kernel K4,
    differentiated by K5); variance stays fixed across passes.  As in JAX,
    the edge-stop guides are constants of the gradient: only radiance
    gets one."""
    phi = (cfg.svgf_phi_color, cfg.svgf_phi_normal, cfg.svgf_phi_depth)
    variance, depth, normal = variance.detach(), depth.detach(), normal.detach()
    h, top = radiance.shape[0], 0
    if world is not None:
        # Pass i reads 2 * 2^i rows each way: a pixel's output after the
        # cascade depends on the rows within 2 * (2^passes - 1) of it.
        band = 2 * ((1 << cfg.svgf_atrous_passes) - 1)
        guides, _, _ = comm.exchange_rows(world, torch.cat([variance[..., None], depth[..., None], normal], -1), band)
        radiance, top, _ = comm.exchange_rows(world, radiance, band)
        variance, depth, normal = (guides[..., a:b].squeeze(-1).contiguous() for a, b in ((0, 1), (1, 2), (2, 5)))
    out = radiance
    for i in range(cfg.svgf_atrous_passes):
        out, _ = atrous_step(out, variance, depth, normal, 1 << i, phi)
    return out[top:top + h]


def _bilinear_history_quad(stack, x, y):
    """Bilinear gather of a [H, W, C] history stack at float pixel coords
    x, y [h, W]; returns ([h, W, C], in_bounds [h, W])."""
    h, w, c = stack.shape
    in_bounds = (x >= -0.5) & (x <= w - 0.5) & (y >= -0.5) & (y <= h - 0.5)
    x0 = torch.clamp(torch.floor(x), 0, w - 1)
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
    x0i = x0.to(torch.int32).long()
    y0i = y0.to(torch.int32).long()
    quad = torch.cat(
        [stack, shift2d(stack, 0, -1), shift2d(stack, -1, 0), shift2d(stack, -1, -1)], dim=-1
    ).reshape(h * w, 4 * c)
    rows = quad[(y0i * w + x0i).reshape(-1)].reshape(x.shape + (4, c))
    c00, c01, c10, c11 = rows[..., 0, :], rows[..., 1, :], rows[..., 2, :], rows[..., 3, :]
    out = (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy
    return out, in_bounds


def reproject_history(history: dict, position, prev_viewproj, width: int, height: int,
                      prev_eye, current_depth, world=None):
    """Warp history through the previous view-projection: sample every
    history buffer bilinearly where this frame's points were last frame.
    Returns (warped dict, valid [H, W]).  On a rank of `world` the points
    and the history are its rows; a point may have been anywhere in the
    image, so the whole history is gathered first (10 floats a pixel)."""
    p = torch.cat([position, torch.ones(position.shape[:-1] + (1,), dtype=position.dtype,
                                        device=position.device)], -1)
    m = prev_viewproj
    clip = torch.stack(
        [p[..., 0] * m[i, 0] + p[..., 1] * m[i, 1] + p[..., 2] * m[i, 2] + p[..., 3] * m[i, 3]
         for i in range(4)], dim=-1,
    )
    w_c = clip[..., 3]
    safe_w = torch.where(torch.abs(w_c) < 1e-8, 1.0, w_c)
    ndc = clip[..., :3] / safe_w[..., None]
    x = (ndc[..., 0] * 0.5 + 0.5) * width - 0.5
    y = (0.5 - ndc[..., 1] * 0.5) * height - 0.5
    in_front = w_c > 1e-8
    stack = torch.cat(
        [history["radiance"], history["depth"][..., None], history["normal"],
         history["moments"], history["histlen"][..., None]], dim=-1,
    )
    if world is not None:
        stack = comm.all_gather_rows(world, stack, "history")
    warped_stack, ib = _bilinear_history_quad(stack, x, y)
    dep = warped_stack[..., 3]
    expected_prev = torch.linalg.vector_norm(position - prev_eye, dim=-1)
    dep = dep - expected_prev + _finite_depth(current_depth)
    warped = {
        "radiance": warped_stack[..., 0:3],
        "depth": dep,
        "normal": warped_stack[..., 4:7],
        "moments": warped_stack[..., 7:9],
        "histlen": warped_stack[..., 9],
    }
    return warped, ib & in_front


def svgf_denoise(radiance, depth, normal, history: dict, cfg, hit=None, world=None):
    """Temporal + a-trous; returns (denoised, new_history).  Miss pixels
    (hit False) bypass the filter."""
    accum, moments, variance, histlen = svgf_temporal(
        radiance, depth, normal, history["radiance"], history["depth"], history["normal"],
        history["moments"], cfg, histlen=history["histlen"], world=world,
    )
    out = svgf_atrous(accum, variance, depth, normal, cfg, world)
    if hit is not None:
        out = torch.where(hit[..., None], out, radiance)
    new_history = {
        "radiance": accum,
        "depth": _finite_depth(depth),
        "normal": normal,
        "moments": moments,
        "histlen": histlen,
    }
    return out, new_history


def init_history(height: int, width: int, device) -> dict:
    """Empty history: the infinite-depth mismatch resets the first frame."""
    return {
        "radiance": torch.zeros((height, width, 3), dtype=torch.float32, device=device),
        "depth": torch.full((height, width), 1e9, dtype=torch.float32, device=device),
        "normal": torch.zeros((height, width, 3), dtype=torch.float32, device=device),
        "moments": torch.zeros((height, width, 2), dtype=torch.float32, device=device),
        "histlen": torch.zeros((height, width), dtype=torch.float32, device=device),
        "prev_viewproj": torch.eye(4, dtype=torch.float32, device=device),
        "prev_eye": torch.zeros(3, dtype=torch.float32, device=device),
    }
