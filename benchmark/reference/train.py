"""The plain reference of the inverse-rendering step.

Each step renders the whole frame as reference.frame writes it out, with
the material tables (base colour, metallic, roughness, emissive) and the
sun's four fields (direction, radiance, disk tangent, sky colour) as the
leaves that carry gradients; hits, geometry and texels are constants, and
so are the a-trous weights.  The loss is the mean squared error of the
denoised image against the target; Adam (betas 0.9 and 0.999, eps 1e-8)
steps every leaf, then the materials are clamped to their ranges (base
colour and metallic to [0, 1], roughness to [0.02, 1], emissive to >= 0).
The SVGF history threads from step to step, detached, from a fresh start.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import frame as rf

MATERIALS = ("base", "metal", "rough", "emis")
SUN = ("sun_dir", "sun_rad", "sun_tan", "sky")
LEAVES = MATERIALS + SUN
NAMES = ("mat_base_color", "mat_metallic", "mat_roughness", "mat_emissive",
         "direction", "radiance", "tan_half_angle", "sky_color")


def loss_and_history(S: rf.RefScene, cam: dict, cfg: dict, frame: int, hist, target, rows=None):
    """(loss, next history) of one step's frame over the whole image;
    `rows` limits the loss to the image's first rows (a fault: part of the
    batch left out, the mean taken over the rest)."""
    width, height = int(cfg["width"]), int(cfg["height"])
    region = (0, height, 0, width)
    gb = rf.gbuffer(S, cam, width, height, region, mips=bool(cfg.get("texture_mips", True)))
    rng = rf.init_rng(gb["xs"], gb["ys"], width, frame)
    img = rf.path_trace(S, gb, cfg, rng).reshape(height, width, 3)
    depth = gb["depth"].reshape(height, width).to(S.dtype)
    normal = gb["normal_s"].reshape(height, width, 3)
    hit = gb["hit"].reshape(height, width)
    if hist is None:
        lum = rf.luminance(img)
        hist = {"radiance": img, "depth": depth, "normal": normal, "moments": torch.stack([lum, lum * lum], -1),
                "histlen": torch.zeros_like(depth)}
    accum, moments, variance, histlen = rf.svgf_temporal(img, depth, normal, hist, cfg)
    out = accum
    for i in range(int(cfg["svgf_atrous_passes"])):
        out = rf.atrous(out, variance, depth, normal, 1 << i, cfg)
    out = torch.where(hit[..., None], out, img)
    r = height if rows is None else rows
    loss = torch.mean((out[:r].float() - target[:r]) ** 2)
    nxt = {"radiance": accum, "depth": torch.clamp(depth, max=1e8), "normal": normal, "moments": moments,
           "histlen": histlen}
    return loss, {k: v.detach() for k, v in nxt.items()}


def follow(S: rf.RefScene, cam: dict, cfg: dict, target, steps: int, lr: float, rows=None) -> dict:
    """The first `steps` steps from the scene's own tables and sun.
    Returns each step's loss, the first step's gradient of each leaf, and
    each leaf's change over the steps (in NAMES order)."""
    leaves = [getattr(S, k).detach().float().clone() for k in LEAVES]
    start = [t.clone() for t in leaves]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    hist, losses, grad1 = None, [], None
    for k in range(steps):
        cur = [t.detach().requires_grad_(True) for t in leaves]
        for name, t in zip(LEAVES, cur):
            setattr(S, name, t.to(S.dtype))
        with torch.enable_grad():
            loss, hist = loss_and_history(S, cam, cfg, k, hist, target, rows)
            grads = torch.autograd.grad(loss, cur, allow_unused=True)
        grads = [torch.zeros_like(c) if g is None else g.float() for g, c in zip(grads, cur)]
        if grad1 is None:
            grad1 = [g.clone() for g in grads]
        losses.append(float(loss.detach()))
        t = k + 1
        new = []
        for i, (p, g) in enumerate(zip(cur, grads)):
            mu[i] = 0.9 * mu[i] + 0.1 * g
            nu[i] = 0.999 * nu[i] + 0.001 * g * g
            denom = torch.sqrt(nu[i]) / math.sqrt(1.0 - 0.999 ** t) + 1e-8
            new.append(p.detach() - (lr / (1.0 - 0.9 ** t)) * mu[i] / denom)
        new[0] = torch.clamp(new[0], 0.0, 1.0)
        new[1] = torch.clamp(new[1], 0.0, 1.0)
        new[2] = torch.clamp(new[2], 0.02, 1.0)
        new[3] = torch.clamp(new[3], min=0.0)
        leaves = new
    for name, t in zip(LEAVES, leaves):
        setattr(S, name, t.to(S.dtype))
    return {"losses": losses, "grad1": grad1, "delta": [a - b for a, b in zip(leaves, start)]}
