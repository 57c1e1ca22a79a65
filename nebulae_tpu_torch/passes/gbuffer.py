"""Primary-visibility G-buffer pass.

Counterpart of `nebulae_tpu/passes/gbuffer.py`.  The intersection (which
triangle, barycentrics, t) is detached; surface attributes keep the
material factors' gradients.  `blocked_closest` is not ported: it only
re-tiled rays into TPU packets and no per-ray output depends on it.
"""

from __future__ import annotations

import numpy as np
import torch

from nebulae_tpu_torch.core.math import normalize
from nebulae_tpu_torch.core.surface import has_textures, mip_level_from_uv, reconstruct_surface
from nebulae_tpu_torch.dist.comm import exchange_rows


def make_camera_arrays(camera, width: int, height: int, device) -> dict:
    """A Camera as tensors on `device` (eye, basis, tan_half, aspect, viewproj)."""
    right, up, fwd = camera.basis()
    view = camera.view_matrix()
    proj = camera.proj_matrix(width, height)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32)).to(device)

    return {
        "eye": t(camera.eye),
        "right": t(right),
        "up": t(up),
        "fwd": t(fwd),
        "tan_half": t(np.tan(np.deg2rad(camera.fov_y_deg) * 0.5)),
        "aspect": t(width / height),
        "viewproj": t(proj @ view),
    }


def camera_rays(cam: dict, width: int, height: int, jitter=None, rows=None):
    """Primary rays in row-major order: (o, d) [H*W, 3].  Through the pixel
    centres, or with `jitter` [H*W, 2] at (x + jx, y + jy) in each pixel.
    `rows` (r0, r1) makes the rays of global rows r0..r1-1 only, in the
    NDC of the whole image."""
    dev = cam["eye"].device
    r0, r1 = (0, height) if rows is None else rows
    ys, xs = torch.meshgrid(
        torch.arange(r0, r1, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    xs = xs.reshape(-1)
    ys = ys.reshape(-1)
    if jitter is None:
        jx = jy = 0.5
    else:
        jx, jy = jitter[..., 0], jitter[..., 1]
    u = ((xs + jx) / width * 2.0 - 1.0) * cam["tan_half"] * cam["aspect"]
    v = (1.0 - (ys + jy) / height * 2.0) * cam["tan_half"]
    d = u[:, None] * cam["right"][None] + v[:, None] * cam["up"][None] + cam["fwd"][None]
    d = normalize(d)
    o = cam["eye"].expand(d.shape)
    return o, d


def _mip_level(scene: dict, hit: dict, h: int, w: int, world):
    """mip_level_from_uv on an h x w block of rows.  On a rank of `world`
    the uv derivatives read one row past each interior edge of its rows:
    those rows' hits come from the ranks that own them."""
    if world is None:
        return mip_level_from_uv(scene, hit["tri"], hit["u"], hit["v"], h, w)
    tri = hit["tri"].to(torch.int32)
    packed = torch.stack([hit["u"], hit["v"], tri.view(torch.float32)], -1).reshape(h, w, 3)
    padded, top, bot = exchange_rows(world, packed, 1)
    flat = padded.reshape(-1, 3)
    mip = mip_level_from_uv(scene, flat[:, 2].contiguous().view(torch.int32), flat[:, 0], flat[:, 1],
                            top + h + bot, w)
    return mip[top * w:(top + h) * w]


def render_gbuffer(scene: dict, closest_fn, o, d, image_hw=None, world=None):
    """Trace primary rays -> G-buffer dict (flat [N, ...]).  `image_hw`
    (h, w) turns on per-pixel atlas mip selection; on a rank of `world`
    (dist.mesh.World) the rays are the rank's h rows of the image."""
    hit = {k: v.detach() for k, v in closest_fn(o.detach().contiguous(), d.detach().contiguous()).items()}
    valid = hit["tri"] >= 0
    mip = None
    if image_hw is not None and has_textures(scene):
        mip = _mip_level(scene, hit, image_hw[0], image_hw[1], world)
    surf = reconstruct_surface(scene, hit["tri"], hit["u"], hit["v"], view_dir=-d, mip_level=mip)
    vm = valid[..., None]
    return {
        "hit": valid,
        "depth": torch.where(valid, hit["t"], float("inf")),
        "position": torch.where(vm, surf["position"], 0.0),
        "normal_g": torch.where(vm, surf["normal_g"], 0.0),
        "normal_s": torch.where(vm, surf["normal_s"], 0.0),
        "albedo": torch.where(vm, surf["albedo"], 0.0),
        "roughness": torch.where(valid, surf["roughness"], 1.0),
        "metalness": torch.where(valid, surf["metalness"], 0.0),
        "emissive": torch.where(vm, surf["emissive"], 0.0),
        "view": -d,
        "ray_o": o,
        "ray_d": d,
    }
