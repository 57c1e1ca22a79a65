"""Frame orchestration: G-buffer, path trace, SVGF and ACES in one call.

Counterpart of `nebulae_tpu/engine/renderer.py` (`init_frame_state`,
`render_frame`, `Renderer.__init__` and `render`).  PyTorch runs eagerly,
so the frame is a plain function; the frame state is a dict of tensors
plus the frame counter and the history-reset flag as Python values.
The frame's phases run under `record_function` ranges named
"nebulae/<phase>" (gbuffer, pathtrace, svgf, tonemap), so a profiler trace
can attribute device time to them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from nebulae_tpu_torch.bvh.cbuilder import build_bvh_for
from nebulae_tpu_torch.config import RenderConfig, SunLight
from nebulae_tpu_torch.core import brdf
from nebulae_tpu_torch.core import rng as nrng
from nebulae_tpu_torch.core.math import luminance
from nebulae_tpu_torch.core.scene import FlatScene, to_tensors
from nebulae_tpu_torch.device import resolve_device
from nebulae_tpu_torch.kernels.trace import empty_tables, pack_bvh_fat4, tables_to
from nebulae_tpu_torch.passes.direct import shade_direct
from nebulae_tpu_torch.passes.gbuffer import camera_rays, make_camera_arrays, render_gbuffer
from nebulae_tpu_torch.passes.pathtrace import path_trace
from nebulae_tpu_torch.passes.svgf import init_history, reproject_history, svgf_denoise
from nebulae_tpu_torch.passes.tonemap import aces_tonemap
from nebulae_tpu_torch.tracer.trace import make_tracer


def check_supported(cfg: RenderConfig) -> None:
    """Raise NotImplementedError for configurations this port does not cover."""
    todo = {
        "enable_nrc": "ROADMAP Queue 1, item 9: neural radiance cache",
        "fast_bounce_shading": "ROADMAP Queue 1, item 5: fast shading",
        "enable_envmap": "ROADMAP Queue 1, item 14: environment-map sky",
        "jitter_primary": "ROADMAP Queue 1, item 4: primary jitter",
    }
    for name, item in todo.items():
        if getattr(cfg, name):
            raise NotImplementedError(f"{name}=True is not ported yet ({item})")
    if cfg.tracer == "bvh":
        raise NotImplementedError('tracer="bvh" is not ported (ROADMAP Queue 1, item 3)')


def init_frame_state(cfg: RenderConfig, device) -> dict:
    """SVGF history, frame counter and history-reset flag."""
    check_supported(cfg)
    return {
        "svgf": init_history(cfg.height, cfg.width, device),
        "frame": 0,
        "reset_history": True,
    }


@torch.no_grad()
def render_frame(scene: dict, tables: dict | None, sun: SunLight, cam: dict, state: dict,
                 cfg: RenderConfig, device=None):
    """One forward frame.  `scene` (to_tensors of device_arrays), `tables`
    (fat4 tables or None), `sun` and `cam` live on `device` (CUDA unless
    "cpu" is asked for).  Returns (outputs, new_state): outputs hold 'ldr'
    and, unless cfg.lean_outputs, 'hdr', 'denoised' and the G-buffer."""
    dev = resolve_device(device)
    check_supported(cfg)
    w, h = cfg.width, cfg.height
    n_pix = w * h
    closest_fn, any_fn = make_tracer(scene, tables, cfg, device=dev)

    with record_function("nebulae/gbuffer"):
        o, d = camera_rays(cam, w, h)
        gbuf = render_gbuffer(scene, closest_fn, o, d, image_hw=(h, w) if cfg.texture_mips else None)

    with record_function("nebulae/pathtrace"):
        ys, xs = torch.meshgrid(
            torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij"
        )
        rng_state = nrng.init_rng(xs.reshape(-1), ys.reshape(-1), w, state["frame"])
        acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
        for _ in range(cfg.spp):
            if cfg.enable_gi:
                sample, rng_state = path_trace(scene, gbuf, sun, closest_fn, any_fn, rng_state, cfg)
            else:
                sample, rng_state = shade_direct(scene, gbuf, sun, any_fn, rng_state)
            acc = acc + sample
        radiance = acc / cfg.spp
        sky = brdf.sky_eval(gbuf["ray_d"], sun, scene, cfg)
        radiance = torch.where(gbuf["hit"][..., None], radiance, sky)

    img = radiance.reshape(h, w, 3)
    depth = gbuf["depth"].reshape(h, w)
    normal = gbuf["normal_s"].reshape(h, w, 3)
    hit = gbuf["hit"].reshape(h, w)

    new_state = dict(state)
    if cfg.enable_svgf:
        with record_function("nebulae/svgf"):
            hist = state["svgf"]
            if state["reset_history"]:
                lum = luminance(img)
                hist = {
                    "radiance": img, "depth": depth, "normal": normal,
                    "moments": torch.stack([lum, lum * lum], -1),
                    "histlen": torch.zeros_like(hist["histlen"]),
                }
            else:
                hist = {k: hist[k] for k in ("radiance", "depth", "normal", "moments", "histlen")}
                same_cam = bool(
                    torch.equal(state["svgf"]["prev_viewproj"], cam["viewproj"])
                    and torch.equal(state["svgf"]["prev_eye"], cam["eye"])
                )
                if cfg.svgf_reproject and not same_cam:
                    warped, valid = reproject_history(
                        hist, gbuf["position"].reshape(h, w, 3), state["svgf"]["prev_viewproj"],
                        w, h, prev_eye=state["svgf"]["prev_eye"], current_depth=depth,
                    )
                    warped["depth"] = torch.where(valid, warped["depth"], -1e9)
                    hist = warped
            denoised, new_hist = svgf_denoise(img, depth, normal, hist, cfg, hit=hit)
            new_hist["prev_viewproj"] = cam["viewproj"]
            new_hist["prev_eye"] = cam["eye"]
            new_state["svgf"] = new_hist
    else:
        denoised = img
    new_state["frame"] = int(state["frame"]) + 1
    new_state["reset_history"] = False

    with record_function("nebulae/tonemap"):
        ldr = aces_tonemap(denoised) if cfg.enable_tonemap else denoised
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.lean_outputs:
        return {"ldr": ldr, "nrc_loss": zero, "nrc_query_frac": zero}, new_state
    outputs = {
        "hdr": img,
        "denoised": denoised,
        "ldr": ldr,
        "depth": depth,
        "normal": normal,
        "albedo": gbuf["albedo"].reshape(h, w, 3),
        "hit": hit,
        "nrc_loss": zero,
        "nrc_query_frac": zero,
    }
    return outputs, new_state


class Renderer:
    """Owns the scene tensors, traversal tables, sun and frame state:
    build with a FlatScene, call `.render(camera)` per frame."""

    def __init__(self, flat_scene: FlatScene, cfg: RenderConfig, sun: SunLight | None = None,
                 bvh=None, device=None):
        check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scene = to_tensors(flat_scene.device_arrays(), self.device)
        t_count = flat_scene.num_triangles
        needs_tables = cfg.tracer == "pallas" or (
            cfg.tracer == "auto" and t_count > cfg.bruteforce_max_tris
        )
        self.tables = None
        if needs_tables:
            if t_count == 0:
                packed = empty_tables()
            else:
                if bvh is None:
                    bvh = build_bvh_for(self.device, flat_scene.tri_pos, max_leaf=cfg.bvh_max_leaf)
                packed = pack_bvh_fat4(bvh, flat_scene.tri_pos, tri_group=cfg.bvh_tri_group)
                if packed is None:
                    raise NotImplementedError(
                        "a BVH whose root is a leaf needs the one-node kernels (ROADMAP Queue 2, K8)"
                    )
            self.tables = tables_to(packed, self.device)
        self.sun = (sun if sun is not None else SunLight.default(self.device)).to(self.device)
        self.state = init_frame_state(cfg, self.device)
        self._last_cam = None

    def reset_history(self):
        self.state["reset_history"] = True

    def render(self, camera, sun: SunLight | None = None) -> dict:
        fingerprint = (
            tuple(np.asarray(camera.eye, np.float32).tolist())
            + tuple(np.asarray(camera.target, np.float32).tolist())
            + (float(camera.fov_y_deg),)
        )
        moved = self._last_cam is not None and fingerprint != self._last_cam
        if moved and not self.cfg.svgf_reproject:
            self.reset_history()
        self._last_cam = fingerprint
        cam = make_camera_arrays(camera, self.cfg.width, self.cfg.height, self.device)
        outputs, self.state = render_frame(
            self.scene, self.tables, sun.to(self.device) if sun is not None else self.sun,
            cam, self.state, self.cfg, device=self.device,
        )
        return outputs
