"""Frame orchestration: G-buffer, path trace, SVGF and ACES in one call.

Counterpart of `nebulae_tpu/engine/renderer.py` (`init_frame_state`,
`render_frame` and the `Renderer` with its runtime API: `render`,
`update_geometry`, `update_instances`, `resize`, `update_config`).
PyTorch runs eagerly, so the frame is a plain function; the frame state is
a dict of tensors plus the frame counter and the history-reset flag as
Python values.  `pack_scene_tables` routes a scene to its traversal tables
branch for branch as the JAX Renderer does (one fat4 or fat2 table, paged,
tri-chunked, subtree-chunked or one-node).
The frame's phases run under `record_function` ranges named
"nebulae/<phase>" (gbuffer, pathtrace, svgf, tonemap), so a profiler trace
can attribute device time to them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from nebulae_tpu_torch.bvh.cbuilder import build_bvh_for
from nebulae_tpu_torch.bvh.refit import (
    compute_levels, refit_bvh, repack_fat4_bounds, repack_fat_bounds, repack_node_bounds, repack_tris,
)
from nebulae_tpu_torch.config import RenderConfig, SunLight
from nebulae_tpu_torch.core import brdf
from nebulae_tpu_torch.core import rng as nrng
from nebulae_tpu_torch.core.math import cross, dot, luminance, normalize
from nebulae_tpu_torch.core.scene import FlatScene, to_tensors, transform_instances
from nebulae_tpu_torch.device import resolve_device
from nebulae_tpu_torch.kernels import chunks as kc
from nebulae_tpu_torch.kernels.trace import (
    empty_tables, grouped_tri_ids, pack_bvh_fat, pack_bvh_fat4, pack_bvh_nodes, tables_to,
)
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


def pack_scene_tables(bvh, tri_pos: np.ndarray, cfg: RenderConfig) -> tuple[str, dict]:
    """(route, packed numpy tables) for a scene, by the JAX Renderer's rules
    (`nebulae_tpu/engine/renderer.py:342-421`):

      "single"  one fat4 table (bvh_wide=4) or fat2 table (bvh_wide=2): up
                to SINGLE_TABLE_MAX_TRIS triangles, or for fat4 under
                "auto" while JAX's padded table bytes fit
                SINGLE_TABLE_MAX_BYTES;
      "paged"   one fat4 table walked by the K6a wrappers: "auto" past the
                byte gate when the scene is over 3 chunks of
                MAX_CHUNK_TRIS, or chunk_mode="paged" at any size;
      "tri"     whole-tree nodes and triangle chunks (K6b), for "tri" above
                SINGLE_TABLE_MAX_TRIS when pack_bvh_tri_chunks packs them;
      "subtree" subtree chunk tables (fat4 or fat2), for the other
                large-scene cases and for every large fat2 scene;
      "node"    one-node tables (K8) when the root is a leaf.

    The byte gate, paging and triangle chunks are fat4's only, as in JAX.
    The tables carry "paged" (True on the paged route only)."""
    t_count = int(tri_pos.shape[0])
    g = cfg.bvh_tri_group
    wide4 = cfg.bvh_wide == 4
    pack_fat = pack_bvh_fat4 if wide4 else pack_bvh_fat
    mode = cfg.chunk_mode
    if mode == "auto":
        mode = "subtree" if -(-t_count // kc.MAX_CHUNK_TRIS) <= 3 else "paged"
    cand = None
    if t_count > kc.SINGLE_TABLE_MAX_TRIS and wide4 and cfg.chunk_mode == "auto":
        cand = pack_bvh_fat4(bvh, tri_pos, g)
        if cand is not None and kc.jax_table_bytes(cand) <= kc.SINGLE_TABLE_MAX_BYTES:
            return "single", {**cand, "paged": False}
    if mode == "paged" and wide4:
        full = cand if cand is not None else pack_bvh_fat4(bvh, tri_pos, g)
        if full is not None:
            return "paged", {**full, "paged": True}
    if t_count > kc.SINGLE_TABLE_MAX_TRIS:
        tri = kc.pack_bvh_tri_chunks(bvh, tri_pos, g) if mode == "tri" and wide4 else None
        if tri is not None:
            return "tri", {**tri, "paged": False}
        chunks = kc.pack_bvh_chunks(bvh, tri_pos, tri_group=g, wide=cfg.bvh_wide)
        return "subtree", {"chunks": chunks, "paged": False}
    fat = pack_fat(bvh, tri_pos, g)
    if fat is not None:
        return "single", {**fat, "paged": False}
    return "node", {**pack_bvh_nodes(bvh, tri_pos, g), "paged": False}


def init_frame_state(cfg: RenderConfig, device) -> dict:
    """SVGF history, frame counter and history-reset flag."""
    check_supported(cfg)
    return {
        "svgf": init_history(cfg.height, cfg.width, device),
        "frame": 0,
        "reset_history": True,
    }


def render_frame(scene: dict, tables: dict | None, sun: SunLight, cam: dict, state: dict,
                 cfg: RenderConfig, device=None):
    """One frame.  `scene` (to_tensors of device_arrays), `tables` (a
    route's traversal tables, or None), `sun` and `cam` live on `device`
    (CUDA unless "cpu" is asked for).  Returns (outputs, new_state):
    outputs hold 'ldr' and, unless cfg.lean_outputs, 'hdr', 'denoised'
    and the G-buffer.  Called under grad with material tables or sun
    leaves that require it, the outputs carry their gradients (hits and
    textures are detached, as in JAX); `Renderer.render` calls it under
    no_grad."""
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
    build with a FlatScene, call `.render(camera)` per frame.  `route`
    names the tables' route (see pack_scene_tables; "empty" for a scene
    without triangles, None without tables).  `bvh` is the tables' FlatBVH
    on the host (its topology; a refit keeps it), `node_lo` / `node_hi`
    its bounds on the device, which `update_geometry` refits."""

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
        self.tables = self.route = self.bvh = self.node_lo = self.node_hi = None
        if needs_tables:
            if t_count == 0:
                self.route, packed = "empty", empty_tables()
            else:
                if bvh is None:
                    bvh = build_bvh_for(self.device, flat_scene.tri_pos, max_leaf=cfg.bvh_max_leaf)
                self.bvh = bvh
                self.node_lo = torch.tensor(np.asarray(bvh.node_lo, np.float32), device=self.device)
                self.node_hi = torch.tensor(np.asarray(bvh.node_hi, np.float32), device=self.device)
                self.route, packed = pack_scene_tables(bvh, flat_scene.tri_pos, cfg)
            self.tables = tables_to(packed, self.device)
        # Instance table and base triangles for update_instances.
        self._instance_of_tri = None
        if flat_scene.instance_of_tri is not None:
            self._instance_of_tri = torch.as_tensor(np.asarray(flat_scene.instance_of_tri)).to(self.device)
            self._base_tri_pos = self.scene["tri_pos"].clone()
            self._base_tri_nrm = self.scene["tri_nrm"].clone()
        self._refit = None
        self.sun = (sun if sun is not None else SunLight.default(self.device)).to(self.device)
        self.state = init_frame_state(cfg, self.device)
        self._last_cam = None

    def reset_history(self):
        self.state["reset_history"] = True

    def resize(self, width: int, height: int):
        """Reallocate the per-resolution state (the SVGF history and the
        frame counter) at a new size; the scene, tables and sun stay."""
        self.cfg = dataclasses.replace(self.cfg, width=width, height=height)
        self.state = init_frame_state(self.cfg, self.device)

    def update_config(self, cfg: RenderConfig):
        """Swap the configuration between frames.  A resolution change
        goes through `resize`; the tables stay as packed."""
        if (cfg.width, cfg.height) != (self.cfg.width, self.cfg.height):
            raise ValueError("update_config cannot change resolution; use resize()")
        check_supported(cfg)
        self.cfg = cfg

    @torch.no_grad()
    def update_instances(self, transforms):
        """Move rigid instances: per-instance 3x4 transforms [I, 3, 4] map
        the base (load-time) triangles and normals, then update_geometry
        refits.  Needs a scene built with FlatScene.instance_of_tri."""
        if self._instance_of_tri is None:
            raise ValueError("scene has no instance table (FlatScene.instance_of_tri); "
                             "use update_geometry for free-form motion")
        pos, nrm = transform_instances(self._base_tri_pos, self._base_tri_nrm, self._instance_of_tri,
                                       transforms)
        self.update_geometry(pos, tri_nrm=nrm)

    @torch.no_grad()
    def update_geometry(self, tri_pos, tri_nrm=None):
        """Dynamic scene: new world triangles [T, 3, 3] (and optionally
        vertex normals [T, 3, 3]) with the same topology.  Rewrites the
        scene's triangle rows, refits the BVH bounds and the route's tables
        in place, on the device.  A chunked scene ("tri" or "subtree") is
        first repacked to the "paged" route, as JAX does; a chunked fat2
        scene raises NotImplementedError.  The scene's AABB keeps its
        build-time value, so motion should stay inside it."""
        if self.route in ("tri", "subtree"):
            self._route_chunked_to_paged()
        if self._refit is None:
            self._refit = self._build_refit()
        pos = torch.as_tensor(tri_pos, dtype=torch.float32).to(self.device)
        nrm = None if tri_nrm is None else torch.as_tensor(tri_nrm, dtype=torch.float32).to(self.device)
        self._refit(pos, nrm)

    def _route_chunked_to_paged(self):
        """Replace chunked tables by one fat4 table on the paged route,
        packed from the build-time tree and the current triangles."""
        if self.cfg.bvh_wide != 4:
            raise NotImplementedError("refit over chunked fat2 tables is not supported; "
                                      "use bvh_wide=4 or rebuild the Renderer")
        packed = pack_bvh_fat4(self.bvh, self.scene["tri_pos"].cpu().numpy(), self.cfg.bvh_tri_group)
        if packed is None:
            raise RuntimeError("paged repack failed: the BVH root is a leaf")
        self.tables = tables_to({**packed, "paged": True}, self.device)
        self.route = "paged"
        self._refit = None

    def _build_refit(self):
        """The refit for the current table structure: its host-static
        levels and slot maps go to the device once."""
        dev = self.device

        def to_dev(x):
            return torch.as_tensor(np.asarray(x, np.int64)).to(dev)

        plan = None
        if self.bvh is not None:
            b = self.bvh
            plan = {
                "topo": {k: to_dev(getattr(b, k)) for k in ("node_first", "node_count", "node_right", "tri_index")},
                "levels": [to_dev(level) for level in compute_levels(b)],
                "max_leaf": int(np.asarray(b.node_count).max(initial=0)),
                "slot_tri": to_dev(grouped_tri_ids(b, int(self.tables["tris"].shape[1]))),
            }
            if "fat4nodes" in self.tables:
                plan["fat4_slots"] = to_dev(self.tables["fat4_slots"])
            elif "fatnodes" in self.tables:
                plan["inner_idx"] = to_dev(self.tables["inner_idx"])

        def refit(pos, nrm):
            scene = self.scene
            t = pos.shape[0]
            e1 = pos[:, 1] - pos[:, 0]
            e2 = pos[:, 2] - pos[:, 0]
            fn = normalize(cross(e1, e2))
            # Geometric normals follow the average shading normal's side.
            shade = scene["tri_nrm"] if nrm is None else nrm
            flip = dot(fn, shade.mean(dim=1), keepdims=False) < 0.0
            fn = torch.where(flip[:, None], -fn, fn)
            geom = scene["tri_geom"].clone()
            fast = scene["tri_fast"].clone()
            geom[:, 0:3] = pos[:, 0]
            geom[:, 3:6] = e1
            geom[:, 6:9] = e2
            fast[:, 9:12] = fn
            if nrm is not None:
                geom[:, 9:18] = nrm.reshape(t, 9)
                fast[:, 0:9] = nrm.reshape(t, 9)
                scene["tri_nrm"] = nrm
            scene.update(tri_pos=pos, tri_face_nrm=fn, tri_geom=geom, tri_fast=fast)
            if plan is None:
                return
            lo, hi = refit_bvh(plan["topo"], pos, plan["levels"], plan["max_leaf"])
            self.node_lo, self.node_hi = lo, hi
            tabs = self.tables
            repack_tris(tabs["tris"], pos, plan["slot_tri"])
            if "fat4nodes" in tabs:
                repack_fat4_bounds(tabs["fat4nodes"], lo, hi, plan["fat4_slots"])
            elif "fatnodes" in tabs:
                repack_fat_bounds(tabs["fatnodes"], lo, hi, plan["inner_idx"], plan["topo"]["node_right"])
            else:
                repack_node_bounds(tabs["nodes"], lo, hi)

        return refit

    @torch.no_grad()
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
