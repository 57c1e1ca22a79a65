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
"nebulae/<phase>" (gbuffer, pathtrace, svgf, tonemap; with the neural
radiance cache nrc_train, then nrc_query in place of pathtrace), so a
profiler trace can attribute device time to them; inside svgf,
"nebulae/svgf_reproject" spans the history's warp when the camera moved.
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
from nebulae_tpu_torch.dist.comm import all_reduce_sum
from nebulae_tpu_torch.kernels import chunks as kc
from nebulae_tpu_torch.kernels.trace import (
    empty_tables, grouped_tri_ids, pack_bvh_fat, pack_bvh_fat4, pack_bvh_nodes, tables_to,
)
from nebulae_tpu_torch.nrc.cache import init_cache, make_optimizer, query_cache
from nebulae_tpu_torch.passes.direct import shade_direct
from nebulae_tpu_torch.passes.gbuffer import camera_rays, make_camera_arrays, render_gbuffer
from nebulae_tpu_torch.passes.nrc_pathtrace import path_trace_nrc_query, path_trace_nrc_train
from nebulae_tpu_torch.passes.pathtrace import path_trace
from nebulae_tpu_torch.passes.svgf import init_history, reproject_history, svgf_denoise
from nebulae_tpu_torch.passes.tonemap import aces_tonemap
from nebulae_tpu_torch.tracer.trace import make_tracer


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


def init_frame_state(cfg: RenderConfig, device, world=None) -> dict:
    """SVGF history, frame counter and history-reset flag, and with
    cfg.enable_nrc the cache state (init_cache(seed=0)).  On a rank of
    `world` the history holds the rank's rows."""
    r0, r1 = (0, cfg.height) if world is None else world.rows(cfg.height)
    state = {
        "svgf": init_history(r1 - r0, cfg.width, device),
        "frame": 0,
        "reset_history": True,
    }
    if cfg.enable_nrc:
        state["nrc"] = init_cache(seed=0, device=device)
    return state


def nrc_train_frame(scene, sun, closest_fn, any_fn, cache_state, cam, frame: int, cfg: RenderConfig):
    """The cache's training for one frame: the reduced-resolution training
    pass and its optimizer steps.  Returns (new cache state, loss)."""
    return path_trace_nrc_train(scene, sun, closest_fn, any_fn, cfg, cache_state,
                                make_optimizer(cfg.nrc_learning_rate), cam, frame)


def trace_samples(scene: dict, gbuf: dict, sun: SunLight, cam: dict, closest_fn, any_fn, rng_state,
                  cfg: RenderConfig, cache_params=None, nrc_aux: dict | None = None, world=None):
    """The frame's cfg.spp samples from the G-buffer `gbuf`: path traced
    (or direct-lit without GI) and averaged.  Returns (radiance [N, 3],
    rng_state).  With cfg.jitter_primary each sample first draws its
    sub-pixel offset (2 draws, before the path's draws: the draw-order
    contract of core.brdf), traces its own jittered G-buffer (one more
    primary closest-hit walk) and shows the sky along its own missed rays;
    `gbuf` then only guides SVGF and the outputs.  With GI and
    `cache_params` each sample is the NRC query pass, and the last
    sample's counters go into `nrc_aux`.  On a rank of `world` the
    G-buffer holds the rank's rows."""
    w, h = cfg.width, cfg.height
    rows = (0, h) if world is None else world.rows(h)
    acc = torch.zeros((gbuf["ray_d"].shape[0], 3), dtype=torch.float32, device=gbuf["ray_d"].device)
    for _ in range(cfg.spp):
        sample_gbuf = gbuf
        if cfg.jitter_primary:
            rng_state, jx = nrng.next_float(rng_state)
            rng_state, jy = nrng.next_float(rng_state)
            o_j, d_j = camera_rays(cam, w, h, jitter=torch.stack([jx, jy], -1), rows=rows)
            sample_gbuf = render_gbuffer(scene, closest_fn, o_j, d_j, world=world,
                                         image_hw=(rows[1] - rows[0], w) if cfg.texture_mips else None)
        if cfg.enable_gi and cache_params is not None:
            sample, rng_state, aux = path_trace_nrc_query(scene, sample_gbuf, sun, closest_fn, any_fn, rng_state,
                                                          cfg, cache_params)
            if nrc_aux is not None:
                nrc_aux.update(aux)
        elif cfg.enable_gi:
            sample, rng_state = path_trace(scene, sample_gbuf, sun, closest_fn, any_fn, rng_state, cfg)
        else:
            sample, rng_state = shade_direct(scene, sample_gbuf, sun, any_fn, rng_state)
        if cfg.jitter_primary:
            sky = brdf.sky_eval(sample_gbuf["ray_d"], sun, scene, cfg)
            sample = torch.where(sample_gbuf["hit"][..., None], sample, sky)
        acc = acc + sample
    return acc / cfg.spp, rng_state


def render_frame(scene: dict, tables: dict | None, sun: SunLight, cam: dict, state: dict,
                 cfg: RenderConfig, device=None, world=None):
    """One frame.  `scene` (to_tensors of device_arrays), `tables` (a
    route's traversal tables, or None), `sun` and `cam` live on `device`
    (CUDA unless "cpu" is asked for).  Returns (outputs, new_state):
    outputs hold 'ldr', 'nrc_loss' and 'nrc_query_frac' and, unless
    cfg.lean_outputs, 'hdr', 'denoised', the G-buffer and under
    cfg.nrc_debug the cache's debug view.  Called under grad with material
    tables or sun leaves that require it, the outputs carry their
    gradients (hits and textures are detached, as in JAX); `Renderer.render`
    calls it under no_grad.  With GI and cfg.enable_nrc the cache trains
    first (once a frame, without gradient), then the query pass reads the
    new state's EMA parameters, detached.

    On a rank of `world` (dist.mesh.World) the frame is the rank's rows
    (world.rows(cfg.height)): the state's SVGF history and every image
    output hold those rows, each pixel keeps its RNG stream, the stencils
    read their halo from the ranks that own it (passes/svgf.py), and
    nrc_query_frac is the share of the whole image.  Every rank trains the
    radiance cache on the same inputs, so the caches stay equal."""
    dev = resolve_device(device)
    w, h_img = cfg.width, cfg.height
    r0, h = 0, h_img
    if world is not None:
        r0, r1 = world.rows(h_img)
        h = r1 - r0
    closest_fn, any_fn = make_tracer(scene, tables, cfg, device=dev)

    with record_function("nebulae/gbuffer"):
        o, d = camera_rays(cam, w, h_img, rows=(r0, r0 + h))
        gbuf = render_gbuffer(scene, closest_fn, o, d, image_hw=(h, w) if cfg.texture_mips else None, world=world)

    new_state = dict(state)
    nrc = cfg.enable_gi and cfg.enable_nrc
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    nrc_loss, cache_params, nrc_aux = zero, None, {}
    if nrc:
        with record_function("nebulae/nrc_train"):
            new_state["nrc"], nrc_loss = nrc_train_frame(scene, sun, closest_fn, any_fn, state["nrc"], cam,
                                                         state["frame"], cfg)
        cache_params = [{k: t.detach() for k, t in layer.items()} for layer in new_state["nrc"]["ema_params"]]

    with record_function("nebulae/nrc_query" if nrc else "nebulae/pathtrace"):
        ys, xs = torch.meshgrid(
            torch.arange(r0, r0 + h, device=dev), torch.arange(w, device=dev), indexing="ij"
        )
        rng_state = nrng.init_rng(xs.reshape(-1), ys.reshape(-1), w, state["frame"])
        radiance, _rng_state = trace_samples(scene, gbuf, sun, cam, closest_fn, any_fn, rng_state, cfg,
                                             cache_params, nrc_aux, world)
        if not cfg.jitter_primary:
            # Primary misses show the sky (with jitter each sample composited
            # the sky along its own ray).
            sky = brdf.sky_eval(gbuf["ray_d"], sun, scene, cfg)
            radiance = torch.where(gbuf["hit"][..., None], radiance, sky)

    img = radiance.reshape(h, w, 3)
    depth = gbuf["depth"].reshape(h, w)
    normal = gbuf["normal_s"].reshape(h, w, 3)
    hit = gbuf["hit"].reshape(h, w)

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
                    with record_function("nebulae/svgf_reproject"):
                        warped, valid = reproject_history(
                            hist, gbuf["position"].reshape(h, w, 3), state["svgf"]["prev_viewproj"],
                            w, h_img, prev_eye=state["svgf"]["prev_eye"], current_depth=depth, world=world,
                        )
                        warped["depth"] = torch.where(valid, warped["depth"], -1e9)
                    hist = warped
            denoised, new_hist = svgf_denoise(img, depth, normal, hist, cfg, hit=hit, world=world)
            new_hist["prev_viewproj"] = cam["viewproj"]
            new_hist["prev_eye"] = cam["eye"]
            new_state["svgf"] = new_hist
    else:
        denoised = img
    new_state["frame"] = int(state["frame"]) + 1
    new_state["reset_history"] = False

    with record_function("nebulae/tonemap"):
        ldr = aces_tonemap(denoised) if cfg.enable_tonemap else denoised
    query_frac = nrc_aux["query_frac"] if nrc else zero
    if nrc and world is not None:
        query_frac = all_reduce_sum(world, nrc_aux["query_set"].float().sum(), "query_count") / (h_img * w)
    if cfg.lean_outputs:
        return {"ldr": ldr, "nrc_loss": nrc_loss, "nrc_query_frac": query_frac}, new_state
    outputs = {
        "hdr": img,
        "denoised": denoised,
        "ldr": ldr,
        "depth": depth,
        "normal": normal,
        "albedo": gbuf["albedo"].reshape(h, w, 3),
        "hit": hit,
        "nrc_loss": nrc_loss,
        "nrc_query_frac": query_frac,
    }
    if cfg.nrc_debug is not None and nrc:
        # The last sample's counters, or the cache (before this frame's
        # training) seen at the primary hits.
        if cfg.nrc_debug == "bounce_heatmap":
            outputs["nrc_debug"] = nrc_aux["n_vert"].reshape(h, w)
        elif cfg.nrc_debug == "query_bounce":
            outputs["nrc_debug"] = nrc_aux["term_bounce"].reshape(h, w)
        elif cfg.nrc_debug == "cache_view":
            surf0 = {k: gbuf[k] for k in ("position", "normal_s", "albedo", "roughness", "metalness")}
            pred = query_cache(state["nrc"]["ema_params"], surf0, gbuf["view"], scene["aabb_min"],
                               scene["aabb_max"], learn_irradiance=cfg.nrc_learn_irradiance)
            outputs["nrc_debug"] = torch.where(gbuf["hit"][..., None], pred, 0.0).reshape(h, w, 3)
        else:
            raise ValueError(f"unknown nrc_debug mode: {cfg.nrc_debug!r}")
    return outputs, new_state


class Renderer:
    """Owns the scene tensors, traversal tables, sun and frame state:
    build with a FlatScene, call `.render(camera)` per frame.  `route`
    names the tables' route (see pack_scene_tables; "empty" for a scene
    without triangles, None without tables).  `bvh` is the tables' FlatBVH
    on the host (its topology; a refit keeps it), `node_lo` / `node_hi`
    its bounds on the device, which `update_geometry` refits.  `env_map`
    (a lat-long [H, W, 3] float32 map) becomes scene["env_map"] on the
    device, the sky that cfg.enable_envmap shows, as JAX's app sets it.
    `world` is None here; dist.runner.DistRenderer renders a rank's rows."""

    world = None

    def __init__(self, flat_scene: FlatScene, cfg: RenderConfig, sun: SunLight | None = None,
                 bvh=None, device=None, env_map=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scene = to_tensors(flat_scene.device_arrays(), self.device)
        if env_map is not None:
            self.scene["env_map"] = torch.as_tensor(np.asarray(env_map, np.float32)).to(self.device)
        t_count = flat_scene.num_triangles
        needs_tables = cfg.tracer in ("pallas", "bvh") or (
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
        self.state = init_frame_state(cfg, self.device, self.world)
        self._last_cam = None

    def reset_history(self):
        self.state["reset_history"] = True

    def resize(self, width: int, height: int):
        """Reallocate the per-resolution state (the SVGF history and the
        frame counter) at a new size; the scene, tables, sun and the NRC
        cache stay."""
        nrc = self.state.get("nrc")
        self.cfg = dataclasses.replace(self.cfg, width=width, height=height)
        self.state = init_frame_state(self.cfg, self.device, self.world)
        if nrc is not None:
            self.state["nrc"] = nrc

    def update_config(self, cfg: RenderConfig):
        """Swap the configuration between frames.  A resolution change
        goes through `resize`; the tables stay as packed.  Turning NRC on
        creates a cache where the state holds none."""
        if (cfg.width, cfg.height) != (self.cfg.width, self.cfg.height):
            raise ValueError("update_config cannot change resolution; use resize()")
        self.cfg = cfg
        if cfg.enable_nrc and "nrc" not in self.state:
            self.state["nrc"] = init_cache(seed=0, device=self.device)

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
            cam, self.state, self.cfg, device=self.device, world=self.world,
        )
        return outputs
