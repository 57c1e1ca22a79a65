"""The neural radiance cache on every traversal route and width, and after
a refit, in the port on the CPU, held to the port's single-table frame, to
a rebuild and to JAX.

The scene is tests/test_torch_routes.py's chunk-forced textured scene
(utils.testscenes.textured_scene, ~5k triangles, its bench camera) at
48x48, 4 bounces, SVGF and ACES, the cache on; every renderer starts from
JAX's init_cache(seed=0) carried across (interop.nrc_state_from_arrays).
The chunk limits are shrunk with monkeypatch on both packages, as there.
  * Each route against the single table from one cache: paged (K6a),
    triangle chunks (K6b), subtree chunks (K6c), one fat2 table (K7) and
    fat2 subtree chunks.  The hit mask equal; paged bit for bit, nrc_loss,
    nrc_query_frac and a digest of the trained cache included; the others
    at the NRC tolerance of tests/test_torch_nrc_frame.py (ldr on >= 99%
    of pixels within rtol 1e-2 / atol 1e-3, nrc_loss to a relative 1e-3,
    nrc_query_frac within 0.5%).
  * The box scene (its BVH root is a leaf) with tracer="pallas": the
    one-node tables and K8's plain walks against the brute-force frame,
    the cache on, at the NRC tolerance.
  * update_instances with the cache (tests/test_torch_refit.py's move:
    instance 1 turns 0.3 rad and rises 0.12 extents) on the fat4 table,
    the fat2 table and the subtree route (repacked to paged): the state
    keeps its cache and the scene its build-time AABB, and the frame
    equals a Renderer rebuilt on the moved triangles (same AABB, same
    cache) at the NRC tolerance with the hit mask equal.  On the subtree
    route the same move against JAX's update_instances and NRC frame (on
    the CPU JAX's auto tracer is its XLA walk, which reads no chunk
    table), at the NRC tolerance, with the turned tangents written into
    JAX's tri_geom (its refit keeps the load-time ones); a chunked fat2 scene raises
    NotImplementedError in both packages.
  * A 32x32 NRC train step on the triangle-chunk route against the single
    table: loss to a relative 1e-3, each gradient at a cosine >= 0.999
    (tests/test_torch_nrc_step.py's tolerances).
"""

import dataclasses
import hashlib

import jax
import numpy as np
import pytest
import torch
from test_torch_nrc_options import assert_nrc_frame_close
from test_torch_nrc_options import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_refit import _transforms
from test_torch_routes import _patch_limits

S = 48
KW = dict(width=S, height=S, max_bounces=4, enable_svgf=True, enable_tonemap=True, bucket_scheduling=False,
          enable_nrc=True)
CHUNKED = {"SINGLE_TABLE_MAX_TRIS": 1000, "MAX_CHUNK_TRIS": 2000}
# route name: (bvh_wide, chunk_mode, limits, expected Renderer.route)
ROUTES = {
    "single": (4, "auto", {}, "single"),
    "paged": (4, "paged", {}, "paged"),
    "tri": (4, "tri", {"SINGLE_TABLE_MAX_TRIS": 1000, "TRI_CHUNK_TABLE_BUDGET": "small"}, "tri"),
    "subtree": (4, "subtree", CHUNKED, "subtree"),
    "fat2": (2, "auto", {}, "single"),
    "fat2_subtree": (2, "subtree", CHUNKED, "subtree"),
}


@pytest.fixture(scope="module")
def setup():
    from nebulae_tpu.nrc.cache import init_cache

    from nebulae_tpu_torch.utils.testscenes import bench_camera, textured_scene

    fs = textured_scene(seed=0)
    return {"fs": fs, "cam": bench_camera(fs), "cache": jax.tree.map(np.asarray, init_cache(seed=0))}


def _renderer(setup, route, **extra):
    """A port Renderer on `route` (its limits patched while it packs) with
    JAX's initial cache."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.interop import nrc_state_from_arrays

    fs = setup["fs"]
    wide, mode, limits, expect = ROUTES[route]
    with pytest.MonkeyPatch.context() as mp:
        _patch_limits(mp, limits, fs.tri_pos)
        r = Renderer(fs, RenderConfig(**{**KW, **extra, "bvh_wide": wide, "chunk_mode": mode}), device="cpu")
    assert r.route == expect
    r.state["nrc"] = nrc_state_from_arrays(setup["cache"], "cpu")
    return r


def _frame(r, cam):
    return {k: v.numpy() for k, v in r.render(cam).items()}


def cache_digest(cache) -> str:
    """sha256 over every tensor of a cache state (params, EMA, Adam's
    moments) and its step count."""
    h = hashlib.sha256(str(int(cache["opt_state"]["count"])).encode())
    for group in (cache["params"], cache["ema_params"], cache["opt_state"]["mu"], cache["opt_state"]["nu"]):
        for layer in group:
            for k in ("w", "b"):
                h.update(layer[k].contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def single(setup):
    r = _renderer(setup, "single")
    out = _frame(r, setup["cam"])
    return {"out": out, "cache": cache_digest(r.state["nrc"])}


# ---------------------------------------------------------------------------
# Routes and widths against the single table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["paged", "tri", "subtree", "fat2", "fat2_subtree"])
def test_nrc_route_frame_matches_single_table(setup, single, route):
    r = _renderer(setup, route)
    if route in ("tri", "subtree", "fat2_subtree"):
        assert len(r.tables.get("tri_chunks", r.tables.get("chunks", []))) >= 2
    if route.startswith("fat2"):
        tabs = r.tables["chunks"] if route == "fat2_subtree" else [r.tables]
        assert any("fatnodes" in t for t in tabs) and not any("fat4nodes" in t for t in tabs)
    out = _frame(r, setup["cam"])
    ref = single["out"]
    if route == "paged":
        for k in ("hit", "hdr", "denoised", "ldr", "depth", "normal", "albedo", "nrc_loss", "nrc_query_frac"):
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
        assert cache_digest(r.state["nrc"]) == single["cache"]
    else:
        assert_nrc_frame_close(out, ref, f"{route} against the single table")
    assert float(out["nrc_query_frac"]) > 0.0


def test_nrc_root_leaf_scene_renders_through_k8(setup, monkeypatch):
    """The 12-triangle box with tracer="pallas" takes the one-node tables:
    K8's plain walks run in both NRC passes, and the frame matches the
    brute-force frame from the same cache."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.interop import nrc_state_from_arrays
    from nebulae_tpu_torch.kernels import trace as kt
    from nebulae_tpu_torch.utils.testscenes import bench_camera, box_scene

    calls = {"closest": 0, "any": 0}
    for name, plain in (("closest", kt.closest_hit_node_plain), ("any", kt.any_hit_node_plain)):
        def counted(*a, _plain=plain, _name=name, **k):
            calls[_name] += 1
            return _plain(*a, **k)
        monkeypatch.setattr(kt, f"{name}_hit_node_plain", counted)
    fs = box_scene()
    cam = bench_camera(fs)
    outs = {}
    for tracer in ("pallas", "bruteforce"):
        r = Renderer(fs, RenderConfig(**KW, tracer=tracer), device="cpu")
        assert (r.route == "node") == (tracer == "pallas")
        r.state["nrc"] = nrc_state_from_arrays(setup["cache"], "cpu")
        outs[tracer] = _frame(r, cam)
        if tracer == "pallas":
            # The query pass: primary closest, K8 closest + any at each later
            # vertex, the last vertex's shadow; the training pass as many
            # again over its longer paths.
            assert calls["closest"] > KW["max_bounces"] and calls["any"] > KW["max_bounces"], calls
            n = dict(calls)
    assert calls == n  # brute force walks no table
    assert 0.3 < outs["pallas"]["hit"].mean() < 1.0
    assert_nrc_frame_close(outs["pallas"], outs["bruteforce"], "box K8 against brute force")


# ---------------------------------------------------------------------------
# Refit with the cache
# ---------------------------------------------------------------------------


def _moves(fs):
    return _transforms(int(fs.instance_of_tri.max()) + 1, float((fs.aabb_max - fs.aabb_min).max()))


def _turned_tangents(fs) -> np.ndarray:
    """The scene's tangents with their xyz turned by hand by each
    instance's rotation in _moves, their w kept: [T, 12] rows of tri_geom."""
    rot = _moves(fs)[fs.instance_of_tri][:, :, :3].astype(np.float64)
    tan = fs.tri_tan.copy()
    tan[..., :3] = np.einsum("tij,tvj->tvi", rot, tan[..., :3])
    return tan.reshape(-1, 12)


def _refit(setup, route):
    """A route's renderer after update_instances: (renderer, frame)."""
    r = _renderer(setup, route)
    cache = r.state["nrc"]
    aabb = (r.scene["aabb_min"].clone(), r.scene["aabb_max"].clone())
    r.update_instances(_moves(setup["fs"]))
    assert r.state["nrc"] is cache
    assert torch.equal(r.scene["aabb_min"], aabb[0]) and torch.equal(r.scene["aabb_max"], aabb[1])
    assert r.route == ("paged" if route == "subtree" else ROUTES[route][3])
    return r, _frame(r, setup["cam"])


@pytest.mark.parametrize("route", ["single", "fat2", "subtree"])
def test_nrc_refit_matches_rebuild(setup, single, route):
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.interop import nrc_state_from_arrays

    r, out = _refit(setup, route)
    host = {k: r.scene[k].numpy() for k in ("tri_pos", "tri_nrm", "tri_tan", "tri_face_nrm")}
    moved = dataclasses.replace(setup["fs"], **host)  # the build-time AABB stays
    wide = ROUTES[route][0]
    rebuilt = Renderer(moved, RenderConfig(**KW, bvh_wide=wide), device="cpu")
    assert rebuilt.route == "single"
    rebuilt.state["nrc"] = nrc_state_from_arrays(setup["cache"], "cpu")
    for k in ("tri_geom", "tri_fast", "tri_face_nrm", "aabb_min", "aabb_max"):
        assert torch.equal(r.scene[k], rebuilt.scene[k]), k
    assert (out["ldr"] != single["out"]["ldr"]).any(-1).mean() > 0.01  # the scene moved
    assert_nrc_frame_close(out, _frame(rebuilt, setup["cam"]), f"{route} refit against a rebuild")


def test_nrc_refit_matches_jax(setup, single):
    """update_instances on the subtree route (both packages repack to
    paged), then an NRC frame from JAX's cache, against JAX's: the one JAX
    frame of this file (on the CPU JAX's auto tracer is its XLA walk over
    the whole tree, whatever the route, and each compile costs ~35 s).
    The port's single-table frame before the move differs from it."""
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.core.camera import Camera as JCamera
    from nebulae_tpu.core.scene import FlatScene as JFlatScene
    from nebulae_tpu.engine.renderer import Renderer as JRenderer

    fs, cam = setup["fs"], setup["cam"]
    with pytest.MonkeyPatch.context() as mp:
        _patch_limits(mp, CHUNKED, fs.tri_pos)
        jr = JRenderer(JFlatScene(**fs.field_arrays()), JCfg(**{**KW, "chunk_mode": "subtree"}))
    jaabb = (np.asarray(jr.scene["aabb_min"]), np.asarray(jr.scene["aabb_max"]))
    jr.update_instances(_moves(fs))
    # JAX's refit keeps the load-time tangents: its scene gets the turned
    # ones here, as the port's update_instances writes them.
    jr.scene["tri_geom"] = jr.scene["tri_geom"].at[:, 24:36].set(_turned_tangents(fs))
    assert "chunks" not in jr.bvh and "nrc" in jr.state
    np.testing.assert_array_equal(np.asarray(jr.scene["aabb_min"]), jaabb[0])
    np.testing.assert_array_equal(np.asarray(jr.scene["aabb_max"]), jaabb[1])
    j = {k: np.asarray(v) for k, v in jr.render(JCamera(eye=cam.eye, target=cam.target,
                                                         fov_y_deg=cam.fov_y_deg)).items()}
    r, out = _refit(setup, "subtree")
    np.testing.assert_allclose(r.scene["tri_pos"].numpy(), np.asarray(jr.scene["tri_pos"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(r.scene["tri_geom"].numpy(), np.asarray(jr.scene["tri_geom"]), rtol=1e-6, atol=1e-6)
    assert_nrc_frame_close(out, j, "subtree refit against JAX")
    assert (single["out"]["ldr"] != j["ldr"]).any(-1).mean() > 0.01


def test_nrc_refit_of_chunked_fat2_raises_in_both_packages(setup):
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.core.scene import FlatScene as JFlatScene
    from nebulae_tpu.engine.renderer import Renderer as JRenderer

    fs = setup["fs"]
    r = _renderer(setup, "fat2_subtree")
    with pytest.raises(NotImplementedError):
        r.update_instances(_moves(fs))
    assert r.route == "subtree" and "nrc" in r.state
    with pytest.MonkeyPatch.context() as mp:
        _patch_limits(mp, CHUNKED, fs.tri_pos)
        jr = JRenderer(JFlatScene(**fs.field_arrays()), JCfg(**{**KW, "bvh_wide": 2, "chunk_mode": "subtree"}))
    assert "chunks" in jr.bvh
    with pytest.raises(NotImplementedError):
        jr.update_instances(_moves(fs))


# ---------------------------------------------------------------------------
# The NRC train step on a chunked route
# ---------------------------------------------------------------------------


def test_nrc_train_step_on_tri_route_matches_single_table(setup):
    from nebulae_tpu_torch.engine.renderer import init_frame_state
    from nebulae_tpu_torch.engine.train import Adam, make_train_step, split_scene_params
    from nebulae_tpu_torch.interop import nrc_state_from_arrays
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays

    class RecordingAdam(Adam):
        def apply(self, params, grads, opt_state):
            self.grads = [g.detach().double() for g in grads]
            return super().apply(params, grads, opt_state)

    res = {}
    for route in ("single", "tri"):
        r = _renderer(setup, route, width=32, height=32)
        params, frozen = split_scene_params(r.scene)
        params["sun"] = r.sun
        opt = RecordingAdam()
        step, _ = make_train_step(r.cfg, frozen, r.tables, optimizer=opt, device="cpu")
        state = init_frame_state(r.cfg, "cpu")
        state["nrc"] = nrc_state_from_arrays(setup["cache"], "cpu")
        cam = make_camera_arrays(setup["cam"], 32, 32, "cpu")
        _, _, new_state, loss, _ = step(params, opt.init(params), cam, state, torch.full((32, 32, 3), 0.25))
        assert new_state["nrc"]["opt_state"]["count"] > 0
        res[route] = (float(loss), opt.grads)
    (lt, gt), (ls, gs) = res["tri"], res["single"]
    assert np.isfinite(lt) and abs(lt - ls) <= 1e-3 * abs(ls), (lt, ls)
    for a, b in zip(gt, gs):
        assert bool(torch.isfinite(a).all())
        if not bool(b.any()):
            assert not bool(a.any())
            continue
        cos = float(a.reshape(-1) @ b.reshape(-1) / (torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b)))
        assert cos >= 0.999, cos
