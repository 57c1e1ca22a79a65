"""Large-scene routes of the port's Renderer against nebulae_tpu, on the CPU.

  * K8's one-node tables and plain walks against pack_bvh_for_pallas and
    pallas_closest_hit / pallas_any_hit (interpret mode);
  * the route a scene takes (its tables' keys) against JAX's Renderer.bvh,
    for every chunk_mode and size class, with the limits shrunk on both;
  * 48x48 frames of a chunk-forced scene on each route against the
    single-table frame (paged bit for bit; tri and subtree with equal hit
    masks and >= 99% of pixels within rtol 1e-3 / atol 1e-4) and against
    JAX's frame (test_torch_frame.py's tolerances);
  * a root-leaf scene through K8 against the brute-force frame;
  * a 32x32 train step on a chunked route against the single-table route.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROUTE_KEYS = {"fat4nodes", "fatnodes", "tris", "tri_chunks", "chunks", "nodes"}
KW = dict(width=48, height=48, max_bounces=2, enable_svgf=True, enable_tonemap=True)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 1.2, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _soup(n_tris, seed, size=0.05):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 1.0, size=(n_tris, 1, 3))
    off = rng.normal(scale=size, size=(n_tris, 2, 3))
    return np.concatenate([base, base + off], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# K8: one-node tables and walks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tree", ["multi_node", "root_leaf"])
def test_one_node_tables_and_walks_match_jax(tree):
    from nebulae_tpu.bvh.builder import build_bvh as jbuild
    from nebulae_tpu.kernels import pallas_trace as pt

    from nebulae_tpu_torch.bvh.builder import build_bvh
    from nebulae_tpu_torch.kernels.trace import (
        any_hit_node, closest_hit_node, pack_bvh_nodes, tables_to,
    )

    tri = _soup(1500, 11) if tree == "multi_node" else _soup(12, 3, size=0.6)
    jbvh, pbvh = jbuild(tri, max_leaf=15), build_bvh(tri, max_leaf=15)
    assert (pbvh.node_count[0] > 0) == (tree == "root_leaf")
    jp = pt.pack_bvh_for_pallas(jbvh, tri, tri_group=8)
    pp = pack_bvh_nodes(pbvh, tri, 8)
    jn = jp["nodes"].transpose(0, 2, 1).reshape(-1, 8)
    n = pp["nodes"].shape[0]
    np.testing.assert_array_equal(pp["nodes"][:, :6], jn[:n, :6])
    np.testing.assert_array_equal(pp["nodes"][:, 6].view(np.int32).astype(np.float32), jn[:n, 6])
    assert pp["stack_depth"] <= 128
    tables = tables_to(pp, "cpu")
    jt = {k: jnp.asarray(v) for k, v in jp.items()}

    o, d = _rays(1024, 5)
    t_max = np.random.default_rng(2).uniform(0.0, 1.5, 1024).astype(np.float32)
    t_max[::3] = np.inf
    o[::17] = 1.0e14  # ejected lanes: no hit, no occlusion
    hit = {k: v.numpy() for k, v in closest_hit_node(_t(o), _t(d), tables, _t(t_max)).items()}
    ref = {k: np.asarray(v) for k, v in pt.pallas_closest_hit(
        jnp.asarray(o), jnp.asarray(d), jt, t_max=jnp.asarray(t_max), interpret=True).items()}
    m = ref["tri"] >= 0
    np.testing.assert_array_equal(hit["tri"] >= 0, m)
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(hit[k][m], ref[k][m], rtol=1e-5, atol=1e-6, err_msg=k)
    differ_t = m & (hit["t"] != ref["t"])
    np.testing.assert_array_equal(hit["tri"][differ_t], ref["tri"][differ_t])
    assert 0.1 < m.mean() < 0.9 and not m[::17].any()

    occ = any_hit_node(_t(o), _t(d), tables, _t(t_max)).numpy()
    ref_occ = np.asarray(pt.pallas_any_hit(jnp.asarray(o), jnp.asarray(d), jt,
                                           t_max=jnp.asarray(t_max), interpret=True))
    np.testing.assert_array_equal(occ, ref_occ)
    assert 0.05 < occ.mean() < 0.9 and not occ[::17].any()


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

# (limits on both packages, {chunk_mode: expected route}); the scene has
# 2528 triangles.  "fits": over the triangle gate, under the byte gate;
# "3 chunks" and "6 chunks": past both, with auto's chunk estimate on either
# side of 3.  "small" is a triangle-chunk budget of the nodes plus 48 KB.
CLASSES = {
    "small": ({}, {"auto": "single", "subtree": "single", "tri": "single", "paged": "paged"}),
    "fits": ({"SINGLE_TABLE_MAX_TRIS": 500},
             {"auto": "single", "subtree": "subtree", "tri": "subtree", "paged": "paged"}),
    "3_chunks": ({"SINGLE_TABLE_MAX_TRIS": 500, "SINGLE_TABLE_MAX_BYTES": 1, "MAX_CHUNK_TRIS": 900,
                  "TRI_CHUNK_TABLE_BUDGET": "small"},
                 {"auto": "subtree", "subtree": "subtree", "tri": "tri", "paged": "paged"}),
    "6_chunks": ({"SINGLE_TABLE_MAX_TRIS": 500, "SINGLE_TABLE_MAX_BYTES": 1, "MAX_CHUNK_TRIS": 450,
                  "TRI_CHUNK_TABLE_BUDGET": "small"},
                 {"auto": "paged", "subtree": "subtree", "tri": "tri", "paged": "paged"}),
}
CASES = [(c, m, 4) for c in CLASSES for m in ("auto", "subtree", "tri", "paged")]
CASES += [("fits", "auto", 2), ("3_chunks", "paged", 2), ("root_leaf", "auto", 4), ("root_leaf", "paged", 4)]


def _patch_limits(mp, limits, tri_pos):
    """Set the limits on both packages; a "small" triangle-chunk budget is
    the scene's fat4 nodes (JAX's padded bytes) plus 48 KB."""
    from nebulae_tpu.bvh.builder import build_bvh
    from nebulae_tpu.kernels import pallas_trace as pt

    from nebulae_tpu_torch.kernels import chunks as kc

    for name, value in limits.items():
        if value == "small":
            value = pt.pack_bvh_fat4(build_bvh(tri_pos, 15), tri_pos, 8)["fat4nodes"].nbytes + 48 * 1024
        mp.setattr(pt, name, value)
        mp.setattr(kc, name, value)


@pytest.fixture(scope="module")
def route_scene():
    from nebulae_tpu_torch.utils.testscenes import torus_field

    return torus_field(0, nx=1, nz=1, nu=40, nv=30, n_materials=1, map_size=8)


@pytest.mark.parametrize("size,mode,wide", CASES)
def test_route_keys_match_jax_renderer(route_scene, monkeypatch, size, mode, wide):
    """The port's tables carry the keys of JAX's Renderer.bvh on the same
    route, and "paged" exactly where JAX's make_tracer pages."""
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.core.scene import FlatScene as JFlatScene
    from nebulae_tpu.engine.renderer import Renderer as JRenderer
    from nebulae_tpu.kernels import pallas_trace as pt

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.utils.testscenes import box_scene

    fs = box_scene() if size == "root_leaf" else route_scene
    limits, expect = CLASSES.get(size, ({}, {mode: "node"}))
    _patch_limits(monkeypatch, limits, fs.tri_pos)
    kw = dict(width=16, height=16, tracer="pallas", chunk_mode=mode, bvh_wide=wide)
    jr = JRenderer(JFlatScene(**fs.field_arrays()), JCfg(**kw))
    pr = Renderer(fs, RenderConfig(**kw), device="cpu")
    jkeys = set(jr.bvh) & ROUTE_KEYS
    assert set(pr.tables) & ROUTE_KEYS == jkeys
    if "chunks" in jkeys:
        # Chunk tables of the scene's width (one-node on a single leaf).
        # JAX's pack_bvh_chunks binds its chunk size at definition, so the
        # shrunk limit cuts only the port's: the layouts compare, not the count.
        fat = {"fat4nodes" if wide == 4 else "fatnodes", "tris"}
        assert {k for c in jr.bvh["chunks"] for k in c} & ROUTE_KEYS - {"nodes"} == fat
        assert all(set(c) & ROUTE_KEYS in (fat, {"nodes", "tris"}) for c in pr.tables["chunks"])
        assert any(set(c) >= fat for c in pr.tables["chunks"])
    # JAX gates bytes, pages and cuts triangle chunks for fat4 only: a fat2
    # scene past the triangle gate takes subtree chunks.
    assert pr.route == (expect[mode] if wide == 4 else "subtree")
    # JAX's make_tracer (tracer/trace.py:266-308): chunk keys first, then
    # the paging rule over one fat4 table.
    jax_paged = not ({"tri_chunks", "chunks"} & jkeys) and "fat4nodes" in jr.bvh and (
        4 * (jr.bvh["fat4nodes"].size + jr.bvh["tris"].size) > pt.SINGLE_TABLE_MAX_BYTES
        or (mode == "paged" and jr.bvh["tris"].shape[0] % pt.PAGE_TILES == 0))
    assert pr.tables["paged"] == jax_paged
    if "tri_chunks" in jkeys:
        assert [(c["slot_lo"], c["slot_hi"]) for c in pr.tables["tri_chunks"]] == [
            (c.slot_lo, c.slot_hi) for c in jr.bvh["tri_chunks"]]


# ---------------------------------------------------------------------------
# Frames on each route
# ---------------------------------------------------------------------------

ROUTES = {
    "single": ("auto", {}),
    "paged": ("paged", {}),
    "tri": ("tri", {"SINGLE_TABLE_MAX_TRIS": 1000, "TRI_CHUNK_TABLE_BUDGET": "small"}),
    "subtree": ("subtree", {"SINGLE_TABLE_MAX_TRIS": 1000, "MAX_CHUNK_TRIS": 2000}),
}


def _port_renderer(fs, route, **extra):
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer

    mode, limits = ROUTES[route]
    with pytest.MonkeyPatch.context() as mp:
        _patch_limits(mp, limits, fs.tri_pos)
        r = Renderer(fs, RenderConfig(**{**KW, **extra, "chunk_mode": mode}), device="cpu")
    assert r.route == route
    return r


@pytest.fixture(scope="module")
def frames():
    """The 48x48 textured scene: the port's single-table frame and JAX's
    frame under chunk_mode="tri" with the triangle gate shrunk (on the CPU
    JAX's auto tracer is its XLA walk, which reads no chunk table)."""
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.core.camera import Camera as JCamera
    from nebulae_tpu.core.scene import FlatScene as JFlatScene
    from nebulae_tpu.engine.renderer import Renderer as JRenderer

    from nebulae_tpu_torch.utils.testscenes import bench_camera, textured_scene

    fs = textured_scene(seed=0)
    cam = bench_camera(fs)
    with pytest.MonkeyPatch.context() as mp:
        _patch_limits(mp, ROUTES["tri"][1], fs.tri_pos)
        jr = JRenderer(JFlatScene(**fs.field_arrays()), JCfg(**{**KW, "chunk_mode": "tri"}))
    assert "tri_chunks" in jr.bvh
    j = jr.render(JCamera(eye=cam.eye, target=cam.target, fov_y_deg=cam.fov_y_deg))
    single = _port_renderer(fs, "single").render(cam)
    return {"fs": fs, "cam": cam, "jax": {k: np.asarray(v) for k, v in j.items()},
            "single": {k: v.numpy() for k, v in single.items()}}


def _pixels_close(a, b, rtol, atol):
    return np.isclose(a, b, rtol=rtol, atol=atol).reshape(a.shape[0] * a.shape[1], -1).all(-1).mean()


@pytest.mark.parametrize("route", ["paged", "tri", "subtree"])
def test_route_frame_matches_single_table_and_jax(frames, route):
    r = _port_renderer(frames["fs"], route)
    n_chunks = len(r.tables.get("tri_chunks", r.tables.get("chunks", [])))
    assert n_chunks >= (2 if route != "paged" else 0)
    out = {k: v.numpy() for k, v in r.render(frames["cam"]).items()}
    single, jax_out = frames["single"], frames["jax"]
    np.testing.assert_array_equal(out["hit"], single["hit"])
    if route == "paged":
        for k in ("hdr", "denoised", "ldr", "depth", "normal", "albedo"):
            np.testing.assert_array_equal(out[k], single[k], err_msg=k)
    else:
        for k in ("hdr", "denoised", "ldr"):
            assert _pixels_close(out[k], single[k], 1e-3, 1e-4) >= 0.99, k
    # Against JAX: test_torch_frame.py's tolerances.
    np.testing.assert_array_equal(out["hit"], jax_out["hit"])
    assert jax_out["hit"].mean() > 0.3
    for k in ("hdr", "denoised", "ldr"):
        assert np.isfinite(out[k]).all(), k
        assert _pixels_close(out[k], jax_out[k], 1e-3, 1e-4) >= 0.99, k
    assert np.abs(out["ldr"] - jax_out["ldr"]).mean() < 1e-3


def test_root_leaf_scene_renders_through_k8(monkeypatch):
    """A 12-triangle box (the BVH root is a leaf) with tracer="pallas" takes
    the one-node tables and K8, and matches the brute-force frame."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
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
    k8 = Renderer(fs, RenderConfig(**KW, tracer="pallas"), device="cpu")
    brute = Renderer(fs, RenderConfig(**KW, tracer="bruteforce"), device="cpu")
    assert k8.route == "node" and "nodes" in k8.tables and brute.tables is None
    a = {k: v.numpy() for k, v in k8.render(cam).items()}
    # Primary closest, then per later vertex K8 closest + any (the combo),
    # then the last vertex's shadow ray.
    assert calls["closest"] == KW["max_bounces"] and calls["any"] == KW["max_bounces"]
    b = {k: v.numpy() for k, v in brute.render(cam).items()}
    np.testing.assert_array_equal(a["hit"], b["hit"])
    assert 0.3 < a["hit"].mean() < 1.0
    for k in ("hdr", "denoised", "ldr"):
        assert _pixels_close(a[k], b[k], 1e-3, 1e-4) >= 0.99, k


def test_train_step_on_chunked_route_matches_single_table(frames):
    """One 32x32 train step: the tri-chunked route's gradients equal the
    single-table route's to a relative 1e-6."""
    from nebulae_tpu_torch.engine.renderer import init_frame_state
    from nebulae_tpu_torch.engine.train import Adam, make_train_step, split_scene_params
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays

    class RecordingAdam(Adam):
        def apply(self, params, grads, opt_state):
            self.grads = [g.detach().double() for g in grads]
            return super().apply(params, grads, opt_state)

    grads = {}
    for route in ("single", "tri"):
        r = _port_renderer(frames["fs"], route, width=32, height=32)
        cfg = dataclasses.replace(r.cfg, width=32, height=32)
        params, frozen = split_scene_params(r.scene)
        params["sun"] = r.sun
        opt = RecordingAdam()
        step, _ = make_train_step(cfg, frozen, r.tables, optimizer=opt, device="cpu")
        cam = make_camera_arrays(frames["cam"], 32, 32, "cpu")
        target = torch.full((32, 32, 3), 0.25)
        step(params, opt.init(params), cam, init_frame_state(cfg, "cpu"), target)
        grads[route] = opt.grads
    for a, b in zip(grads["tri"], grads["single"]):
        assert float(torch.linalg.vector_norm(b)) > 0.0 or float(torch.linalg.vector_norm(a)) == 0.0
        rel = float(torch.linalg.vector_norm(a - b)) / max(float(torch.linalg.vector_norm(b)), 1e-30)
        assert rel <= 1e-6, rel
