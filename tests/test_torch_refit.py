"""Dynamic scenes of the port (BVH refit, Renderer.update_geometry,
update_instances, resize, update_config) against nebulae_tpu, on the CPU.

  (a) compute_levels and refit_bvh against JAX's after a deformation:
      levels equal, bounds bit-equal (min and max round nothing);
  (b) each repack (fat2, fat4, one-node, triangles) against JAX's
      repack_pallas_*, through interop.tables_from_arrays: bit-equal, with
      the enc and order-meta columns untouched, and the slot maps equal;
  (c) update_geometry on the single fat4, single fat2, paged and one-node
      routes, and on the subtree route (which it switches to paged): each
      frame equals a from-scratch rebuild on the same moved triangles at
      JAX's own tolerance (rtol 1e-4 / atol 1e-5, tests/test_refit.py),
      and differs from the frame before the move;
  (d) the port's refit frame against JAX's Renderer.update_geometry frame
      (tracer="pallas", interpret mode, 32x32);
  (e) update_instances against a baked rebuild, and transform_instances
      against JAX's;
  (f) the error cases: a chunked fat2 scene, a scene without instances;
  (g) resize and update_config.
"""

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

KW = dict(width=32, height=32, max_bounces=2, enable_svgf=False, enable_tonemap=False,
          tracer="pallas", bruteforce_max_tris=0)
FRAME_RTOL, FRAME_ATOL = 1e-4, 1e-5  # tests/test_refit.py:167


def _soup(n_tris, seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 1.0, size=(n_tris, 1, 3))
    off = rng.normal(scale=0.05, size=(n_tris, 2, 3))
    return np.concatenate([base, base + off], axis=1).astype(np.float32)


def _deform(tri_pos, ext):
    """A smooth shear and wave that keeps the topology."""
    moved = np.array(tri_pos, np.float32, copy=True)
    moved[..., 0] += np.float32(0.05 * ext) * np.sin(moved[..., 1] / np.float32(ext))
    moved[..., 1] += np.float32(0.04 * ext) * np.cos(moved[..., 0] / np.float32(ext))
    return moved


def _bvhs(tri, max_leaf=15):
    from nebulae_tpu.bvh.builder import build_bvh as jbuild

    from nebulae_tpu_torch.bvh.builder import build_bvh

    return jbuild(tri, max_leaf=max_leaf), build_bvh(tri, max_leaf=max_leaf)


def _jax_native():
    """JAX's native BVH builder loaded, never its numpy fallback: in a fresh
    checkout each test process runs `make -C native` at first use, and one
    that loads the library while another links it gets None, so retry."""
    from nebulae_tpu.bvh import cbuilder as jc

    for _ in range(40):
        if jc._load_lib() is not None:
            return
        jc._lib_tried = False
        time.sleep(0.5)
    raise AssertionError("JAX's native builder did not load (make -C native)")


def _jax_refit(jbvh, moved):
    from nebulae_tpu.bvh.refit import compute_levels, refit_bvh

    dev = {k: jnp.asarray(v) for k, v in jbvh.device_arrays().items()}
    lo, hi = refit_bvh(dev, jnp.asarray(moved), compute_levels(jbvh), max_leaf=int(jbvh.node_count.max()))
    return np.asarray(lo), np.asarray(hi)


def _port_refit(pbvh, moved):
    from nebulae_tpu_torch.bvh.refit import compute_levels, refit_bvh

    topo = {k: getattr(pbvh, k) for k in ("node_first", "node_count", "node_right", "tri_index")}
    lo, hi = refit_bvh(topo, torch.from_numpy(moved), compute_levels(pbvh),
                       int(pbvh.node_count.max()))
    return lo, hi


def test_refit_bounds_bit_equal_jax():
    from nebulae_tpu.bvh.refit import compute_levels as jlevels

    from nebulae_tpu_torch.bvh.refit import compute_levels

    tri = _soup(2000, 3)
    jbvh, pbvh = _bvhs(tri)
    jl, pl = jlevels(jbvh), compute_levels(pbvh)
    assert len(jl) == len(pl) > 5
    for a, b in zip(jl, pl):
        np.testing.assert_array_equal(a, b)
    # Unmoved: the builder's own bounds.
    lo, hi = _port_refit(pbvh, tri)
    np.testing.assert_array_equal(lo.numpy(), pbvh.node_lo)
    np.testing.assert_array_equal(hi.numpy(), pbvh.node_hi)
    moved = _deform(tri, 1.0)
    lo, hi = _port_refit(pbvh, moved)
    jlo, jhi = _jax_refit(jbvh, moved)
    np.testing.assert_array_equal(lo.numpy(), jlo)
    np.testing.assert_array_equal(hi.numpy(), jhi)
    assert not np.array_equal(jlo, pbvh.node_lo)


@pytest.mark.parametrize("layout,tri_group", [("fat2", 8), ("fat4", 8), ("nodes", 1)])
def test_repack_matches_jax(layout, tri_group):
    from nebulae_tpu.bvh import refit as jr
    from nebulae_tpu.kernels import pallas_trace as pt

    from nebulae_tpu_torch.bvh import refit as pr
    from nebulae_tpu_torch.interop import tables_from_arrays
    from nebulae_tpu_torch.kernels import trace as kt

    tri = _soup(2000, 7)
    jbvh, pbvh = _bvhs(tri)
    moved = _deform(tri, 1.0)
    jlo, jhi = _jax_refit(jbvh, moved)
    lo, hi = _port_refit(pbvh, moved)
    key = {"fat2": "fatnodes", "fat4": "fat4nodes", "nodes": "nodes"}[layout]
    if layout == "fat2":
        jp, pp = pt.pack_bvh_fat(jbvh, tri, tri_group), kt.pack_bvh_fat(pbvh, tri, tri_group)
        inner_idx = np.nonzero(jbvh.node_count == 0)[0]
        jn = jr.repack_pallas_fat_bounds(jnp.asarray(jp[key]), jlo, jhi, inner_idx, jbvh.node_right)
    elif layout == "fat4":
        jp, pp = pt.pack_bvh_fat4(jbvh, tri, tri_group), kt.pack_bvh_fat4(pbvh, tri, tri_group)
        n = pp[key].shape[0]
        np.testing.assert_array_equal(pp["fat4_slots"], jp["fat4_slots"][:n])
        assert (jp["fat4_slots"][n:] == -1).all() and (pp["fat4_slots"] == -1).any()
        jn = jr.repack_pallas_fat4_bounds(jnp.asarray(jp[key]), jlo, jhi, jp["fat4_slots"])
    else:
        jp, pp = pt.pack_bvh_for_pallas(jbvh, tri, tri_group), kt.pack_bvh_nodes(pbvh, tri, tri_group)
        jn = jr.repack_pallas_bounds(jnp.asarray(jp[key]), jlo, jhi)
    slot_tri = kt.grouped_tri_ids(pbvh, tri_group)
    j_slot_tri = pt.grouped_tri_ids(jbvh, tri_group)
    ns = slot_tri.shape[0]
    np.testing.assert_array_equal(slot_tri, j_slot_tri[:ns])
    assert (j_slot_tri[ns:] == -1).all()
    jt = jr.repack_pallas_tris(jnp.asarray(jp["tris"]), jnp.asarray(moved), j_slot_tri)
    want = tables_from_arrays({key: np.asarray(jn), "tris": np.asarray(jt)})

    tabs = kt.tables_to(pp, "cpu")
    before = {k: tabs[k].clone() for k in (key, "tris")}
    if layout == "fat2":
        pr.repack_fat_bounds(tabs[key], lo, hi, pp["inner_idx"], pbvh.node_right)
    elif layout == "fat4":
        pr.repack_fat4_bounds(tabs[key], lo, hi, pp["fat4_slots"])
    else:
        pr.repack_node_bounds(tabs[key], lo, hi)
    pr.repack_tris(tabs["tris"], torch.from_numpy(moved), slot_tri)
    for k in (key, "tris"):
        np.testing.assert_array_equal(tabs[k].numpy().view(np.int32), want[k].view(np.int32), err_msg=k)
        assert not torch.equal(tabs[k], before[k]), k
    # Enc and order-meta columns, and the triangle ids, stay as packed.
    meta = {"fatnodes": slice(12, 16), "fat4nodes": slice(24, 32), "nodes": slice(6, 8)}[key]
    assert torch.equal(tabs[key][:, meta], before[key][:, meta])
    assert torch.equal(tabs["tris"][..., 9], before["tris"][..., 9])
    # The repacked tables equal a fresh pack of the moved triangles over the
    # refit tree (its bounds, the build-time near order).
    moved_bvh = dataclasses.replace(pbvh, node_lo=lo.numpy(), node_hi=hi.numpy())
    fresh = {"fat2": kt.pack_bvh_fat, "fat4": kt.pack_bvh_fat4, "nodes": kt.pack_bvh_nodes}[layout](
        moved_bvh, moved, tri_group)
    np.testing.assert_array_equal(tabs["tris"].numpy(), fresh["tris"])
    cols = {"fatnodes": slice(0, 12), "fat4nodes": slice(0, 24), "nodes": slice(0, 6)}[key]
    np.testing.assert_array_equal(tabs[key][:, cols].numpy(), fresh[key][:, cols])


# ---------------------------------------------------------------------------
# Renderer.update_geometry on each route
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def textured():
    from nebulae_tpu_torch.utils.testscenes import bench_camera, textured_scene

    fs = textured_scene(seed=0)
    return fs, bench_camera(fs)


def _ext(fs):
    return float((fs.aabb_max - fs.aabb_min).max())


def _rebuild(fs, r):
    """A Renderer built from scratch on the refit renderer's own triangles,
    so that the geometry is bit-identical and only the BVH differs."""
    from nebulae_tpu_torch.engine.renderer import Renderer

    host = {k: r.scene[k].numpy() for k in ("tri_pos", "tri_nrm", "tri_face_nrm")}
    return Renderer(dataclasses.replace(fs, **host), r.cfg, device="cpu")


def _hdr(r, cam):
    from nebulae_tpu_torch.engine.renderer import init_frame_state

    r.state = init_frame_state(r.cfg, "cpu")  # same frame index and RNG as a fresh run
    return r.render(cam)["hdr"].numpy()


ROUTE_CASES = {
    "fat4": ({}, {}),
    "fat2": ({"bvh_wide": 2}, {}),
    "paged": ({"chunk_mode": "paged"}, {}),
    "node": ({}, {}),
    "subtree": ({"chunk_mode": "subtree"}, {"SINGLE_TABLE_MAX_TRIS": 1000, "MAX_CHUNK_TRIS": 2000}),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_update_geometry_matches_rebuild(textured, monkeypatch, case):
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.kernels import chunks as kc
    from nebulae_tpu_torch.utils.testscenes import bench_camera, box_scene

    extra, limits = ROUTE_CASES[case]
    for name, value in limits.items():
        monkeypatch.setattr(kc, name, value)
    if case == "node":
        fs = box_scene()
        cam = bench_camera(fs)
        moved = fs.tri_pos * np.float32(0.8) + np.float32([0.1, 0.05, 0.0])
    else:
        fs, cam = textured
        moved = _deform(fs.tri_pos, _ext(fs))
    r = Renderer(fs, RenderConfig(**KW, **extra), device="cpu")
    route = {"fat4": "single", "fat2": "single"}.get(case, case)
    assert r.route == route
    assert ("fatnodes" in r.tables) == (case == "fat2")
    img0 = _hdr(r, cam)
    tables = r.tables
    r.update_geometry(moved)
    if case == "subtree":
        assert r.route == "paged" and "chunks" not in r.tables and r.tables["paged"]
    else:
        assert r.route == route and r.tables is tables
    torch.testing.assert_close(r.scene["tri_pos"], torch.from_numpy(moved), rtol=0, atol=0)
    img = _hdr(r, cam)
    rebuilt = _rebuild(fs, r)
    assert rebuilt.route == route
    for k in ("tri_geom", "tri_fast", "tri_face_nrm"):
        assert torch.equal(r.scene[k], rebuilt.scene[k]), k
    assert np.abs(img - img0).max() > 1e-3  # the scene moved
    np.testing.assert_allclose(img, _hdr(rebuilt, cam), rtol=FRAME_RTOL, atol=FRAME_ATOL)
    # A second refit from the moved state back to the build-time triangles
    # gives the build-time frame.
    r.update_geometry(fs.tri_pos)
    np.testing.assert_allclose(_hdr(r, cam), img0, rtol=FRAME_RTOL, atol=FRAME_ATOL)


@pytest.mark.parametrize("wide", [4, 2])
def test_update_geometry_matches_jax(textured, wide):
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.core.camera import Camera as JCamera
    from nebulae_tpu.core.scene import FlatScene as JFlatScene
    from nebulae_tpu.engine.renderer import Renderer as JRenderer
    from nebulae_tpu.engine.renderer import init_frame_state as jinit

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.interop import tables_from_arrays

    fs, cam = textured
    kw = dict(KW, bvh_wide=wide)
    moved = _deform(fs.tri_pos, _ext(fs))
    _jax_native()
    jr = JRenderer(JFlatScene(**fs.field_arrays()), JCfg(**kw))
    assert ("fatnodes" in jr.bvh) == (wide == 2)
    # The port builds its own tree, which is JAX's native tree.
    r = Renderer(fs, RenderConfig(**kw), device="cpu")

    def assert_tables_equal():
        want = tables_from_arrays({k: np.asarray(v) for k, v in jr.bvh.items()})
        assert {"fatnodes", "fat4nodes"} & set(r.tables) == {"fatnodes", "fat4nodes"} & set(want)
        for k in {"fatnodes", "fat4nodes", "tris"} & set(want):
            np.testing.assert_array_equal(r.tables[k].numpy().view(np.int32), want[k].view(np.int32), err_msg=k)
        # The slot maps a refit reads, and the stack depth.
        for k in {"fat4_slots", "inner_idx"} & set(r.tables):
            np.testing.assert_array_equal(r.tables[k], want[k], err_msg=k)
        assert r.tables["stack_depth"] == want["stack_depth"]

    assert_tables_equal()
    jr.update_geometry(moved)
    jr.state = jinit(JCfg(**kw))
    j = {k: np.asarray(v) for k, v in jr.render(JCamera(eye=cam.eye, target=cam.target)).items()}
    r.update_geometry(moved)
    # The refit tables equal JAX's value for value.
    assert_tables_equal()
    np.testing.assert_array_equal(r.node_lo.numpy(), np.asarray(jr.bvh["node_lo"]))
    np.testing.assert_array_equal(r.node_hi.numpy(), np.asarray(jr.bvh["node_hi"]))
    for k in ("tri_pos", "tri_face_nrm", "tri_geom", "tri_fast"):
        np.testing.assert_allclose(r.scene[k].numpy(), np.asarray(jr.scene[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    p = r.render(cam)
    p = {k: v.numpy() for k, v in p.items()}
    np.testing.assert_array_equal(p["hit"], j["hit"])
    assert j["hit"].mean() > 0.3
    close = np.isclose(p["hdr"], j["hdr"], rtol=1e-3, atol=1e-4).all(-1).mean()
    assert np.isfinite(p["hdr"]).all() and close >= 0.99, close


# ---------------------------------------------------------------------------
# Instances
# ---------------------------------------------------------------------------


def _transforms(n_inst, ext):
    """Instance 1 rotates about y and slides up; the rest stay."""
    c, s = np.cos(0.3), np.sin(0.3)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    eye34 = np.concatenate([np.eye(3, dtype=np.float32), np.zeros((3, 1), np.float32)], axis=1)
    out = np.repeat(eye34[None], n_inst, axis=0)
    out[1] = np.concatenate([rot, [[0.0], [0.12 * ext], [0.0]]], axis=1)
    return out


def test_transform_instances_matches_jax(textured):
    from nebulae_tpu.core.scene import transform_instances as jtransform

    from nebulae_tpu_torch.core.scene import transform_instances

    fs, _ = textured
    assert fs.instance_of_tri is not None and fs.instance_of_tri.max() == 2  # two tori and the plane
    m = _transforms(3, _ext(fs))
    pos, nrm, _tan = transform_instances(torch.from_numpy(fs.tri_pos), torch.from_numpy(fs.tri_nrm),
                                         torch.from_numpy(fs.tri_tan), torch.from_numpy(fs.instance_of_tri), m)
    jpos, jnrm = jtransform(fs.tri_pos, fs.tri_nrm, fs.instance_of_tri, m)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(nrm.numpy(), np.asarray(jnrm), rtol=1e-6, atol=1e-6)
    still = fs.instance_of_tri != 1
    np.testing.assert_array_equal(pos.numpy()[still], fs.tri_pos[still])


def test_update_instances_matches_baked_rebuild(textured):
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.core.scene import face_normals
    from nebulae_tpu_torch.engine.renderer import Renderer

    fs, cam = textured
    ext = _ext(fs)
    cfg = RenderConfig(**KW)
    r = Renderer(fs, cfg, device="cpu")
    img0 = _hdr(r, cam)
    m = _transforms(int(fs.instance_of_tri.max()) + 1, ext)
    r.update_instances(m)
    img = _hdr(r, cam)
    assert np.abs(img - img0).max() > 1e-3  # it moved
    # Baked: instance 1's triangles, normals and tangents' xyz transformed by
    # hand, in float64 and rounded once, as update_instances does.
    moved, nrm, tan = fs.tri_pos.copy(), fs.tri_nrm.copy(), fs.tri_tan.copy()
    m1 = fs.instance_of_tri == 1
    m64 = m.astype(np.float64)
    moved[m1] = np.einsum("ij,tvj->tvi", m64[1, :, :3], moved[m1]) + m64[1, :, 3]
    nrm[m1] = np.einsum("ij,tvj->tvi", m64[1, :, :3], nrm[m1])
    tan[m1, :, :3] = np.einsum("ij,tvj->tvi", m64[1, :, :3], tan[m1, :, :3])
    baked = dataclasses.replace(fs, tri_pos=moved, tri_nrm=nrm, tri_tan=tan, tri_face_nrm=face_normals(moved, nrm))
    np.testing.assert_allclose(img, _hdr(Renderer(baked, cfg, device="cpu"), cam), rtol=FRAME_RTOL, atol=FRAME_ATOL)


# ---------------------------------------------------------------------------
# Errors, resize, update_config
# ---------------------------------------------------------------------------


def test_refit_error_cases(textured, monkeypatch):
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.kernels import chunks as kc
    from nebulae_tpu_torch.utils.testscenes import box_scene

    fs, _ = textured
    monkeypatch.setattr(kc, "SINGLE_TABLE_MAX_TRIS", 1000)
    monkeypatch.setattr(kc, "MAX_CHUNK_TRIS", 2000)
    r = Renderer(fs, RenderConfig(**KW, bvh_wide=2, chunk_mode="subtree"), device="cpu")
    assert r.route == "subtree" and all("fatnodes" in c or "nodes" in c for c in r.tables["chunks"])
    with pytest.raises(NotImplementedError):
        r.update_geometry(fs.tri_pos)
    assert r.route == "subtree"
    box = box_scene()
    assert box.instance_of_tri is None
    with pytest.raises(ValueError, match="instance"):
        Renderer(box, RenderConfig(**KW), device="cpu").update_instances(np.zeros((1, 3, 4), np.float32))


def test_resize_and_update_config(textured):
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer

    fs, cam = textured
    kw = dict(KW, enable_svgf=True, enable_tonemap=True)
    r = Renderer(fs, RenderConfig(**kw), device="cpu")
    r.render(cam)
    tables, sun, scene = r.tables, r.sun, r.scene
    r.resize(24, 16)
    assert (r.cfg.width, r.cfg.height) == (24, 16)
    assert r.tables is tables and r.sun is sun and r.scene is scene
    assert r.state["frame"] == 0
    out = r.render(cam)
    assert out["ldr"].shape == (16, 24, 3)
    fresh = Renderer(fs, RenderConfig(**{**kw, "width": 24, "height": 16}), device="cpu").render(cam)
    for k in ("hdr", "denoised", "ldr"):
        assert torch.equal(out[k], fresh[k]), k

    with pytest.raises(ValueError, match="resize"):
        r.update_config(RenderConfig(**kw))
    assert "nrc" not in r.state
    r.update_config(RenderConfig(**{**kw, "width": 24, "height": 16, "enable_nrc": True}))
    assert r.state["nrc"]["opt_state"]["count"] == 0  # turning the cache on creates one
    assert r.cfg.max_bounces == 2
    r.update_config(RenderConfig(**{**kw, "width": 24, "height": 16, "max_bounces": 1}))
    assert r.cfg.max_bounces == 1 and r.tables is tables
    out = r.render(cam)
    assert np.isfinite(out["ldr"].numpy()).all()
