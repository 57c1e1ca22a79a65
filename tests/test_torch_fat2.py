"""The port's fat2 tables and walks (K7, bvh_wide=2) against nebulae_tpu.

  (a) pack_bvh_fat against JAX's, through interop.tables_from_arrays:
      boxes bit-equal, enc and order meta equal as integers, tris equal;
      None at a root leaf;
  (b) the plain K7 walks against pallas_*_fat in interpret mode, with
      per-ray caps, dead rays and zero shadow caps: occ equal, tri equal
      wherever t differs, t within rtol 1e-5 (XLA contracts the interpreted
      Moller-Trumbore products into FMAs; ROADMAP Queue 3);
  (c) the plain K7 walks against the port's fat4 walks: t exact, tri equal
      except at exact t ties, and the fused walk equal to closest plus any;
  (d) pack_bvh_chunks(wide=2) against JAX's, chunk for chunk, and the
      chained fat2 walks against pallas_*_chunks;
  (e) a 48x48 bvh_wide=2 frame against JAX's bvh_wide=2 frame and against
      the port's bvh_wide=4 frame (test_torch_frame.py's tolerances);
  (f) a 48x48 bvh_wide=2 train step's gradients against the fat4 route's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

RTOL = 1e-5
KW = dict(width=48, height=48, max_bounces=2, enable_svgf=True, enable_tonemap=True)


def _soup(n_tris, seed, center=0.0, scale=1.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 1.0, size=(n_tris, 1, 3)) * scale + center
    off = rng.normal(scale=0.05, size=(n_tris, 2, 3))
    return np.concatenate([base, base + off], axis=1).astype(np.float32)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 1.2, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bvhs(tri, max_leaf=15):
    from nebulae_tpu.bvh.builder import build_bvh as jbuild

    from nebulae_tpu_torch.bvh.builder import build_bvh

    return jbuild(tri, max_leaf=max_leaf), build_bvh(tri, max_leaf=max_leaf)


def _assert_hits(out, ref, rtol, min_hit=0.1):
    out = {k: np.asarray(v) for k, v in out.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    hit = ref["tri"] >= 0
    np.testing.assert_array_equal(out["tri"] >= 0, hit)
    np.testing.assert_allclose(out["t"][hit], ref["t"][hit], rtol=rtol, atol=1e-6 if rtol else 0.0, err_msg="t")
    if rtol:
        # Barycentrics in [0, 1]: XLA's FMA contraction moves them by up to
        # ~6e-6 where o - v0 cancels (rays from afar), so an absolute bound.
        for k in ("u", "v"):
            np.testing.assert_allclose(out[k][hit], ref[k][hit], rtol=0.0, atol=1e-5, err_msg=k)
    differ_t = hit & (out["t"] != ref["t"])
    np.testing.assert_array_equal(out["tri"][differ_t], ref["tri"][differ_t])
    assert np.isinf(out["t"][~hit]).all()
    assert min_hit < hit.mean() < 0.95


def _assert_tables_equal(pp, jp):
    """The port's packed dict against tables_from_arrays of JAX's."""
    from nebulae_tpu_torch.interop import tables_from_arrays

    jt = tables_from_arrays(jp)
    for k in ("fatnodes", "fat4nodes", "nodes", "tris"):
        assert (k in pp) == (k in jt), k
        if k in pp:
            np.testing.assert_array_equal(pp[k].view(np.int32), jt[k].view(np.int32), err_msg=k)
    assert pp["stack_depth"] == jt["stack_depth"] <= 128


@pytest.fixture(scope="module")
def soup():
    from nebulae_tpu.kernels import pallas_trace as pt

    from nebulae_tpu_torch.kernels.trace import pack_bvh_fat, pack_bvh_fat4, tables_to

    tri = _soup(1500, 11)
    jbvh, pbvh = _bvhs(tri)
    jp = pt.pack_bvh_fat(jbvh, tri, tri_group=8)
    return {
        "tri": tri,
        "jax": {k: jnp.asarray(v) for k, v in jp.items()},
        "fat2": tables_to(pack_bvh_fat(pbvh, tri, 8), "cpu"),
        "fat4": tables_to(pack_bvh_fat4(pbvh, tri, 8), "cpu"),
    }


@pytest.mark.parametrize("tri_group", [1, 8])
def test_pack_bvh_fat_equals_jax(tri_group):
    from nebulae_tpu.kernels import pallas_trace as pt

    from nebulae_tpu_torch.kernels.trace import pack_bvh_fat

    tri = _soup(1500, 11)
    jbvh, pbvh = _bvhs(tri)
    pp = pack_bvh_fat(pbvh, tri, tri_group)
    _assert_tables_equal(pp, pt.pack_bvh_fat(jbvh, tri, tri_group=tri_group))
    np.testing.assert_array_equal(pp["inner_idx"], np.nonzero(pbvh.node_count == 0)[0])
    enc = pp["fatnodes"][:, 12:15].view(np.int32)
    assert ((enc[:, :2] & 31) >= 16).any() and ((enc[:, :2] & 31) < 16).any()
    assert set(np.unique(enc[:, 2])) <= set(range(6))
    assert not pp["fatnodes"][:, 15].any()
    # A root leaf packs no fat2 table, in both packages.
    box = _soup(6, 1)
    jb, pb = _bvhs(box)
    assert pack_bvh_fat(pb, box, tri_group) is None and pt.pack_bvh_fat(jb, box, tri_group=tri_group) is None


def _caps(n, seed):
    rng = np.random.default_rng(seed)
    t_b = np.where(rng.uniform(size=n) < 0.8, np.inf, rng.uniform(0.0, 0.8, n)).astype(np.float32)
    t_l = np.where(rng.uniform(size=n) < 0.8, 0.6, 0.0).astype(np.float32)
    return t_b, t_l


def _dead(o, d):
    o, d = o.copy(), d.copy()
    o[::17] = 1.0e14
    d[5::23] = 0.0
    return o, d


def test_plain_k7_matches_pallas_fat(soup):
    from nebulae_tpu.kernels import pallas_trace as pt

    from nebulae_tpu_torch.kernels.trace import any_hit_fat, closest_hit_fat, shadow_closest_fat

    o, d = _dead(*_rays(1024, 5))
    _, l = _rays(1024, 9)
    t_b, t_l = _caps(1024, 2)
    oj, dj, lj = jnp.asarray(o), jnp.asarray(d), jnp.asarray(l)
    tab, jt = soup["fat2"], soup["jax"]

    hit = closest_hit_fat(_t(o), _t(d), tab, _t(t_b))
    _assert_hits(hit, pt.pallas_closest_hit_fat(oj, dj, jt, t_max=jnp.asarray(t_b), interpret=True), RTOL)
    assert (hit["tri"].numpy()[::17] == -1).all()

    occ = any_hit_fat(_t(o), _t(l), tab, _t(t_l)).numpy()
    np.testing.assert_array_equal(occ, np.asarray(pt.pallas_any_hit_fat(oj, lj, jt, t_max=jnp.asarray(t_l),
                                                                         interpret=True)))
    assert 0.05 < occ.mean() < 0.9 and not occ[t_l == 0].any()

    h, s = shadow_closest_fat(_t(o), _t(d), _t(l), tab, _t(t_b), _t(t_l))
    jh, js = pt.pallas_shadow_closest_fat(oj, dj, lj, jt, t_max_b=jnp.asarray(t_b), t_max_l=jnp.asarray(t_l),
                                          interpret=True)
    _assert_hits(h, jh, RTOL)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert not s.numpy()[t_l == 0].any()


def test_plain_k7_matches_fat4_walks(soup):
    from nebulae_tpu_torch.kernels.trace import (
        any_hit_fat, any_hit_fat4, closest_hit_fat, closest_hit_fat4, shadow_closest_fat, shadow_closest_fat4,
    )

    o, d = _dead(*_rays(1024, 15))
    _, l = _rays(1024, 16)
    t_b, t_l = _caps(1024, 3)
    f2, f4 = soup["fat2"], soup["fat4"]
    hit = closest_hit_fat(_t(o), _t(d), f2, _t(t_b))
    _assert_hits(hit, closest_hit_fat4(_t(o), _t(d), f4, _t(t_b)), 0.0)
    occ = any_hit_fat(_t(o), _t(l), f2, _t(t_l))
    torch.testing.assert_close(occ, any_hit_fat4(_t(o), _t(l), f4, _t(t_l)), rtol=0, atol=0)
    h, s = shadow_closest_fat(_t(o), _t(d), _t(l), f2, _t(t_b), _t(t_l))
    _assert_hits(h, shadow_closest_fat4(_t(o), _t(d), _t(l), f4, _t(t_b), _t(t_l))[0], 0.0)
    # The fused walk is closest along d plus any along l.
    for k in ("t", "tri", "u", "v"):
        torch.testing.assert_close(h[k], hit[k], rtol=0, atol=0)
    torch.testing.assert_close(s, occ, rtol=0, atol=0)
    # Work counters: two box tests per visit.
    work = {}
    from nebulae_tpu_torch.kernels.trace import closest_hit_fat_plain

    closest_hit_fat_plain(_t(o), _t(d), f2, _t(t_b), work=work)
    assert work["box_tests"] == 2 * work["visits"] > 0 and work["tri_tests"] > 0


@pytest.fixture(scope="module")
def subtree():
    """A 2000-triangle cluster and a 6-triangle one far away, cut at 1500
    triangles: fat2 chunks and one single-leaf (one-node) chunk."""
    tri = np.concatenate([_soup(2000, 23, scale=1.0), _soup(6, 5, center=3.0, scale=0.3)])
    jbvh, pbvh = _bvhs(tri, max_leaf=8)
    return {"tri": tri, "jbvh": jbvh, "pbvh": pbvh}


@pytest.mark.parametrize("max_tris", [256, 1500])
def test_fat2_chunks_and_chains_match_jax(subtree, max_tris):
    from nebulae_tpu.kernels import pallas_trace as pt

    from nebulae_tpu_torch.kernels import chunks as kc
    from nebulae_tpu_torch.kernels.trace import tables_to

    tri = subtree["tri"]
    jc = pt.pack_bvh_chunks(subtree["jbvh"], tri, max_tris=max_tris, wide=2, tri_group=4)
    pc = kc.pack_bvh_chunks(subtree["pbvh"], tri, max_tris=max_tris, tri_group=4, wide=2)
    assert len(pc) == len(jc) >= 3
    assert sum("nodes" in c for c in pc) >= 1 and sum("fatnodes" in c for c in pc) >= 2
    for p, j in zip(pc, jc):
        _assert_tables_equal(p, j)
    if max_tris == 256:
        return
    tabs = [tables_to(c, "cpu") for c in pc]
    jtabs = [jax.tree.map(jnp.asarray, c) for c in jc]
    o, d = _rays(1024, 51)
    o[:64] = np.float32([1.5, 1.5, 1.5])  # a few rays into the far single-leaf cluster
    tgt = tri[2000 + np.arange(64) % 6].mean(axis=1)
    d[:64] = (tgt - o[:64]) / np.linalg.norm(tgt - o[:64], axis=-1, keepdims=True)
    _, l = _rays(1024, 52)
    t_b, _ = _caps(1024, 4)
    oj, dj, lj = jnp.asarray(o), jnp.asarray(d), jnp.asarray(l)
    hit = kc.closest_chunks(_t(o), _t(d), tabs)
    jhit = pt.pallas_closest_chunks(oj, dj, jtabs, interpret=True)
    _assert_hits(hit, jhit, RTOL)
    assert (np.asarray(jhit["tri"])[:64] >= 2000).sum() >= 8
    occ = kc.any_chunks(_t(o), _t(l), tabs, 0.6).numpy()
    np.testing.assert_array_equal(occ, np.asarray(pt.pallas_any_chunks(oj, lj, jtabs, 0.6, interpret=True)))
    h, s = kc.shadow_closest_chunks(_t(o), _t(d), _t(l), tabs, _t(t_b), 0.6)
    jh, js = pt.pallas_shadow_closest_chunks(oj, dj, lj, jtabs, t_max_b=jnp.asarray(t_b), t_max_l=0.6,
                                             interpret=True)
    _assert_hits(h, jh, RTOL)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(s.numpy(), occ)


def _pixels_close(a, b, rtol, atol):
    return np.isclose(a, b, rtol=rtol, atol=atol).reshape(a.shape[0] * a.shape[1], -1).all(-1).mean()


def _assert_frame_close(p, j):
    np.testing.assert_array_equal(p["hit"], j["hit"])
    for k in ("hdr", "denoised", "ldr"):
        assert np.isfinite(p[k]).all(), k
        assert _pixels_close(p[k], j[k], 1e-3, 1e-4) >= 0.99, k
    assert np.abs(p["ldr"] - j["ldr"]).mean() < 1e-3


@pytest.fixture(scope="module")
def scene():
    from nebulae_tpu_torch.utils.testscenes import bench_camera, textured_scene

    fs = textured_scene(seed=0)
    return fs, bench_camera(fs)


def test_fat2_frame_matches_jax_and_fat4(scene):
    """bvh_wide=2 packs fat2 tables (route "single") and renders JAX's
    bvh_wide=2 frame and the port's fat4 frame.  This replaces the
    bvh_wide=2 case of test_torch_frame.py's knob test: with their own
    tables the two widths may keep another triangle at an exact t tie."""
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.core.camera import Camera as JCamera
    from nebulae_tpu.core.scene import FlatScene as JFlatScene
    from nebulae_tpu.engine.renderer import Renderer as JRenderer

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.kernels import trace as kt

    fs, cam = scene
    jr = JRenderer(JFlatScene(**fs.field_arrays()), JCfg(**KW, bvh_wide=2))
    assert "fatnodes" in jr.bvh
    j = {k: np.asarray(v) for k, v in jr.render(JCamera(eye=cam.eye, target=cam.target)).items()}
    r2 = Renderer(fs, RenderConfig(**KW, bvh_wide=2), device="cpu")
    assert r2.route == "single" and "fatnodes" in r2.tables and "fat4nodes" not in r2.tables
    calls = {"n": 0}
    plain = kt.closest_hit_fat_plain

    def counted(*a, **k):
        calls["n"] += 1
        return plain(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kt, "closest_hit_fat_plain", counted)
        p2 = {k: v.numpy() for k, v in r2.render(cam).items()}
    assert calls["n"] >= 1
    p4 = {k: v.numpy() for k, v in Renderer(fs, RenderConfig(**KW), device="cpu").render(cam).items()}
    assert j["hit"].mean() > 0.3
    _assert_frame_close(p2, j)
    _assert_frame_close(p2, p4)


def test_fat2_train_step_gradients_match_fat4(scene):
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer, init_frame_state
    from nebulae_tpu_torch.engine.train import Adam, make_train_step, split_scene_params
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays

    class RecordingAdam(Adam):
        def apply(self, params, grads, opt_state):
            self.grads = [g.detach().double() for g in grads]
            return super().apply(params, grads, opt_state)

    fs, cam_obj = scene
    grads = {}
    for wide in (2, 4):
        r = Renderer(fs, RenderConfig(**KW, bvh_wide=wide), device="cpu")
        assert ("fatnodes" in r.tables) == (wide == 2)
        cfg = dataclasses.replace(r.cfg)
        params, frozen = split_scene_params(r.scene)
        params["sun"] = r.sun
        opt = RecordingAdam()
        step, _ = make_train_step(cfg, frozen, r.tables, optimizer=opt, device="cpu")
        cam = make_camera_arrays(cam_obj, 48, 48, "cpu")
        target = torch.full((48, 48, 3), 0.25)
        step(params, opt.init(params), cam, init_frame_state(cfg, "cpu"), target)
        grads[wide] = opt.grads
    for a, b in zip(grads[2], grads[4]):
        na, nb = float(torch.linalg.vector_norm(a)), float(torch.linalg.vector_norm(b))
        if nb == 0.0:
            assert na == 0.0
            continue
        cos = float((a.reshape(-1) @ b.reshape(-1)) / (na * nb))
        assert cos >= 0.9999, cos
