"""The port's reference tracer (`nebulae_tpu_torch/ref/tracer.py`) against
JAX's (`nebulae_tpu/ref/tracer.py`), on the CPU, from the same NumPy inputs.

Inputs: a 1,500-triangle soup with random rays (with and without per-ray
t_max), the textured, normal-mapped small atrium (4,936 triangles) at
48x48, and the 12-triangle box.  Tolerances:
  * RNG states bit for bit (shade_direct's, and path_trace's after the
    frame's draws against JAX's init_rng advanced by the same count);
  * hit masks and occlusion equal; `tri` equal except where the two
    tracers' t lie within 1e-6 relative (a tie);
  * t, u and v within rtol 1e-5 / atol 1e-6;
  * radiance within rtol 1e-5 / atol 1e-6 on every pixel but a few, each
    named with its cause by `outliers`: at most 0.1% of pixels where an ulp
    flipped a Russian-roulette draw or a hit (off by more than 1e-4
    relative), and at most 0.5% where ulps drifted (within 1e-4 relative).
    The two tracers' float32 elementary functions differ by an ulp: on
    the CPU torch's sqrt, sin, cos and pow are not NumPy's (torch's
    vectorised sqrt is not correctly rounded on every input, and its pow
    and NumPy's differ in the last bit on many), and NumPy's branchless
    basis runs in float64 (np.where of Python floats).  A GGX highlight
    at roughness 0.02 lifts such an ulp in a direction past 1e-5 of its
    pixel.
Run with -s to print each case's measured maxima.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_trace import _rays, _soup

S = 48
RTOL, ATOL = 1e-5, 1e-6
BASE = dict(width=S, height=S, max_bounces=2, enable_svgf=False, enable_tonemap=False)
METALLIC = dict(mat_metallic=0.85, mat_roughness=0.35)
# Jitter, the env map's primary sky and the mips act on the primary hit:
# alone they are traced to the first vertex; "all" takes them through a
# bounce.
CASES = {
    "defaults": {},
    "jitter": dict(jitter_primary=True, max_bounces=1),
    "fast": dict(fast_bounce_shading=True),
    "envmap": dict(enable_envmap=True, max_bounces=1),
    "all": dict(jitter_primary=True, fast_bounce_shading=True, enable_envmap=True),
    "spp2": dict(spp=2),
    "no_mips": dict(texture_mips=False, max_bounces=1),
    "threshold": dict(throughput_threshold=0.3),
    "metallic": {},
}


DRIFT = 1e-4  # relative error past which a pixel's path took another turn


def outliers(got, ref, rtol=RTOL, atol=ATOL):
    """Pixels of two [H, W, 3] images outside rtol / atol, each named: its
    pixel, both values, its relative error and its cause.  Returns (drifted,
    flipped): ulps that drifted (within DRIFT relative), and a Russian-
    roulette draw or a hit that an ulp flipped (past it)."""
    bad = ~np.isclose(got, ref, rtol=rtol, atol=atol).all(-1)
    drifted, flipped = [], []
    for y, x in np.argwhere(bad):
        a, b = got[y, x], ref[y, x]
        rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), atol)))
        name = f"pixel ({y}, {x}): {a.tolist()} vs {b.tolist()}, rel {rel:.3g}"
        if rel <= DRIFT:
            drifted.append(name + " (ulps of the elementary functions lifted by the shading)")
        else:
            flipped.append(name + " (a Russian-roulette draw or hit flipped by an ulp)")
    return drifted, flipped


def assert_image_close(got, ref, what, flip_share=1e-3, drift_share=5e-3):
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    drifted, flipped = outliers(got, ref)
    n_pix = got.shape[0] * got.shape[1]
    print(f"{what}: max abs err {np.abs(got - ref).max():.3g}, of {n_pix} pixels {len(drifted)} drifted and "
          f"{len(flipped)} flipped past rtol {RTOL} / atol {ATOL}" + "".join(f"\n  {n}" for n in drifted + flipped))
    assert len(flipped) <= flip_share * n_pix, f"{what}: " + "; ".join(flipped)
    assert len(drifted) <= drift_share * n_pix, f"{what}: " + "; ".join(drifted)


def assert_hits_close(p, j, what=""):
    """Closest hits of the port (tensors) against JAX's (arrays)."""
    p = {k: v.numpy() for k, v in p.items()}
    hit = j["tri"] >= 0
    np.testing.assert_array_equal(p["tri"] >= 0, hit, err_msg=what)
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(p[k][hit], j[k][hit], rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")
    differ = hit & (p["tri"] != j["tri"])
    tie = np.abs(p["t"][differ] - j["t"][differ]) <= 1e-6 * np.abs(j["t"][differ])
    assert tie.all(), f"{what}: tri differs away from a tie on {np.argwhere(differ)[~tie][:5]}"
    assert np.isinf(p["t"][~hit]).all()


def _jax_cfg(kw):
    from nebulae_tpu.config import RenderConfig

    return RenderConfig(**kw)


def _cfg(kw):
    from nebulae_tpu_torch.config import RenderConfig

    return RenderConfig(**kw)


def jax_rng_after(w, h, frame, draws):
    """JAX's init_rng for `frame` advanced by `draws` draws (int64)."""
    from nebulae_tpu.core import rng as jrng

    ys, xs = np.meshgrid(np.arange(h, dtype=np.uint32), np.arange(w, dtype=np.uint32), indexing="ij")
    state = jrng.init_rng(xs.reshape(-1), ys.reshape(-1), w, np.uint32(frame))
    for _ in range(draws):
        state, _ = jrng.next_float(state)
    return np.asarray(state).astype(np.int64)


def frame_draws(cfg) -> int:
    """Draws a pixel makes in path_trace: per sample 2 for the jitter, 2 NEE
    at each vertex and 3 (roulette and bounce) at each but the last."""
    return cfg.spp * ((2 if cfg.jitter_primary else 0) + 2 * cfg.max_bounces + 3 * (cfg.max_bounces - 1))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU work on one thread, the count restored after the
    module: beside the suite's other workers a multi-threaded op mostly
    waits for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_gbuffers():
    """JAX's G-buffers of the atrium, by texture_mips (made once)."""
    return {}


def _jax_gbuffer(atrium, cache, mips):
    from nebulae_tpu.ref.tracer import render_gbuffer_np

    if mips not in cache:
        cache[mips] = render_gbuffer_np(atrium["jscene"], atrium["jcam"], S, S, texture_mips=mips)
    return cache[mips]


@pytest.fixture(scope="module")
def atrium():
    from nebulae_tpu.config import SunLight as JSun
    from nebulae_tpu.core.camera import Camera as JCamera
    from nebulae_tpu.core.scene import FlatScene as JFlatScene

    from nebulae_tpu_torch.config import SunLight
    from nebulae_tpu_torch.utils.testscenes import atrium_camera, procedural_envmap, small_atrium

    fs = small_atrium(0)
    cam = atrium_camera(fs)
    env = procedural_envmap()
    return {
        "fs": fs, "cam": cam, "jcam": JCamera(eye=cam.eye, target=cam.target, fov_y_deg=cam.fov_y_deg),
        "jscene": {**JFlatScene(**fs.field_arrays()).device_arrays(), "env_map": env},
        "scene": {**fs.device_arrays(), "env_map": env},
        "jsun": JSun.default(np), "sun": SunLight.default("cpu"),
    }


# ---------------------------------------------------------------------------
# Intersection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capped", [False, True])
def test_intersect_matches_jax_on_soup(capped):
    from nebulae_tpu.ref.tracer import intersect_any_np, intersect_closest_np

    from nebulae_tpu_torch.ref.tracer import intersect_any, intersect_closest

    tri = _soup()
    o, d = _rays(1024)
    t_max = np.inf
    if capped:
        t_max = np.random.default_rng(2).uniform(0.0, 1.0, 1024).astype(np.float32)
        t_max[::5] = np.inf
    # JAX's closest hit takes a per-ray cap as a column ([N, 1]): a flat
    # [N] cap does not broadcast against its [N, Tc] block there.
    ref = intersect_closest_np(o, d, tri, t_max=np.reshape(t_max, (-1, 1)))
    got = intersect_closest(o, d, tri, t_max=t_max, device="cpu")
    assert 0.2 < (ref["tri"] >= 0).mean() < 0.95
    assert_hits_close(got, ref, "closest")
    occ = intersect_any(o, d, tri, t_max=t_max, device="cpu").numpy()
    np.testing.assert_array_equal(occ, intersect_any_np(o, d, tri, t_max=t_max))
    # The blocking does not change the first minimum: a small chunk walks
    # rays and triangles in many blocks.
    small = intersect_closest(o, d, tri, t_max=t_max, chunk=5_000, device="cpu")
    for k in ("t", "tri", "u", "v"):
        torch.testing.assert_close(small[k], got[k], rtol=0, atol=0)


def test_intersect_box_and_empty():
    """The box from outside and inside (every ray inside hits), axis-aligned
    rays, and a scene without triangles."""
    from nebulae_tpu.ref.tracer import intersect_any_np, intersect_closest_np

    from nebulae_tpu_torch.ref.tracer import intersect_any, intersect_closest
    from nebulae_tpu_torch.utils.testscenes import box_scene

    tri = box_scene().tri_pos
    o, d = _rays(1024, seed=9)
    o[::2] = 0.5  # inside
    d[::7] = np.eye(3, dtype=np.float32)[np.arange(0, 1024, 7) % 3]
    ref = intersect_closest_np(o, d, tri)
    assert (ref["tri"][::2] >= 0).all()
    assert_hits_close(intersect_closest(o, d, tri, device="cpu"), ref, "box")
    np.testing.assert_array_equal(intersect_any(o, d, tri, t_max=0.3, device="cpu").numpy(),
                                  intersect_any_np(o, d, tri, t_max=0.3))
    empty = intersect_closest(o, d, tri[:0], device="cpu")
    assert (empty["tri"] == -1).all() and torch.isinf(empty["t"]).all()
    assert not intersect_any(o, d, tri[:0], device="cpu").any()


# ---------------------------------------------------------------------------
# Passes on the atrium
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mips", [True, False])
def test_gbuffer_matches_jax(atrium, jax_gbuffers, mips):
    from nebulae_tpu_torch.ref.tracer import render_gbuffer

    a = atrium
    ref = _jax_gbuffer(a, jax_gbuffers, mips)
    got = {k: v.numpy() for k, v in render_gbuffer(a["scene"], a["cam"], S, S, texture_mips=mips,
                                                   device="cpu").items()}
    assert set(got) == set(ref)
    hit = ref["hit"]
    np.testing.assert_array_equal(got["hit"], hit)
    assert 0.5 < hit.mean()
    np.testing.assert_array_equal(np.isinf(got["depth"]), np.isinf(ref["depth"]))
    for k in ("depth", "position", "view", "ray_o", "ray_d"):
        np.testing.assert_allclose(got[k][hit], ref[k][hit], rtol=RTOL, atol=ATOL, err_msg=k)
    # Shading attributes: the normal map's texel steps lift ulps of the
    # hit point; every pixel within 1e-4, all but 0.1% within 1e-5.
    for k in ("normal_g", "normal_s", "albedo", "roughness", "metalness", "emissive"):
        close = np.isclose(got[k][hit], ref[k][hit], rtol=RTOL, atol=1e-5).reshape(int(hit.sum()), -1).all(-1)
        assert close.mean() >= 0.999, k
        np.testing.assert_allclose(got[k][hit], ref[k][hit], rtol=0, atol=1e-4, err_msg=k)


def test_shade_direct_and_render_direct_match_jax(atrium, jax_gbuffers):
    from nebulae_tpu.core import rng as jrng
    from nebulae_tpu.ref.tracer import render_direct_np, shade_direct_np

    from nebulae_tpu_torch.core import rng as nrng
    from nebulae_tpu_torch.ref.tracer import render_direct, render_gbuffer, shade_direct

    a = atrium
    xs, ys = np.meshgrid(np.arange(S, dtype=np.uint32), np.arange(S, dtype=np.uint32))
    jstate = jrng.init_rng(xs.reshape(-1), ys.reshape(-1), S, np.uint32(4))
    state = nrng.init_rng(torch.from_numpy(xs.reshape(-1).astype(np.int64)),
                          torch.from_numpy(ys.reshape(-1).astype(np.int64)), S, 4)
    jg = _jax_gbuffer(a, jax_gbuffers, True)
    g = render_gbuffer(a["scene"], a["cam"], S, S, texture_mips=True, device="cpu")
    ref, jstate = shade_direct_np(a["jscene"], jg, a["jsun"], jstate)
    got, state = shade_direct(a["scene"], g, a["sun"], state, device="cpu")
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate).astype(np.int64))
    assert_image_close(got.numpy().reshape(S, S, 3), ref.reshape(S, S, 3), "shade_direct")
    cfg = dict(BASE, enable_gi=False)
    ref = render_direct_np(a["jscene"], a["jcam"], _jax_cfg(cfg), a["jsun"], frame=2)
    got = render_direct(a["scene"], a["cam"], _cfg(cfg), a["sun"], frame=2, device="cpu").numpy()
    assert_image_close(got, ref, "render_direct")
    assert got.std() > 0.05


@pytest.mark.parametrize("case", list(CASES))
def test_path_trace_matches_jax(atrium, case):
    from nebulae_tpu.ref.tracer import path_trace_np

    from nebulae_tpu_torch.ref.tracer import path_trace

    a = atrium
    jscene, scene = a["jscene"], a["scene"]
    if case == "metallic":
        mats = {k: np.full_like(jscene[k], v) for k, v in METALLIC.items()}
        jscene, scene = {**jscene, **mats}, {**scene, **mats}
    kw = dict(BASE, **CASES[case])
    frame = 3
    ref = path_trace_np(jscene, a["jcam"], _jax_cfg(kw), a["jsun"], frame=frame)
    got, state = path_trace(scene, a["cam"], _cfg(kw), a["sun"], frame=frame, device="cpu", return_rng=True)
    assert_image_close(got.numpy(), ref, f"path_trace {case}")
    np.testing.assert_array_equal(state.numpy(), jax_rng_after(S, S, frame, frame_draws(_cfg(kw))))
    if case == "threshold":
        plain = path_trace(scene, a["cam"], _cfg(dict(BASE)), a["sun"], frame=frame, device="cpu")
        assert float((plain - got).abs().max()) > 1e-3  # the threshold ends paths


def test_box_path_trace_matches_jax():
    """The 12-triangle box from outside, under the sun and the sky."""
    from nebulae_tpu.config import SunLight as JSun
    from nebulae_tpu.core.camera import Camera as JCamera
    from nebulae_tpu.core.scene import FlatScene as JFlatScene
    from nebulae_tpu.ref.tracer import path_trace_np

    from nebulae_tpu_torch.config import SunLight
    from nebulae_tpu_torch.core.camera import Camera
    from nebulae_tpu_torch.ref.tracer import path_trace
    from nebulae_tpu_torch.utils.testscenes import box_scene

    fs = box_scene()
    eye, target = np.float32([1.9, 1.6, 2.3]), np.float32([0.5, 0.4, 0.5])
    kw = dict(BASE, width=32, height=32, max_bounces=4)
    ref = path_trace_np(JFlatScene(**fs.field_arrays()).device_arrays(), JCamera(eye=eye, target=target),
                        _jax_cfg(kw), JSun.default(np), frame=1)
    got = path_trace(fs.device_arrays(), Camera(eye=eye, target=target), _cfg(kw), SunLight.default("cpu"),
                     frame=1, device="cpu").numpy()
    assert_image_close(got, ref, "box path_trace")
    assert 0.1 < (got != ref[0, 0]).any(-1).mean() < 0.9


# ---------------------------------------------------------------------------
# The two small functions: validate_bvh and aces_tonemap_np
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scene", ["small_atrium", "textured_scene", "box_scene", "refit"])
def test_validate_bvh_on_port_trees(scene):
    """The port's C++ trees pass validate_bvh, and so does the tree after
    update_instances with its refit bounds; a broken tree fails it."""
    from nebulae_tpu_torch.bvh.builder import FlatBVH, validate_bvh
    from nebulae_tpu_torch.bvh.cbuilder import build_bvh_for
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.utils import testscenes
    from test_torch_refit import _transforms

    fs = getattr(testscenes, "textured_scene" if scene == "refit" else scene)()
    bvh = build_bvh_for("cpu", fs.tri_pos, max_leaf=15)
    tri = fs.tri_pos
    if scene == "refit":
        r = Renderer(fs, RenderConfig(width=8, height=8, tracer="pallas"), device="cpu")
        n_inst = int(fs.instance_of_tri.max()) + 1
        r.update_instances(_transforms(n_inst, float((fs.aabb_max - fs.aabb_min).max())))
        tri = r.scene["tri_pos"].numpy()
        assert np.abs(tri - fs.tri_pos).max() > 0.01
        bvh = dataclasses.replace(r.bvh, node_lo=r.node_lo.numpy(), node_hi=r.node_hi.numpy())
    validate_bvh(bvh, tri)
    broken = dataclasses.replace(bvh, node_hi=bvh.node_hi - 0.1)
    with pytest.raises(AssertionError):
        validate_bvh(broken, tri)
    assert isinstance(bvh, FlatBVH)


def test_validate_bvh_matches_jax_verdicts():
    """JAX's validate_bvh and the port's agree on a good tree and on trees
    with a broken permutation, a broken skip link and a shrunk leaf box."""
    from nebulae_tpu.bvh.builder import FlatBVH as JFlatBVH
    from nebulae_tpu.bvh.builder import validate_bvh as jvalidate

    from nebulae_tpu_torch.bvh.builder import build_bvh, validate_bvh

    tri = _soup(300, seed=4)
    good = build_bvh(tri, max_leaf=4)
    leaf = int(np.nonzero(good.node_count > 0)[0][3])
    perm = good.tri_index.copy()
    perm[0] = perm[1]
    skip = good.node_skip.copy()
    skip[1] += 1
    lo = good.node_lo.copy()
    lo[leaf] += 0.05
    for name, bvh in (("good", good), ("perm", dataclasses.replace(good, tri_index=perm)),
                      ("skip", dataclasses.replace(good, node_skip=skip)),
                      ("leaf", dataclasses.replace(good, node_lo=lo))):
        verdicts = []
        for fn, tree in ((validate_bvh, bvh), (jvalidate, JFlatBVH(**bvh.device_arrays()))):
            try:
                fn(tree, tri)
                verdicts.append(True)
            except AssertionError:
                verdicts.append(False)
        assert verdicts[0] == verdicts[1] == (name == "good"), (name, verdicts)


def test_aces_tonemap_np_matches_torch_and_jax():
    from nebulae_tpu.passes.tonemap import aces_tonemap_np as jaces_np

    from nebulae_tpu_torch.passes.tonemap import aces_tonemap, aces_tonemap_np

    rng = np.random.default_rng(0)
    hdr = (rng.uniform(size=(17, 9, 3)) * 4.0).astype(np.float32)
    out = aces_tonemap_np(hdr)
    assert out.dtype == np.float32 and out.min() >= 0.0 and out.max() <= 1.0
    np.testing.assert_allclose(aces_tonemap(torch.from_numpy(hdr)).numpy(), out, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out, jaces_np(hdr), rtol=1e-5, atol=1e-6)
