"""The port's pipeline held to its reference tracer on the CPU: the
counterparts of JAX's tests that hold its pipeline to its oracle
(tests/test_pipeline.py, test_fast_shading.py, test_envmap.py,
test_mips.py, test_refit.py), which need the absent Cornell and helmet
assets, on the procedural small atrium and textured field instead.

Frames come through `Renderer.render` and `render_frame` with
device="cpu" (the plain versions of the kernels) at 32x32 and are held to
`nebulae_tpu_torch.ref.tracer` on the same scene tables:
  * direct light (enable_gi=False): rtol 1e-4 / atol 1e-4
    (test_pipeline.py:46);
  * the path-traced hdr (spp=2, 3 bounces, SVGF and ACES off): rtol 1e-3 /
    atol 2e-4 (test_pipeline.py:59), under each frame option, without
    mips, on each chunk_mode route (limits shrunk as in
    tests/test_torch_routes.py), with bvh_wide=2, and after
    update_instances and update_geometry against the reference tracer on
    the moved triangles, baked into a fresh scene.
The aim is JAX's: equal hit masks and every pixel within tolerance; the
floor is 99.9% of pixels and of hit decisions, and `hold` names every
outlier with its cause.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_frame import _camera
from test_torch_ref import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_refit import _transforms
from test_torch_routes import ROUTES

S = 32
FLOOR = 0.999
DIRECT = dict(width=S, height=S, enable_gi=False, enable_svgf=False, enable_tonemap=False)
TRACED = dict(width=S, height=S, spp=2, max_bounces=3, enable_svgf=False, enable_tonemap=False)
OPTIONS = {
    "defaults": {},
    "jitter": dict(jitter_primary=True),
    "fast": dict(fast_bounce_shading=True),
    "envmap": dict(enable_envmap=True),
    "all": dict(jitter_primary=True, fast_bounce_shading=True, enable_envmap=True),
    "no_mips": dict(texture_mips=False),
}


def hold(out, ref, gbuf, rtol, atol, what):
    """A frame's outputs against the reference tracer's image `ref` and
    G-buffer `gbuf` (its primary hits): hit decisions and pixels agree on
    >= FLOOR of the image, and each outlier is named with its cause."""
    hdr = out["hdr"].numpy()
    ref = ref.numpy()
    n_pix = hdr.shape[0] * hdr.shape[1]
    assert np.isfinite(hdr).all(), what
    hit, ref_hit = out["hit"].numpy().reshape(-1), gbuf["hit"].numpy()
    depth, ref_depth = out["depth"].numpy().reshape(-1), gbuf["depth"].numpy()
    flipped = hit != ref_hit
    named = [f"pixel {divmod(int(i), hdr.shape[1])}: primary hit {bool(hit[i])} vs {bool(ref_hit[i])} "
             "(a grazing hit flipped between the walk's and the reference's order of operations)"
             for i in np.nonzero(flipped)[0]]
    bad = ~np.isclose(hdr, ref, rtol=rtol, atol=atol).reshape(n_pix, 3).all(-1)
    for i in np.nonzero(bad & ~flipped)[0]:
        moved = hit[i] and not np.isclose(depth[i], ref_depth[i], rtol=1e-5, atol=0.0)
        cause = ("a grazing primary hit on another triangle" if moved
                 else "a Russian-roulette draw or a later hit flipped by an ulp")
        named.append(f"pixel {divmod(int(i), hdr.shape[1])}: {hdr.reshape(n_pix, 3)[i].tolist()} vs "
                     f"{ref.reshape(n_pix, 3)[i].tolist()} ({cause})")
    print(f"{what}: max abs err {np.abs(hdr - ref).max():.3g}, hit masks differ on {int(flipped.sum())}, "
          f"pixels outside tolerance {int(bad.sum())} of {n_pix}" + "".join(f"\n  {n}" for n in named))
    assert 1.0 - flipped.mean() >= FLOOR, f"{what}: " + "; ".join(named)
    assert 1.0 - bad.mean() >= FLOOR, f"{what}: " + "; ".join(named)


def _patch_limits(mp, limits, tri_pos):
    """The port's chunk limits; a "small" triangle-chunk budget is the
    scene's padded fat4 nodes plus 48 KB (tests/test_torch_routes.py's)."""
    from nebulae_tpu_torch.bvh.cbuilder import build_bvh_for
    from nebulae_tpu_torch.kernels import chunks as kc
    from nebulae_tpu_torch.kernels import trace as kt

    for name, value in limits.items():
        if value == "small":
            nodes = kt.pack_bvh_fat4(build_bvh_for("cpu", tri_pos, max_leaf=15), tri_pos, 8)["fat4nodes"]
            value = kc._padded_rows(nodes.shape[0]) * kt.NODE_STRIDE * 4 + 48 * 1024
        mp.setattr(kc, name, value)


def _cfg(**kw):
    from nebulae_tpu_torch.config import RenderConfig

    return RenderConfig(**kw)


def _scene(kind):
    from nebulae_tpu_torch.config import SunLight
    from nebulae_tpu_torch.core.camera import Camera
    from nebulae_tpu_torch.utils.testscenes import atrium_camera, procedural_envmap, small_atrium, textured_scene

    fs = small_atrium(0) if kind == "atrium" else textured_scene(0)
    cam = atrium_camera(fs) if kind == "atrium" else _camera(fs, Camera)
    env = procedural_envmap()
    return {"fs": fs, "cam": cam, "env": env, "sun": SunLight.default("cpu"),
            "arrays": {**fs.device_arrays(), "env_map": env}}


@pytest.fixture(scope="module")
def atrium():
    return _scene("atrium")


@pytest.fixture(scope="module")
def textured():
    return _scene("textured")


def _reference(s, cfg, frame=0, arrays=None):
    """The reference tracer's image and (unjittered) G-buffer."""
    from nebulae_tpu_torch.ref.tracer import path_trace, render_direct, render_gbuffer

    arrays = s["arrays"] if arrays is None else arrays
    fn = path_trace if cfg.enable_gi else render_direct
    img = fn(arrays, s["cam"], cfg, s["sun"], frame=frame, device="cpu")
    gbuf = render_gbuffer(arrays, s["cam"], cfg.width, cfg.height, texture_mips=cfg.texture_mips, device="cpu")
    return img, gbuf


def _render(s, cfg, **renderer_kw):
    from nebulae_tpu_torch.engine.renderer import Renderer

    r = Renderer(s["fs"], cfg, device="cpu", env_map=s["env"], **renderer_kw)
    return r, r.render(s["cam"])


@pytest.mark.parametrize("kind", ["atrium", "textured"])
def test_direct_matches_reference(kind, atrium, textured):
    s = atrium if kind == "atrium" else textured
    cfg = _cfg(**DIRECT)
    r, out = _render(s, cfg)
    assert r.route == "single"
    ref, gbuf = _reference(s, cfg)
    hold(out, ref, gbuf, 1e-4, 1e-4, f"{kind} direct")
    assert out["hit"].float().mean() > 0.5


@pytest.mark.parametrize("kind,option", [("atrium", o) for o in OPTIONS] + [("textured", "defaults")])
def test_path_traced_matches_reference(kind, option, atrium, textured):
    s = atrium if kind == "atrium" else textured
    cfg = _cfg(**TRACED, **OPTIONS[option])
    _, out = _render(s, cfg)
    ref, gbuf = _reference(s, cfg)
    hold(out, ref, gbuf, 1e-3, 2e-4, f"{kind} path-traced {option}")


def test_render_frame_matches_reference(atrium):
    """render_frame itself, at frame 5 with its state and camera arrays."""
    from nebulae_tpu_torch.engine.renderer import Renderer, init_frame_state, render_frame
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays

    s = atrium
    cfg = _cfg(**TRACED)
    r = Renderer(s["fs"], cfg, device="cpu")
    state = init_frame_state(cfg, "cpu")
    state["frame"] = 5
    out, new_state = render_frame(r.scene, r.tables, r.sun, make_camera_arrays(s["cam"], S, S, "cpu"), state, cfg,
                                  device="cpu")
    assert new_state["frame"] == 6
    ref, gbuf = _reference(s, cfg, frame=5)
    hold(out, ref, gbuf, 1e-3, 2e-4, "atrium render_frame at frame 5")


@pytest.mark.parametrize("route", ["paged", "tri", "subtree", "fat2", "fat2_subtree"])
def test_routes_match_reference(atrium, route):
    """chunk_mode subtree, tri and paged (limits shrunk so that the scene
    takes two or more chunks) and bvh_wide=2, one table and chunked."""
    from nebulae_tpu_torch.engine.renderer import Renderer

    s = atrium
    mode, limits = ROUTES[route.replace("fat2_", "") if route != "fat2" else "single"]
    kw = dict(TRACED, chunk_mode=mode, bvh_wide=2 if route.startswith("fat2") else 4)
    with pytest.MonkeyPatch.context() as mp:
        _patch_limits(mp, limits, s["fs"].tri_pos)
        r = Renderer(s["fs"], _cfg(**kw), device="cpu", env_map=s["env"])
    expect = {"fat2": "single", "fat2_subtree": "subtree"}.get(route, route)
    assert r.route == expect
    fat2 = "fatnodes" in r.tables or any("fatnodes" in c for c in r.tables.get("chunks", []))
    assert fat2 == route.startswith("fat2")
    assert len(r.tables.get("tri_chunks", r.tables.get("chunks", []))) >= (2 if route in ("tri", "subtree") else 0)
    out = r.render(s["cam"])
    ref, gbuf = _reference(s, _cfg(**kw))
    hold(out, ref, gbuf, 1e-3, 2e-4, f"atrium path-traced on {route}")


def _baked(fs, moved, nrm=None):
    from nebulae_tpu_torch.core.scene import face_normals

    nrm = fs.tri_nrm if nrm is None else nrm
    return dataclasses.replace(fs, tri_pos=moved.astype(np.float32), tri_nrm=nrm.astype(np.float32),
                               tri_face_nrm=face_normals(moved.astype(np.float32), nrm.astype(np.float32)))


@pytest.mark.parametrize("update", ["instances", "geometry", "geometry_paged"])
def test_refit_frames_match_reference(atrium, update):
    """A frame after update_instances (one torus turns and rises) and after
    update_geometry (a shear and a drop of every triangle; also from the
    paged route), against the reference tracer on the moved triangles,
    baked into a fresh scene."""
    from nebulae_tpu_torch.engine.renderer import Renderer

    s = atrium
    fs = s["fs"]
    cfg = _cfg(**TRACED, **({"chunk_mode": "paged"} if update == "geometry_paged" else {}))
    r = Renderer(fs, cfg, device="cpu")
    before = r.render(s["cam"])["hdr"]
    ext = float((fs.aabb_max - fs.aabb_min).max())
    if update == "instances":
        m = _transforms(int(fs.instance_of_tri.max()) + 1, ext)
        r.update_instances(m)
        moved, nrm = fs.tri_pos.copy(), fs.tri_nrm.copy()
        m1 = fs.instance_of_tri == 1
        moved[m1] = np.einsum("ij,tvj->tvi", m[1, :, :3], moved[m1]) + m[1, :, 3]
        nrm[m1] = np.einsum("ij,tvj->tvi", m[1, :, :3], nrm[m1])
    else:
        moved, nrm = fs.tri_pos.copy(), None
        moved[..., 0] += 0.02 * ext * np.sin(moved[..., 1] / ext)
        moved[..., 1] -= 0.01 * ext
        r.update_geometry(moved)
    out = r.render(s["cam"])
    assert float((out["hdr"] - before).abs().max()) > 1e-3  # it moved
    baked = {**_baked(fs, moved, nrm).device_arrays(), "env_map": s["env"]}
    ref, gbuf = _reference(s, cfg, frame=1, arrays=baked)
    hold(out, ref, gbuf, 1e-3, 2e-4, f"atrium after update_{update}")


def test_port_reference_is_not_the_pipeline():
    """The reference tracer imports no traversal table, wrapper or kernel
    of the port, and no module of the port outside ref/ imports it."""
    import ast
    import inspect
    from pathlib import Path

    import nebulae_tpu_torch
    from nebulae_tpu_torch.ref import tracer

    imported = {n.module for n in ast.walk(ast.parse(inspect.getsource(tracer))) if isinstance(n, ast.ImportFrom)}
    pipeline = ("nebulae_tpu_torch.kernels", "nebulae_tpu_torch.tracer", "nebulae_tpu_torch.bvh",
                "nebulae_tpu_torch.engine")
    assert not {m for m in imported if m.startswith(pipeline)}, imported
    root = Path(nebulae_tpu_torch.__file__).parent
    users = [p for p in root.rglob("*.py") if "ref" not in p.relative_to(root).parts
             and "nebulae_tpu_torch.ref" in p.read_text()]
    assert not users, users
