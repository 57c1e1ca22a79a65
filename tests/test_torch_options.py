"""The frame options primary jitter, fast bounce shading and the
environment-map sky, in the port against the JAX Renderer on the CPU.

The ~5k-triangle procedural torus scene at 48x48, 4 bounces, SVGF and ACES,
fed to both packages from one numpy seed; the env-map cases give both the
64x128 procedural sky of JAX's app (`utils.testscenes.procedural_envmap`),
which JAX's app puts in the scene as the port's Renderer does.  Each option,
all three together, and fast shading with the ray sort off (JAX then
reconstructs the next vertex at full width after the walk):
  * frame hdr, denoised and ldr on >= 99% of pixels within rtol 1e-3 /
    atol 1e-4, as tests/test_torch_frame.py holds the frame: an ulp in a
    hit point can flip a Russian-roulette or hit/miss decision on a few
    paths;
  * the RNG state after the frame's samples equal, bit for bit, to the
    state JAX's frame reaches: its draws do not depend on the values drawn
    (xorshift advances once a draw), so that state is JAX's init_rng
    advanced by the frame's draws, 2 for each sample's jitter and then the
    path's (core.brdf's draw order);
  * one train step (MSE to a zero target, Adam): loss within a relative
    1e-3, each gradient with a cosine >= 0.9999 and a relative L2 error
    <= 1e-3, as tests/test_torch_train.py holds the step.
Also: fast shading after a refit against a rebuild on the moved triangles
(the refit rewrites the tri_fast rows), the gradient of the frame mean with
respect to the environment map against jax.grad (the map of
tests/test_envmap.py), and enable_envmap on a scene without a map, which
shows the constant sky.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

S = 48
KW = dict(width=S, height=S, max_bounces=4, enable_svgf=True, enable_tonemap=True,
          bucket_scheduling=False)
OPTIONS = {
    "jitter": dict(jitter_primary=True),
    "fast": dict(fast_bounce_shading=True),
    "fast-unsorted": dict(fast_bounce_shading=True, sort_rays=False),
    "envmap": dict(enable_envmap=True),
    "all": dict(jitter_primary=True, fast_bounce_shading=True, enable_envmap=True),
}
TRAINED = ("jitter", "fast", "envmap", "all")
MAT_KEYS = ("mat_base_color", "mat_metallic", "mat_roughness", "mat_emissive")
SUN_KEYS = ("direction", "radiance", "tan_half_angle", "sky_color")


def _camera(fs, cls):
    lo, hi = fs.aabb_min, fs.aabb_max
    c = (lo + hi) / 2
    c[1] = 0.5
    ext = float((hi - lo).max())
    return cls(eye=(c + np.array([0.12, 0.15, 0.22]) * ext).astype(np.float32), target=c.astype(np.float32))


def _gradient_envmap(h=32, w=64):
    """tests/test_envmap.py's synthetic sky: blue up, warm horizon."""
    theta = np.linspace(0, np.pi, h, dtype=np.float32)[:, None]
    up = np.clip(np.cos(theta), 0, 1)
    env = np.zeros((h, w, 3), np.float32)
    env[..., 0] = 0.9 - 0.6 * up
    env[..., 1] = 0.6
    env[..., 2] = 0.3 + 0.6 * up
    return env


@pytest.fixture(scope="module")
def setup():
    from nebulae_tpu_torch.core.camera import Camera
    from nebulae_tpu_torch.utils.testscenes import procedural_envmap, textured_scene

    fs = textured_scene(seed=0)
    return {"fs": fs, "cam": _camera(fs, Camera), "env": procedural_envmap()}


def _jax_renderer(setup, kw):
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.core.scene import FlatScene as JFlatScene
    from nebulae_tpu.engine.renderer import Renderer as JRenderer

    jr = JRenderer(JFlatScene(**setup["fs"].field_arrays()), JCfg(**kw))
    jr.scene["env_map"] = jnp.asarray(setup["env"])  # as JAX's app sets it
    return jr


def _port_frame(setup, kw):
    """The port's first frame under kw, and the RNG state its samples leave."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine import renderer as rmod

    pr = rmod.Renderer(setup["fs"], RenderConfig(**kw), device="cpu", env_map=setup["env"])
    seen = {}
    trace_samples = rmod.trace_samples

    def spy(*args, **kwargs):
        radiance, rng_state = trace_samples(*args, **kwargs)
        seen["rng"] = rng_state
        return radiance, rng_state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rmod, "trace_samples", spy)
        out = {k: v.numpy() for k, v in pr.render(setup["cam"]).items()}
    return out, seen["rng"]


@pytest.fixture(scope="module", params=list(OPTIONS))
def frames(request, setup):
    from nebulae_tpu.core.camera import Camera as JCamera

    kw = dict(KW, **OPTIONS[request.param])
    cam = setup["cam"]
    jr = _jax_renderer(setup, kw)
    jax_out = {k: np.asarray(v) for k, v in jr.render(JCamera(eye=cam.eye, target=cam.target,
                                                                 fov_y_deg=cam.fov_y_deg)).items()}
    port_out, rng = _port_frame(setup, kw)
    return {"name": request.param, "kw": kw, "jax": jax_out, "port": port_out, "rng": rng}


def _pixels_close(a, b, rtol=1e-3, atol=1e-4):
    """Share of pixels whose every channel is within tolerance."""
    return np.isclose(a, b, rtol=rtol, atol=atol).reshape(S * S, -1).all(-1).mean()


def test_option_frame_matches_jax(frames):
    p, j = frames["port"], frames["jax"]
    np.testing.assert_array_equal(p["hit"], j["hit"])
    for k in ("hdr", "denoised", "ldr"):
        assert np.isfinite(p[k]).all(), k
        frac = _pixels_close(p[k], j[k])
        assert frac >= 0.99, f"{frames['name']} {k}: {frac:.4f} of pixels within tolerance"
    assert np.abs(p["ldr"] - j["ldr"]).mean() < 1e-3


def test_option_rng_state_matches_jax(frames):
    from nebulae_tpu.core import rng as jrng

    kw = frames["kw"]
    ys, xs = np.meshgrid(np.arange(S, dtype=np.uint32), np.arange(S, dtype=np.uint32), indexing="ij")
    state = jrng.init_rng(jnp.asarray(xs.reshape(-1)), jnp.asarray(ys.reshape(-1)), S, jnp.uint32(0))
    per_sample = (2 if kw.get("jitter_primary") else 0) + 5 * (kw["max_bounces"] - 1) + 2
    for _ in range(per_sample):
        state, _ = jrng.next_float(state)
    np.testing.assert_array_equal(frames["rng"].numpy(), np.asarray(state).astype(np.int64))


def test_fast_shading_with_and_without_the_sort_agree(setup):
    """Fast shading in the compact sorted domain and at full width after
    the walk (sort_rays off) give the port the same frame bit for bit: the
    same per-ray arithmetic, in another lane order."""
    sorted_out, _ = _port_frame(setup, dict(KW, **OPTIONS["fast"]))
    unsorted_out, _ = _port_frame(setup, dict(KW, **OPTIONS["fast-unsorted"]))
    for k in ("hdr", "denoised", "ldr"):
        np.testing.assert_array_equal(sorted_out[k], unsorted_out[k], err_msg=k)


def test_fast_shading_after_refit_matches_rebuild(setup):
    """update_instances rewrites the tri_fast rows with the geometry: the
    fast-shading frame after the move equals a Renderer rebuilt on the
    moved triangles (copied back, so the rows are bit-identical) at JAX's
    refit tolerance (rtol 1e-4 / atol 1e-5, tests/test_refit.py)."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer, init_frame_state

    fs, cam = setup["fs"], setup["cam"]
    cfg = RenderConfig(**dict(KW, **OPTIONS["fast"]))

    def hdr(r):
        r.state = init_frame_state(cfg, "cpu")
        return r.render(cam)["hdr"].numpy()

    r = Renderer(fs, cfg, device="cpu")
    img0 = hdr(r)
    ext = float((fs.aabb_max - fs.aabb_min).max())
    c, s = np.cos(0.3), np.sin(0.3)
    m = np.repeat(np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)[None], int(fs.instance_of_tri.max()) + 1,
                  axis=0).astype(np.float32)
    m[1] = [[c, 0, s, 0.0], [0, 1, 0, 0.12 * ext], [-s, 0, c, 0.0]]
    fast0 = r.scene["tri_fast"].clone()
    r.update_instances(m)
    img = hdr(r)
    assert not torch.equal(r.scene["tri_fast"], fast0)
    assert np.abs(img - img0).max() > 1e-3  # it moved
    host = {k: r.scene[k].numpy() for k in ("tri_pos", "tri_nrm", "tri_face_nrm")}
    rebuilt = Renderer(dataclasses.replace(fs, **host), cfg, device="cpu")
    assert torch.equal(r.scene["tri_fast"], rebuilt.scene["tri_fast"])
    np.testing.assert_allclose(img, hdr(rebuilt), rtol=1e-4, atol=1e-5)


def test_envmap_without_a_map_shows_the_constant_sky(setup):
    """enable_envmap on a scene that holds no "env_map" is JAX's rule
    (core/brdf.py sky_eval): the constant sky, so the frame of the
    default configuration."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer

    fs, cam = setup["fs"], setup["cam"]
    on = Renderer(fs, RenderConfig(**KW, enable_envmap=True), device="cpu").render(cam)
    off = Renderer(fs, RenderConfig(**KW), device="cpu").render(cam)
    with_map = Renderer(fs, RenderConfig(**KW, enable_envmap=True), device="cpu", env_map=setup["env"]).render(cam)
    for k in ("hdr", "ldr"):
        np.testing.assert_array_equal(on[k].numpy(), off[k].numpy(), err_msg=k)
    assert not torch.equal(with_map["hdr"], off["hdr"])


def test_envmap_gradient_matches_jax(setup):
    """d mean(hdr) / d env_map of a 32x32 frame (2 bounces, no SVGF or
    tonemap, tests/test_envmap.py's 16x32 map) against jax.grad of JAX's
    render_frame on the same tables: cosine >= 0.9999, relative L2 <= 1e-3
    (the train step's gradient tolerance)."""
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.config import SunLight as JSun
    from nebulae_tpu.core.camera import Camera as JCamera
    from nebulae_tpu.engine.renderer import init_frame_state as jinit
    from nebulae_tpu.engine.renderer import render_frame as jrender
    from nebulae_tpu.passes.gbuffer import make_camera_arrays as jcam_arrays

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer, init_frame_state, render_frame
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays

    kw = dict(width=32, height=32, max_bounces=2, enable_svgf=False, enable_tonemap=False,
              enable_envmap=True, bucket_scheduling=False)
    env = _gradient_envmap(16, 32)
    cam = setup["cam"]
    jr = _jax_renderer(setup, kw)
    jscene = dict(jr.scene)
    jsun = jax.tree.map(jnp.asarray, JSun.default(np))
    jcam = jcam_arrays(JCamera(eye=cam.eye, target=cam.target, fov_y_deg=cam.fov_y_deg), 32, 32)
    jcfg = JCfg(**kw)

    def jloss(e):
        out, _ = jrender({**jscene, "env_map": e}, jr.bvh, jsun, jcam, jinit(jcfg), jcfg)
        return out["hdr"].mean()

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(env))
    cfg = RenderConfig(**kw)
    pr = Renderer(setup["fs"], cfg, device="cpu")
    e = torch.from_numpy(env).requires_grad_(True)
    out, _ = render_frame({**pr.scene, "env_map": e}, pr.tables, pr.sun, make_camera_arrays(cam, 32, 32, "cpu"),
                          init_frame_state(cfg, "cpu"), cfg, device="cpu")
    loss = out["hdr"].mean()
    (g,) = torch.autograd.grad(loss, e)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-3 * abs(float(jl))
    a, b = g.numpy().ravel().astype(np.float64), np.asarray(jg).ravel().astype(np.float64)
    assert np.linalg.norm(b) > 0.0
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    rel = np.linalg.norm(a - b) / np.linalg.norm(b)
    assert cos >= 0.9999 and rel <= 1e-3, f"cos {cos}, rel {rel}"


# ---------------------------------------------------------------------------
# One train step per option
# ---------------------------------------------------------------------------


def _grad_recorder_optax(inner):
    """optax transformation that keeps the last gradients in its state."""
    def init(p):
        return inner.init(p), jax.tree.map(jnp.zeros_like, p)

    def update(g, s, p=None):
        u, s0 = inner.update(g, s[0], p)
        return u, (s0, g)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module", params=TRAINED)
def steps(request, setup):
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.core.camera import Camera as JCamera
    from nebulae_tpu.engine.renderer import init_frame_state as jinit
    from nebulae_tpu.engine.train import make_train_step as jmake
    from nebulae_tpu.engine.train import split_scene_params as jsplit
    from nebulae_tpu.passes.gbuffer import make_camera_arrays as jcam_arrays

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer, init_frame_state
    from nebulae_tpu_torch.engine.train import Adam, make_train_step, split_scene_params
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays

    kw = dict(KW, **OPTIONS[request.param])
    cam = setup["cam"]
    target = np.zeros((S, S, 3), np.float32)
    jr = _jax_renderer(setup, kw)
    jp, jfrozen = jsplit(jr.scene)
    assert "env_map" in jfrozen  # the step keeps the sky frozen
    jp["sun"] = jr.sun
    jstep, jopt = jmake(JCfg(**kw), jfrozen, jr.bvh, optimizer=_grad_recorder_optax(optax.adam(1e-2)))
    jcam = jcam_arrays(JCamera(eye=cam.eye, target=cam.target, fov_y_deg=cam.fov_y_deg), S, S)
    _, jos, _, jloss, _ = jax.jit(jstep)(jp, jopt.init(jp), jcam, jinit(JCfg(**kw)), jnp.asarray(target))
    jgrads = [np.asarray(jos[1][k]) for k in MAT_KEYS] + [np.asarray(getattr(jos[1]["sun"], k)) for k in SUN_KEYS]

    class Recorder(Adam):
        def apply(self, params, grads, opt_state):
            self.grads = [g.detach().clone() for g in grads]
            return super().apply(params, grads, opt_state)

    pr = Renderer(setup["fs"], RenderConfig(**kw), device="cpu", env_map=setup["env"])
    pp, pfrozen = split_scene_params(pr.scene)
    assert "env_map" in pfrozen
    pp["sun"] = pr.sun
    opt = Recorder()
    step, _ = make_train_step(RenderConfig(**kw), pfrozen, pr.tables, optimizer=opt, device="cpu")
    _, _, _, loss, img = step(pp, opt.init(pp), make_camera_arrays(cam, S, S, "cpu"),
                              init_frame_state(RenderConfig(**kw), "cpu"), torch.from_numpy(target))
    return {"name": request.param, "jax_loss": float(jloss), "jax_grads": jgrads, "loss": float(loss),
            "grads": [g.numpy() for g in opt.grads], "img": img}


def test_option_train_loss_matches_jax(steps):
    j, p = steps["jax_loss"], steps["loss"]
    assert np.isfinite(p) and abs(p - j) <= 1e-3 * abs(j), (steps["name"], p, j)
    assert bool(torch.isfinite(steps["img"]).all())


@pytest.mark.parametrize("leaf", MAT_KEYS + SUN_KEYS)
def test_option_train_gradients_match_jax(steps, leaf):
    k = (MAT_KEYS + SUN_KEYS).index(leaf)
    a = steps["grads"][k].ravel().astype(np.float64)
    b = steps["jax_grads"][k].ravel().astype(np.float64)
    assert np.isfinite(a).all()
    if steps["name"] in ("envmap", "all") and leaf == "sky_color":
        # The sky comes from the map: the constant sky colour has no
        # gradient in either package.
        assert not b.any() and not a.any()
        return
    assert np.linalg.norm(b) > 0.0, f"{steps['name']}: JAX gives {leaf} no gradient"
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    rel = np.linalg.norm(a - b) / np.linalg.norm(b)
    assert cos >= 0.9999 and rel <= 1e-3, f"{steps['name']} {leaf}: cos {cos}, rel {rel}"
