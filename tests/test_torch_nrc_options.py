"""The neural radiance cache under each frame option, in the port against
the JAX Renderer on the CPU.

The small atrium (utils.testscenes.small_atrium, where the spread heuristic
hands a real share of the paths to the cache) at 48x48, 4 bounces, SVGF and
ACES, the cache on; the same camera on both sides.  The options:
  * jitter_primary: the query pass runs inside the jitter loop, on each
    sample's own jittered G-buffer, and each sample folds in the sky along
    its own missed rays;
  * fast_bounce_shading: both NRC passes reach it through nee_bounce_step;
  * enable_envmap with JAX's app's procedural sky (utils.testscenes.
    procedural_envmap), which both NRC passes read where a bounce misses.
Two frames each; the port renders each from JAX's frame state before it
(cache, SVGF history and frame counter, interop.frame_state_from_arrays),
so a frame holds the rounding of its own training step only: left to run
on, the two caches part by Adam's steps on ulp-different gradients (an
Adam step moves a weight by up to 2 lr where a near-zero gradient's sign
differs; ROADMAP Queue 3), and the later losses by more than 1e-3.
Tolerances (tests/test_torch_nrc_frame.py's): the hit mask equal, ldr on
>= 99% of pixels within rtol 1e-2 / atol 1e-3, nrc_loss to a relative
1e-3, nrc_query_frac within 0.5%.  The RNG state after each frame's
samples equals, bit for bit, JAX's init_rng advanced by the frame's draws
(2 for each sample's jitter, 5 a bounce vertex and 2 at the last).
The NRC train step with enable_envmap (MSE to a zero target, Adam on the
material tables and the sun; tests/test_torch_nrc_step.py's tolerances):
loss to a relative 1e-3, each gradient at a cosine >= 0.999; the sky
colour's gradient is zero on both sides, as the sky comes from the map.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

S = 48
KW = dict(width=S, height=S, max_bounces=4, enable_svgf=True, enable_tonemap=True, bucket_scheduling=False,
          enable_nrc=True)
OPTIONS = {
    "jitter": dict(jitter_primary=True),
    "fast": dict(fast_bounce_shading=True),
    "envmap": dict(enable_envmap=True),
}
MAT_KEYS = ("mat_base_color", "mat_metallic", "mat_roughness", "mat_emissive")
SUN_KEYS = ("direction", "radiance", "tan_half_angle", "sky_color")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU work on one thread, the count restored after the
    module: beside the suite's other workers a multi-threaded op of these
    small frames mostly waits for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    from nebulae_tpu_torch.utils.testscenes import atrium_camera, procedural_envmap, small_atrium

    fs = small_atrium(0)
    return {"fs": fs, "cam": atrium_camera(fs), "env": procedural_envmap()}


def _jax_renderer(scene, kw):
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.core.scene import FlatScene as JFlatScene
    from nebulae_tpu.engine.renderer import Renderer as JRenderer

    jr = JRenderer(JFlatScene(**scene["fs"].field_arrays()), JCfg(**kw))
    jr.scene["env_map"] = jnp.asarray(scene["env"])  # as JAX's app sets it
    return jr


def _jcam(cam):
    from nebulae_tpu.core.camera import Camera as JCamera

    return JCamera(eye=cam.eye, target=cam.target, fov_y_deg=cam.fov_y_deg)


def jax_and_port_frames(scene, kw, n=2):
    """n frames of JAX's Renderer from its init_frame_state (the cache from
    init_cache(seed=0)), and of the port's, each from the frame state JAX's
    frame started from: (JAX's outputs, the port's outputs, the RNG state
    each port frame's samples leave, the cache step counts after the last
    frame: the port's, JAX's)."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine import renderer as rmod
    from nebulae_tpu_torch.interop import frame_state_from_arrays

    jr = _jax_renderer(scene, kw)
    jax_out, states = [], []
    for _ in range(n):
        states.append(jax.tree.map(np.asarray, jr.state))
        jax_out.append({k: np.asarray(v) for k, v in jr.render(_jcam(scene["cam"])).items()})
    pr = rmod.Renderer(scene["fs"], RenderConfig(**kw), device="cpu", env_map=scene["env"])
    rngs, port_out = [], []
    trace_samples = rmod.trace_samples

    def spy(*args, **kwargs):
        radiance, rng_state = trace_samples(*args, **kwargs)
        rngs.append(rng_state)
        return radiance, rng_state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rmod, "trace_samples", spy)
        for state in states:
            pr.state = frame_state_from_arrays(state, "cpu")
            port_out.append({k: v.numpy() for k, v in pr.render(scene["cam"]).items()})
    counts = (pr.state["nrc"]["opt_state"]["count"], int(jax.tree.leaves(jr.state["nrc"]["opt_state"])[0]))
    return jax_out, port_out, rngs, counts


@pytest.fixture(scope="module", params=list(OPTIONS))
def frames(request, scene):
    kw = dict(KW, **OPTIONS[request.param])
    jax_out, port_out, rngs, _ = jax_and_port_frames(scene, kw)
    return {"name": request.param, "kw": kw, "jax": jax_out, "port": port_out, "rng": rngs}


def assert_nrc_frame_close(p, j, what):
    """The NRC frame tolerance against a reference frame."""
    np.testing.assert_array_equal(p["hit"], j["hit"], err_msg=what)
    assert np.isfinite(p["ldr"]).all(), what
    frac = np.isclose(p["ldr"], j["ldr"], rtol=1e-2, atol=1e-3).all(-1).mean()
    assert frac >= 0.99, f"{what}: {frac:.4f} of pixels within tolerance"
    assert float(j["nrc_loss"]) > 0.0, what
    assert abs(float(p["nrc_loss"]) - float(j["nrc_loss"])) <= 1e-3 * abs(float(j["nrc_loss"])), what
    assert abs(float(p["nrc_query_frac"]) - float(j["nrc_query_frac"])) <= 0.005, what


def jax_rng_after_samples(kw, frame):
    """JAX's init_rng for `frame` advanced by one frame's query-pass draws."""
    from nebulae_tpu.core import rng as jrng

    w, h = kw["width"], kw["height"]
    ys, xs = np.meshgrid(np.arange(h, dtype=np.uint32), np.arange(w, dtype=np.uint32), indexing="ij")
    state = jrng.init_rng(jnp.asarray(xs.reshape(-1)), jnp.asarray(ys.reshape(-1)), w, jnp.uint32(frame))
    per_sample = (2 if kw.get("jitter_primary") else 0) + 5 * (kw["max_bounces"] - 1) + 2
    for _ in range(per_sample * kw.get("spp", 1)):
        state, _ = jrng.next_float(state)
    return np.asarray(state).astype(np.int64)


@pytest.mark.parametrize("i", [0, 1])
def test_nrc_option_frame_matches_jax(frames, i):
    assert_nrc_frame_close(frames["port"][i], frames["jax"][i], f"{frames['name']} frame {i}")


def test_nrc_option_rng_state_matches_jax(frames):
    for i, rng in enumerate(frames["rng"]):
        np.testing.assert_array_equal(rng.numpy(), jax_rng_after_samples(frames["kw"], i))


# ---------------------------------------------------------------------------
# The NRC train step with the env-map sky
# ---------------------------------------------------------------------------


def _grad_recorder_optax(inner):
    """optax transformation that keeps the last gradients in its state."""
    def init(p):
        return inner.init(p), jax.tree.map(jnp.zeros_like, p)

    def update(g, s, p=None):
        u, s0 = inner.update(g, s[0], p)
        return u, (s0, g)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def envmap_step(scene):
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.engine.renderer import init_frame_state as jinit
    from nebulae_tpu.engine.train import make_train_step as jmake
    from nebulae_tpu.engine.train import split_scene_params as jsplit
    from nebulae_tpu.passes.gbuffer import make_camera_arrays as jcam_arrays

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.engine.train import Adam, make_train_step, split_scene_params
    from nebulae_tpu_torch.interop import frame_state_from_arrays
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays

    kw = dict(KW, **OPTIONS["envmap"])
    target = np.zeros((S, S, 3), np.float32)
    jcfg = JCfg(**kw)
    jr = _jax_renderer(scene, kw)
    jp, jfrozen = jsplit(jr.scene)
    assert "env_map" in jfrozen  # the step keeps the sky frozen
    jp["sun"] = jr.sun
    jstep, jopt = jmake(jcfg, jfrozen, jr.bvh, optimizer=_grad_recorder_optax(optax.adam(1e-2)))
    jstate = jinit(jcfg)
    _, jos, _, jloss, _ = jax.jit(jstep)(jp, jopt.init(jp), jcam_arrays(_jcam(scene["cam"]), S, S), jstate,
                                        jnp.asarray(target))
    jgrads = [np.asarray(jos[1][k]) for k in MAT_KEYS] + [np.asarray(getattr(jos[1]["sun"], k)) for k in SUN_KEYS]

    class Recorder(Adam):
        def apply(self, params, grads, opt_state):
            self.grads = [g.detach().clone() for g in grads]
            return super().apply(params, grads, opt_state)

    cfg = RenderConfig(**kw)
    pr = Renderer(scene["fs"], cfg, device="cpu", env_map=scene["env"])
    pp, pfrozen = split_scene_params(pr.scene)
    assert "env_map" in pfrozen
    pp["sun"] = pr.sun
    opt = Recorder()
    step, _ = make_train_step(cfg, pfrozen, pr.tables, optimizer=opt, device="cpu")
    state = frame_state_from_arrays(jax.tree.map(np.asarray, jstate), "cpu")
    _, _, new_state, loss, img = step(pp, opt.init(pp), make_camera_arrays(scene["cam"], S, S, "cpu"), state,
                                      torch.from_numpy(target))
    return {"jax_loss": float(jloss), "jax_grads": jgrads, "loss": float(loss),
            "grads": [g.numpy() for g in opt.grads], "img": img, "state": new_state}


def test_nrc_envmap_train_loss_matches_jax(envmap_step):
    j, p = envmap_step["jax_loss"], envmap_step["loss"]
    assert np.isfinite(p) and abs(p - j) <= 1e-3 * abs(j), (p, j)
    assert bool(torch.isfinite(envmap_step["img"]).all())
    assert envmap_step["state"]["nrc"]["opt_state"]["count"] > 0


@pytest.mark.parametrize("leaf", MAT_KEYS + SUN_KEYS)
def test_nrc_envmap_train_gradients_match_jax(envmap_step, leaf):
    k = (MAT_KEYS + SUN_KEYS).index(leaf)
    a = envmap_step["grads"][k].ravel().astype(np.float64)
    b = envmap_step["jax_grads"][k].ravel().astype(np.float64)
    assert np.isfinite(a).all()
    if leaf == "sky_color":
        # The sky comes from the map: the constant sky colour has no
        # gradient in either package.
        assert not b.any() and not a.any()
        return
    assert np.linalg.norm(b) > 0.0, f"JAX gives {leaf} no gradient"
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos >= 0.999, f"{leaf}: cos {cos}"
