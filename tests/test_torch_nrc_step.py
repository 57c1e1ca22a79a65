"""A train step with the neural radiance cache, in the port against JAX's
make_train_step on the CPU.

The small atrium at 64x64, 4 bounces, SVGF and ACES, the cache on, from
JAX's init_frame_state (its init_cache(seed=0)) carried across; MSE to a
zero target, Adam on the material tables and the sun.  The training pass
runs without gradient (JAX's outer gradient reaches the loss only through
the query pass: the query reads the EMA parameters under stop_gradient);
the query's surface inputs keep theirs.  Tolerances: loss to a relative
1e-3, each gradient with a cosine >= 0.999: the step's frame trains the
cache first, and Adam's updates of ulp-different gradients move each
weight by up to 2 lr (tests/test_torch_nrc.py).  The port's own step, with
the query pass's cache asked only on the walked lanes, gives the loss and
every gradient bit-equal to the same step with a full-width resolve.
"""

import numpy as np
import pytest
import torch

S = 64
KW = dict(width=S, height=S, max_bounces=4, enable_svgf=True, enable_tonemap=True, bucket_scheduling=False,
          enable_nrc=True)
MAT_KEYS = ("mat_base_color", "mat_metallic", "mat_roughness", "mat_emissive")
SUN_KEYS = ("direction", "radiance", "tan_half_angle", "sky_color")


@pytest.fixture(scope="module")
def scene():
    from nebulae_tpu_torch.utils.testscenes import atrium_camera, small_atrium

    fs = small_atrium(0)
    return {"fs": fs, "cam": atrium_camera(fs)}


def _jax_renderer(scene, kw):
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.core.scene import FlatScene as JFlatScene
    from nebulae_tpu.engine.renderer import Renderer as JRenderer

    return JRenderer(JFlatScene(**scene["fs"].field_arrays()), JCfg(**kw))


def _jcam(cam):
    from nebulae_tpu.core.camera import Camera as JCamera

    return JCamera(eye=cam.eye, target=cam.target, fov_y_deg=cam.fov_y_deg)


@pytest.fixture(scope="module")
def steps(scene):
    import jax
    import jax.numpy as jnp
    import optax
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.engine.renderer import init_frame_state as jinit
    from nebulae_tpu.engine.train import make_train_step as jmake
    from nebulae_tpu.engine.train import split_scene_params as jsplit
    from nebulae_tpu.passes.gbuffer import make_camera_arrays as jcam_arrays

    def recorder(inner):
        def init(p):
            return inner.init(p), jax.tree.map(jnp.zeros_like, p)

        def update(g, s, p=None):
            u, s0 = inner.update(g, s[0], p)
            return u, (s0, g)

        return optax.GradientTransformation(init, update)

    target = np.zeros((S, S, 3), np.float32)
    jcfg = JCfg(**KW)
    jr = _jax_renderer(scene, KW)
    jp, jfrozen = jsplit(jr.scene)
    jp["sun"] = jr.sun
    jstep, jopt = jmake(jcfg, jfrozen, jr.bvh, optimizer=recorder(optax.adam(1e-2)))
    jstate = jinit(jcfg)
    _, jos, jnew, jloss, _ = jax.jit(jstep)(jp, jopt.init(jp), jcam_arrays(_jcam(scene["cam"]), S, S), jstate,
                                           jnp.asarray(target))
    jgrads = [np.asarray(jos[1][k]) for k in MAT_KEYS] + [np.asarray(getattr(jos[1]["sun"], k)) for k in SUN_KEYS]

    state = jax.tree.map(np.asarray, jstate)
    loss, grads, img, new_state = _port_step(scene, state, target)
    return {"jax_loss": float(jloss), "jax_grads": jgrads, "loss": float(loss), "grads": grads, "img": img,
            "state": new_state, "jax_count": int(jax.tree.leaves(jnew["nrc"]["opt_state"])[0]),
            "inputs": (state, target)}


def _port_step(scene, state, target):
    """The port's step from a frame state's arrays: (loss, gradients of
    MAT_KEYS + SUN_KEYS, image, new frame state)."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.engine.train import Adam, make_train_step, split_scene_params
    from nebulae_tpu_torch.interop import frame_state_from_arrays
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays

    class Recorder(Adam):
        def apply(self, params, grads, opt_state):
            self.grads = [g.detach().clone() for g in grads]
            return super().apply(params, grads, opt_state)

    cfg = RenderConfig(**KW)
    pr = Renderer(scene["fs"], cfg, device="cpu")
    pp, pfrozen = split_scene_params(pr.scene)
    pp["sun"] = pr.sun
    opt = Recorder()
    step, _ = make_train_step(cfg, pfrozen, pr.tables, optimizer=opt, device="cpu")
    _, _, new_state, loss, img = step(pp, opt.init(pp), make_camera_arrays(scene["cam"], S, S, "cpu"),
                                      frame_state_from_arrays(state, "cpu"), torch.from_numpy(target))
    return loss, [g.numpy() for g in opt.grads], img, new_state


def test_nrc_train_step_loss_matches_jax(steps):
    j, p = steps["jax_loss"], steps["loss"]
    assert np.isfinite(p) and abs(p - j) <= 1e-3 * abs(j), (p, j)
    assert bool(torch.isfinite(steps["img"]).all())


@pytest.mark.parametrize("leaf", MAT_KEYS + SUN_KEYS)
def test_nrc_train_step_gradients_match_jax(steps, leaf):
    k = (MAT_KEYS + SUN_KEYS).index(leaf)
    a = steps["grads"][k].ravel().astype(np.float64)
    b = steps["jax_grads"][k].ravel().astype(np.float64)
    assert np.isfinite(a).all() and np.linalg.norm(b) > 0.0
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos >= 0.999, f"{leaf}: cos {cos}"


@pytest.fixture(scope="module")
def full_width_step(scene, steps):
    """The port's step on the same inputs, its query pass resolving the
    cache on every lane."""
    from nebulae_tpu_torch.nrc.cache import query_cache
    from nebulae_tpu_torch.passes import nrc_pathtrace as pnp

    def full_width_resolve(acc, cache_params, surf, view, throughput, terminate, walked, aabb, cfg):
        pred = query_cache(cache_params, surf, view, *aabb, learn_irradiance=cfg.nrc_learn_irradiance)
        return acc + torch.where(terminate[..., None], throughput * pred, 0.0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pnp, "_resolve_walked", full_width_resolve)
        loss, grads, _, _ = _port_step(scene, *steps["inputs"])
    return {"loss": float(loss), "grads": grads}


@pytest.mark.parametrize("leaf", MAT_KEYS + SUN_KEYS)
def test_nrc_train_step_gradients_equal_full_width_resolve(steps, full_width_step, leaf):
    k = (MAT_KEYS + SUN_KEYS).index(leaf)
    assert steps["loss"] == full_width_step["loss"]
    assert np.abs(steps["grads"][k]).max() > 0.0
    np.testing.assert_array_equal(steps["grads"][k], full_width_step["grads"][k])


def test_nrc_train_step_threads_the_cache(steps):
    """The step's frame state carries the trained cache, detached."""
    cache = steps["state"]["nrc"]
    assert cache["opt_state"]["count"] == steps["jax_count"] == 2
    for layer in cache["params"] + cache["ema_params"]:
        for t in layer.values():
            assert not t.requires_grad and t.grad_fn is None


def test_nrc_changes_the_material_gradients(scene, steps):
    """The cache's query reads albedo, roughness and metalness (encoding and
    modulation), so the step's material gradients differ from the plain
    path's."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer, init_frame_state
    from nebulae_tpu_torch.engine.train import Adam, make_train_step, split_scene_params
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays

    class Recorder(Adam):
        def apply(self, params, grads, opt_state):
            self.grads = [g.detach().clone() for g in grads]
            return super().apply(params, grads, opt_state)

    cfg = RenderConfig(**dict(KW, enable_nrc=False))
    pr = Renderer(scene["fs"], cfg, device="cpu")
    pp, pfrozen = split_scene_params(pr.scene)
    pp["sun"] = pr.sun
    opt = Recorder()
    step, _ = make_train_step(cfg, pfrozen, pr.tables, optimizer=opt, device="cpu")
    step(pp, opt.init(pp), make_camera_arrays(scene["cam"], S, S, "cpu"), init_frame_state(cfg, "cpu"),
         torch.zeros((S, S, 3)))
    plain = opt.grads[0].numpy()
    assert np.abs(plain - steps["grads"][0]).max() > 1e-6
