"""The port's train step and a-trous backward (plain K5) against JAX, on the CPU.

Tolerances, each with its reason:
  * plain K5 against jax.vjp of the Pallas kernel (interpret mode) and of
    the XLA step: rtol 1e-5 / atol 1e-6 for a positive cotangent (the same
    weight arithmetic; measured max errors 3.9e-6 and 1.4e-6);
  * the SVGF chain's gradient: rtol 1e-4 / atol 1e-6 (temporal, spatial
    variance and four steps in float32, summed in other orders);
  * the whole step on the 48x48 textured scene, 4 bounces, SVGF, two steps
    with the frame state threaded: loss within a relative 2e-5, each
    gradient with a cosine >= 0.9999 and a relative L2 error <= 1e-3.  The
    measured errors are ~1e-6 (loss) and <= 2.1e-5 (gradients); the margin
    is for a path that flips on an ulp of a hit point, as in
    test_torch_frame.py.  Updated params within atol 1e-6 plus one float32
    ulp wherever the two gradients share a sign (Adam's first step moves by
    lr * sign(g)); the step-2 SVGF history to the frame test's tolerance.
One module-scoped fixture runs JAX's train step (one compile, ~35 s).
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
MAT_KEYS = ("mat_base_color", "mat_metallic", "mat_roughness", "mat_emissive")
SUN_KEYS = ("direction", "radiance", "tan_half_angle", "sky_color")
H, W = 37, 70


def _atrous_inputs(seed=0):
    rng = np.random.default_rng(seed)
    rad = rng.uniform(0, 2, (H, W, 3)).astype(np.float32)
    var = (rng.uniform(0, 1, (H, W)) * 0.05).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dep = (3.0 + 0.001 * xx + 0.0005 * yy + rng.uniform(0, 2e-3, (H, W))).astype(np.float32)
    n = rng.normal(size=(H, W, 3)) * 0.05 + [0, 0, 1]
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    dep[5:9, 10:20] = np.inf
    return rad, var, dep, n


@pytest.mark.parametrize("step", [1, 2, 4, 8])
def test_plain_atrous_bwd_matches_pallas_vjp_and_xla_grad(step):
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.kernels.pallas_svgf import atrous_step_pallas
    from nebulae_tpu.passes.svgf import svgf_atrous_step

    from nebulae_tpu_torch.kernels.svgf import atrous_step

    cfg = JCfg()
    rad, var, dep, n = _atrous_inputs()
    # A positive cotangent, as JAX's own test_pallas_svgf.py uses: with a
    # signed one the 25-tap sums cancel, and the ulp-level differences of
    # n.n' (XLA contracts it into FMAs in the interpreted Pallas kernel),
    # which ^128 amplifies, exceed 1e-5 of the small results.
    gbar = np.random.default_rng(5).uniform(0, 1, (H, W, 3)).astype(np.float32)
    j = [jnp.asarray(x) for x in (rad, var, dep, n)]
    _, vjp = jax.vjp(lambda *a: atrous_step_pallas(*a, step, cfg, interpret=True), *j)
    pallas = [np.asarray(g) for g in vjp(jnp.asarray(gbar))]
    _, vjp_x = jax.vjp(lambda r: svgf_atrous_step(r, *j[1:], step, cfg), j[0])
    xla = np.asarray(vjp_x(jnp.asarray(gbar))[0])

    ins = [torch.from_numpy(x).requires_grad_(True) for x in (rad, var, dep, n)]
    out, _ = atrous_step(*ins, step, (cfg.svgf_phi_color, cfg.svgf_phi_normal, cfg.svgf_phi_depth))
    grads = torch.autograd.grad(out, ins, torch.from_numpy(gbar), allow_unused=True)
    grad_rad = grads[0].numpy()
    np.testing.assert_allclose(grad_rad, pallas[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grad_rad, xla, rtol=1e-5, atol=1e-6)
    for g, ref in zip(grads[1:], pallas[1:]):
        assert g is None and not ref.any()


def test_atrous_output_requires_grad_follows_radiance():
    from nebulae_tpu_torch.kernels.svgf import atrous_step

    rad, var, dep, n = (torch.from_numpy(x) for x in _atrous_inputs())
    phi = (4.0, 128.0, 0.002)
    out, sum_w = atrous_step(rad, var, dep, n, 1, phi)
    assert not out.requires_grad and not sum_w.requires_grad
    out, sum_w = atrous_step(rad.clone().requires_grad_(True), var, dep, n, 1, phi)
    assert out.requires_grad and out.grad_fn is not None and not sum_w.requires_grad
    with torch.no_grad():
        out, _ = atrous_step(rad.clone().requires_grad_(True), var, dep, n, 1, phi)
    assert not out.requires_grad


@pytest.mark.parametrize("second_frame", [False, True])
def test_svgf_chain_gradient_matches(second_frame):
    """d mean((svgf_denoise(hdr) - target)^2) / d hdr against jax.grad,
    from a fresh history and from one frame of history."""
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.passes.svgf import init_history as jinit
    from nebulae_tpu.passes.svgf import svgf_denoise as jden

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.passes.svgf import init_history, svgf_denoise

    jcfg, pcfg = JCfg(), RenderConfig()
    rad, _, dep, n = _atrous_inputs(seed=1)
    hit = np.isfinite(dep)
    target = np.random.default_rng(3).uniform(0, 1, (H, W, 3)).astype(np.float32)
    jh, ph = jinit(H, W), init_history(H, W, "cpu")
    if second_frame:
        prev, _, _, _ = _atrous_inputs(seed=2)
        _, jh = jden(jnp.asarray(prev), jnp.asarray(dep), jnp.asarray(n), jh, jcfg, hit=jnp.asarray(hit))
        _, ph = svgf_denoise(torch.from_numpy(prev), torch.from_numpy(dep), torch.from_numpy(n), ph, pcfg,
                             hit=torch.from_numpy(hit))

    def jloss(r):
        out, _ = jden(r, jnp.asarray(dep), jnp.asarray(n), jh, jcfg, hit=jnp.asarray(hit))
        return jnp.mean((out - target) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(rad))
    r = torch.from_numpy(rad).requires_grad_(True)
    out, _ = svgf_denoise(r, torch.from_numpy(dep), torch.from_numpy(n), ph, pcfg, hit=torch.from_numpy(hit))
    loss = torch.mean((out - torch.from_numpy(target)) ** 2)
    (g,) = torch.autograd.grad(loss, r)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case", ["clip_lo", "clip_hi", "clip_inside", "clip_below", "max_tie", "max_above"])
def test_clamp_helpers_take_jax_gradient_at_ties(case):
    from nebulae_tpu_torch.core.math import clip, maximum

    lo, hi = 0.02, 1.0
    x = {"clip_lo": lo, "clip_hi": hi, "clip_inside": 0.5, "clip_below": 0.0,
         "max_tie": 0.0, "max_above": 0.25}[case]
    xs = np.float32([x, x])
    if case.startswith("clip"):
        jfn, pfn = (lambda v: jnp.clip(v, lo, hi)), (lambda v: clip(v, lo, hi))
    else:
        jfn, pfn = (lambda v: jnp.maximum(v, 0.0)), (lambda v: maximum(v, 0.0))
    jg = np.asarray(jax.grad(lambda v: jfn(v).sum())(jnp.asarray(xs)))
    t = torch.from_numpy(xs).requires_grad_(True)
    (g,) = torch.autograd.grad(pfn(t).sum(), t)
    np.testing.assert_array_equal(g.numpy(), jg)
    np.testing.assert_array_equal(pfn(t).detach().numpy(), np.asarray(jfn(jnp.asarray(xs))))
    assert pfn(t.detach()).grad_fn is None


@pytest.mark.parametrize("width", [1, 3, 4])
def test_gather_rows_gradient_is_the_index_backward(width):
    """The material gather's bincount backward sums the same cotangents as
    the backward of plain indexing."""
    from nebulae_tpu_torch.core.surface import gather_rows

    rng = np.random.default_rng(width)
    shape = (7,) if width == 1 else (7, width)
    table = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 5, 1000))
    cot = torch.from_numpy(rng.normal(size=(1000,) + shape[1:]).astype(np.float32))
    t1, t2 = table.clone().requires_grad_(True), table.clone().requires_grad_(True)
    out = gather_rows(t1, idx)
    np.testing.assert_array_equal(out.detach().numpy(), table[idx].numpy())
    (g1,) = torch.autograd.grad(out, t1, cot)
    (g2,) = torch.autograd.grad(t2[idx], t2, cot)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-5, atol=1e-5)
    assert not g1[5:].any()
    with torch.no_grad():
        assert gather_rows(t1, idx).grad_fn is None


def _camera(fs, cls):
    lo, hi = fs.aabb_min, fs.aabb_max
    c = (lo + hi) / 2
    c[1] = 0.5
    ext = float((hi - lo).max())
    return cls(eye=(c + np.array([0.12, 0.15, 0.22]) * ext).astype(np.float32), target=c.astype(np.float32))


def _grad_recorder_optax(inner):
    """optax transformation that keeps the last gradients in its state."""
    def init(p):
        return inner.init(p), jax.tree.map(jnp.zeros_like, p)

    def update(g, s, p=None):
        u, s0 = inner.update(g, s[0], p)
        return u, (s0, g)

    return optax.GradientTransformation(init, update)


def _recorder_adam():
    from nebulae_tpu_torch.engine.train import Adam

    class Recorder(Adam):
        def apply(self, params, grads, opt_state):
            self.grads = [g.detach().clone() for g in grads]
            return super().apply(params, grads, opt_state)

    return Recorder()


def _jleaves(tree):
    """JAX params-like tree (numpy) -> leaves in the port's order."""
    return [np.asarray(tree[k]) for k in MAT_KEYS] + [np.asarray(getattr(tree["sun"], k)) for k in SUN_KEYS]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def steps():
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.core.camera import Camera as JCamera
    from nebulae_tpu.core.scene import FlatScene as JFlatScene
    from nebulae_tpu.engine.renderer import Renderer as JRenderer
    from nebulae_tpu.engine.renderer import init_frame_state as jinit
    from nebulae_tpu.engine.train import make_train_step as jmake
    from nebulae_tpu.engine.train import split_scene_params as jsplit
    from nebulae_tpu.passes.gbuffer import make_camera_arrays as jcam_arrays

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.core.camera import Camera
    from nebulae_tpu_torch.engine.renderer import Renderer, init_frame_state
    from nebulae_tpu_torch.engine.train import flatten_params, make_train_step, split_scene_params
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays
    from nebulae_tpu_torch.utils.testscenes import textured_scene

    fs = textured_scene(seed=0)
    cam = _camera(fs, Camera)
    target = np.zeros((S, S, 3), np.float32)

    jr = JRenderer(JFlatScene(**fs.field_arrays()), JCfg(**KW))
    jp, jfrozen = jsplit(jr.scene)
    jp["sun"] = jr.sun
    jstep, jopt = jmake(JCfg(**KW), jfrozen, jr.bvh, optimizer=_grad_recorder_optax(optax.adam(1e-2)))
    jstep = jax.jit(jstep)
    jcam = jcam_arrays(JCamera(eye=cam.eye, target=cam.target, fov_y_deg=cam.fov_y_deg), S, S)
    jos, jst = jopt.init(jp), jinit(JCfg(**KW))
    jax_out = []
    for _ in range(2):
        jp, jos, jst, loss, _img = jstep(jp, jos, jcam, jst, jnp.asarray(target))
        jax_out.append({"loss": float(loss), "grads": _jleaves(_np(jos[1])), "params": _np(jp),
                        "opt_state": _np(jos[0]), "state": _np(jst)})

    pr = Renderer(fs, RenderConfig(**KW), device="cpu")
    pp, pfrozen = split_scene_params(pr.scene)
    pp["sun"] = pr.sun
    opt = _recorder_adam()
    step, _ = make_train_step(RenderConfig(**KW), pfrozen, pr.tables, optimizer=opt, device="cpu")
    pcam = make_camera_arrays(cam, S, S, "cpu")
    pos, pst = opt.init(pp), init_frame_state(RenderConfig(**KW), "cpu")
    port_out = []
    for _ in range(2):
        pp, pos, pst, loss, img = step(pp, pos, pcam, pst, torch.from_numpy(target))
        port_out.append({"loss": float(loss), "grads": [g.numpy() for g in opt.grads],
                         "params": [t.numpy() for t in flatten_params(pp)], "state": pst, "img": img})
    return {"jax": jax_out, "port": port_out, "step": step, "opt": opt, "cam": pcam,
            "target": torch.from_numpy(target), "renderer": pr, "frozen": pfrozen}


@pytest.mark.parametrize("i", [0, 1])
def test_train_loss_matches(steps, i):
    j, p = steps["jax"][i]["loss"], steps["port"][i]["loss"]
    assert abs(p - j) <= 2e-5 * abs(j)


@pytest.mark.parametrize("leaf", MAT_KEYS + SUN_KEYS)
def test_train_gradients_match(steps, leaf):
    k = (MAT_KEYS + SUN_KEYS).index(leaf)
    for i in range(2):
        a = steps["port"][i]["grads"][k].ravel().astype(np.float64)
        b = steps["jax"][i]["grads"][k].ravel().astype(np.float64)
        assert np.linalg.norm(b) > 0.0, f"step {i}: JAX gives {leaf} no gradient"
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert cos >= 0.9999 and rel <= 1e-3, f"step {i} {leaf}: cos {cos}, rel {rel}"


def _assert_params_close(port_leaves, jax_tree, port_grads, jax_grads):
    for name, a, b, ga, gb in zip(MAT_KEYS + SUN_KEYS, port_leaves, _jleaves(jax_tree), port_grads, jax_grads):
        same = np.sign(ga) == np.sign(gb)
        np.testing.assert_allclose(a[same], b[same], rtol=1.2e-7, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("i", [0, 1])
def test_train_updated_params_match(steps, i):
    p, j = steps["port"][i], steps["jax"][i]
    _assert_params_close(p["params"], j["params"], p["grads"], j["grads"])


def test_train_step2_svgf_history_matches(steps):
    hist_p = steps["port"][1]["state"]["svgf"]
    hist_j = steps["jax"][1]["state"]["svgf"]
    for k in ("radiance", "moments", "histlen", "depth", "normal"):
        a, b = hist_p[k].numpy(), hist_j[k]
        frac = np.isclose(a, b, rtol=1e-3, atol=1e-4).reshape(S * S, -1).all(-1).mean()
        assert frac >= 0.99, f"{k}: {frac:.4f} of pixels within tolerance"
    assert steps["port"][1]["state"]["frame"] == 2 and not steps["port"][1]["state"]["reset_history"]


def test_train_outputs_are_detached(steps):
    out = steps["port"][1]
    assert not out["img"].requires_grad
    for v in out["state"]["svgf"].values():
        assert not v.requires_grad and v.grad_fn is None


def test_step2_from_jax_state_matches_jax(steps):
    """JAX's step-1 (params, opt_state, state), carried over through interop,
    gives the port JAX's step 2."""
    from nebulae_tpu_torch.engine.train import flatten_params
    from nebulae_tpu_torch.interop import adam_state_from_optax, frame_state_from_arrays, params_from_arrays

    j1, j2 = steps["jax"]
    params = params_from_arrays(j1["params"], "cpu")
    opt_state = adam_state_from_optax(j1["opt_state"], "cpu")
    assert opt_state["count"] == 1
    state = frame_state_from_arrays(j1["state"], "cpu")
    new_params, new_opt, _state, loss, _img = steps["step"](params, opt_state, steps["cam"], state,
                                                           steps["target"])
    assert abs(float(loss) - j2["loss"]) <= 2e-5 * abs(j2["loss"])
    grads = [g.numpy() for g in steps["opt"].grads]
    for k, (a, b) in enumerate(zip(grads, j2["grads"])):
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel <= 1e-3, f"{(MAT_KEYS + SUN_KEYS)[k]}: rel {rel}"
    _assert_params_close([t.numpy() for t in flatten_params(new_params)], j2["params"], grads, j2["grads"])
    assert new_opt["count"] == 2


def test_train_sun_false_moves_the_sun_as_optax(steps):
    """With train_sun=False the sun's gradients are zeros, not None: from a
    JAX state whose sun moments are not zero the sun keeps moving, by
    optax's own update for a zero gradient."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.train import make_train_step
    from nebulae_tpu_torch.interop import adam_state_from_optax, frame_state_from_arrays, params_from_arrays

    j1 = steps["jax"][0]
    step, _ = make_train_step(RenderConfig(**KW), steps["frozen"], steps["renderer"].tables,
                              train_sun=False, device="cpu")
    new_params, _, _, _, _ = step(params_from_arrays(j1["params"], "cpu"),
                                  adam_state_from_optax(j1["opt_state"], "cpu"), steps["cam"],
                                  frame_state_from_arrays(j1["state"], "cpu"), steps["target"])
    jsun = j1["params"]["sun"]
    zeros = jax.tree.map(jnp.zeros_like, jsun)
    adam = j1["opt_state"][0]
    upd, _ = optax.scale_by_adam().update(zeros, optax.ScaleByAdamState(adam.count, adam.mu["sun"], adam.nu["sun"]))
    for k in SUN_KEYS:
        expect = np.asarray(getattr(jsun, k)) - 1e-2 * np.asarray(getattr(upd, k))
        got = getattr(new_params["sun"], k).numpy()
        assert np.abs(got - np.asarray(getattr(jsun, k))).max() > 1e-4, f"sun {k} did not move"
        np.testing.assert_allclose(got, expect, rtol=1.2e-7, atol=1e-6, err_msg=k)


def test_base_color_gradient_matches_finite_difference(steps):
    """d mean(hdr) / d mat_base_color of the port's direct-lit frame against
    a central finite difference of its own forward (eps 1e-3)."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import init_frame_state, render_frame

    r = steps["renderer"]
    cfg = RenderConfig(**{**KW, "enable_gi": False, "enable_svgf": False, "enable_tonemap": False})
    state = init_frame_state(cfg, "cpu")

    def loss(base):
        scene = {**r.scene, "mat_base_color": base}
        out, _ = render_frame(scene, r.tables, r.sun, steps["cam"], state, cfg, device="cpu")
        return out["hdr"].mean()

    base = r.scene["mat_base_color"].clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(base), base)
    assert float(g.abs().max()) > 1e-4
    eps = 1e-3
    with torch.no_grad():
        for mat, ch in [(0, 0), (1, 1), (2, 2)]:
            bp, bm = base.detach().clone(), base.detach().clone()
            bp[mat, ch] += eps
            bm[mat, ch] -= eps
            fd = (float(loss(bp)) - float(loss(bm))) / (2 * eps)
            assert abs(float(g[mat, ch]) - fd) < 2e-3 * max(1.0, abs(fd)), (mat, ch, float(g[mat, ch]), fd)


def test_render_frame_differentiable_and_renderer_is_not(steps):
    from nebulae_tpu_torch.config import SunLight
    from nebulae_tpu_torch.engine.renderer import init_frame_state, render_frame

    r = steps["renderer"]
    sun = SunLight(*(t.clone().requires_grad_(True) for t in r.sun.leaves()))
    cfg = dataclasses.replace(r.cfg, enable_svgf=True)
    out, state = render_frame(r.scene, r.tables, sun, steps["cam"], init_frame_state(cfg, "cpu"), cfg,
                              device="cpu")
    assert out["denoised"].requires_grad and out["ldr"].requires_grad
    g = torch.autograd.grad(out["denoised"].mean(), sun.leaves())
    assert all(float(x.abs().max()) > 0.0 for x in g)
    from nebulae_tpu_torch.core.camera import Camera

    lo, hi = r.scene["aabb_min"].numpy(), r.scene["aabb_max"].numpy()
    cam = Camera(eye=(hi + (hi - lo) * 0.2).astype(np.float32), target=((lo + hi) / 2).astype(np.float32))
    r.sun = sun
    try:
        outs = r.render(cam)
    finally:
        r.sun = SunLight(*(t.detach() for t in sun.leaves()))
    assert not any(v.requires_grad for v in outs.values())
