"""The port's neural radiance cache against the JAX package's, on the CPU:
the encodings, the bf16 MLP and its gradients, the optimizer, one cache
step, and both NRC passes.  Inputs come from a seeded numpy generator; the
cache starts from JAX's init_cache(seed=0), carried across.  Tolerances:
  * oct_encode and the encodings: rtol 1e-6 / atol 1e-7 (the same float32
    elementwise arithmetic), zero normals included;
  * apply_mlp: rtol 1e-5 on >= 99.9% of outputs and 1e-2 everywhere (the
    bf16 products are exact in float32; only the order of their float32
    sums differs, which can move a bf16 rounding of an activation);
  * its gradients against jax.grad under the cache's own loss (relative L2
    on a batch of 16,384 records): >= 99% of weight and input gradients
    equal bit for bit (both rounded to bf16; the port's CPU sums are exact,
    XLA's float32 sums are not), cosine >= 0.9999 per layer for those and
    the bias gradients.  Under a cotangent of random sign the sums cancel,
    XLA's float32 error grows relative to them and only ~94% of the first
    layer's weight gradients round to the same bf16 (measured): there the
    test holds bf16 representability and the cosines;
  * clip_by_global_norm: rtol 1e-6, with the norm above and below 1;
  * one train_cache_step: loss to a relative 1e-5, params and EMA to a
    relative L2 error <= 1e-3 (measured 2.3e-7 and 5.1e-7); three steps:
    the later losses to 1e-3 and the params to 1e-2, as the training pass
    (Adam's first steps move each weight by about lr * sign(g), so an ulp
    in a near-zero gradient moves a weight by up to 2 lr);
  * the query pass from one G-buffer (the small atrium at 48x48, 4
    bounces), inline and latched: the RNG state bit-equal, radiance on >=
    99% of pixels within rtol 1e-3 / atol 1e-4, term_bounce and n_vert on
    >= 99.9%, query_frac within 0.5%: an ulp in a hit point can flip a
    handoff or a Russian roulette;
  * the training pass (7 vertices, 4 batches of 4096 records): the RNG
    state bit-equal, the loss to a relative 1e-3, the params after its
    optimizer steps to a relative L2 error <= 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

S = 48
KW = dict(width=S, height=S, max_bounces=4, enable_svgf=False, enable_tonemap=False,
          bucket_scheduling=False, nrc_records_per_iteration=4096)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v[:7] = [[0, 0, 0], [0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 0, 0], [0, -1, 0], [0.6, -0.8, 0.0]]
    return v.astype(np.float32)


def _jax_params(seed=0):
    from nebulae_tpu.nrc.cache import init_cache

    return jax.tree.map(np.asarray, init_cache(seed=seed))


def _port_params(jparams):
    from nebulae_tpu_torch.interop import mlp_params_from_arrays

    return mlp_params_from_arrays(jparams, "cpu")


def _close(a, b, rtol, atol):
    return np.isclose(a, b, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Encodings
# ---------------------------------------------------------------------------


def test_oct_encode_matches_jax():
    from nebulae_tpu.core import math as jmath

    from nebulae_tpu_torch.core.math import oct_encode

    n = _unit(np.random.default_rng(1), 4096)
    ref = np.asarray(jmath.oct_encode(jnp.asarray(n), jnp))
    out = oct_encode(_t(n)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(out[0], [0.0, 0.0])


def test_oct_encode_gradient_splits_the_tie_as_jax():
    """At a zero vector the 1e-12 floor ties nothing, but at denom == 1e-12
    jnp.maximum gives half the gradient to each side: so does the port."""
    from nebulae_tpu.core import math as jmath

    from nebulae_tpu_torch.core.math import oct_encode

    n = np.array([[5e-13, 2.5e-13, 2.5e-13], [0.3, -0.4, 0.5]], np.float32)
    jg = jax.grad(lambda v: jmath.oct_encode(v, jnp).sum())(jnp.asarray(n))
    x = _t(n).requires_grad_(True)
    (g,) = torch.autograd.grad(oct_encode(x).sum(), x)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("part", ["normalize_position", "triangle_wave", "oneblob", "unit_to_01", "encode_query"])
def test_encoding_matches_jax(part):
    from nebulae_tpu.nrc import encoding as je

    from nebulae_tpu_torch.nrc import encoding as pe

    rng = np.random.default_rng(2)
    n = 2048
    lo, hi = np.array([-3.0, -0.2, -2.5], np.float32), np.array([3.5, 2.0, 2.5], np.float32)
    pos = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    x01 = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    nrm, view = _unit(rng, n), _unit(rng, n)[::-1].copy()
    rough = rng.uniform(0.02, 1.0, n).astype(np.float32)
    alb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    spec = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    J, T = jnp.asarray, _t
    if part == "normalize_position":
        ref, out = je.normalize_position(J(pos), J(lo), J(hi)), pe.normalize_position(T(pos), T(lo), T(hi))
    elif part == "triangle_wave":
        ref, out = je.triangle_wave_encode(J(x01)), pe.triangle_wave_encode(T(x01))
    elif part == "oneblob":
        ref, out = je.oneblob_encode(J(x01)), pe.oneblob_encode(T(x01))
    elif part == "unit_to_01":
        ref, out = je.unit_to_01(J(nrm)), pe.unit_to_01(T(nrm))
    else:
        ref = je.encode_query(J(pos), J(nrm), J(view), J(rough), J(alb), J(spec), J(lo), J(hi))
        out = pe.encode_query(T(pos), T(nrm), T(view), T(rough), T(alb), T(spec), T(lo), T(hi))
        assert out.shape == (n, pe.encoded_dim()) and pe.encoded_dim() == je.encoded_dim() == 59
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# The MLP
# ---------------------------------------------------------------------------


def _mlp_inputs(n=1024, seed=3):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (n, 59)).astype(np.float32)


def test_init_mlp_shapes_and_scale():
    from nebulae_tpu_torch.nrc.cache import init_cache
    from nebulae_tpu_torch.nrc.mlp import init_mlp

    params = init_mlp(torch.Generator().manual_seed(0), 59)
    assert [tuple(p["w"].shape) for p in params] == [(59, 64)] + [(64, 64)] * 4 + [(64, 3)]
    assert all(not p["b"].any() for p in params)
    std = float(torch.cat([p["w"].reshape(-1) for p in params[1:5]]).std())
    assert abs(std - (2.0 / 64) ** 0.5) < 0.01
    a, b = init_cache(seed=0), init_cache(seed=0)
    assert all(torch.equal(x["w"], y["w"]) for x, y in zip(a["params"], b["params"]))
    assert all(torch.equal(x["w"], y["w"]) for x, y in zip(a["params"], a["ema_params"]))
    assert not torch.equal(init_cache(seed=1)["params"][0]["w"], a["params"][0]["w"])


def test_apply_mlp_matches_jax():
    from nebulae_tpu.nrc.mlp import apply_mlp as japply

    from nebulae_tpu_torch.nrc.mlp import apply_mlp

    jp = _jax_params()["params"]
    x = _mlp_inputs(8192)
    ref = np.asarray(jax.jit(japply)(jp, jnp.asarray(x)))
    out = apply_mlp(_port_params(jp), _t(x)).numpy()
    assert out.shape == (8192, 3) and (out > 0).all()
    assert _close(out, ref, 1e-5, 0.0).mean() >= 0.999
    np.testing.assert_allclose(out, ref, rtol=1e-2)
    # A leading batch shape passes through.
    np.testing.assert_array_equal(apply_mlp(_port_params(jp), _t(x).reshape(64, 128, 59)).numpy().reshape(-1, 3),
                                  out)


def test_apply_mlp_softplus_is_logaddexp():
    """jax.nn.softplus is logaddexp(x, 0); F.softplus turns linear above 20
    and differs from it there by up to an ulp."""
    from nebulae_tpu_torch.nrc.mlp import apply_mlp

    params = [{"w": torch.eye(3), "b": torch.zeros(3)}]
    x = torch.tensor([[-30.0, 0.0, 25.0]])
    ref = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(apply_mlp(params, x).numpy(), ref)


def _relative_l2(pred, target):
    """train_cache_step's loss, over the batch (either package's arrays)."""
    denom = (pred.detach() if isinstance(pred, torch.Tensor) else jax.lax.stop_gradient(pred)) ** 2 + 1e-2
    return ((pred - target) ** 2 / denom).mean(-1).sum() / pred.shape[0]


@pytest.fixture(scope="module", params=["cache loss", "random sign"])
def mlp_grads(request):
    from nebulae_tpu.nrc.mlp import apply_mlp as japply

    from nebulae_tpu_torch.nrc.mlp import apply_mlp

    n = 16384
    jp = _jax_params()["params"]
    x = _mlp_inputs(n)
    rng = np.random.default_rng(4)
    if request.param == "cache loss":
        t = (rng.uniform(0.0, 3.0, (n, 3)) ** 2).astype(np.float32)

        def jloss(p, xx):
            return _relative_l2(japply(p, xx), jnp.asarray(t))

        def ploss(out):
            return _relative_l2(out, _t(t))
    else:
        c = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)

        def jloss(p, xx):
            return (japply(p, xx) * jnp.asarray(c)).sum()

        def ploss(out):
            return (out * _t(c)).sum()

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    pp = [{k: t.clone().requires_grad_(True) for k, t in layer.items()} for layer in _port_params(jp)]
    xt = _t(x).requires_grad_(True)
    leaves = [t for layer in pp for t in (layer["w"], layer["b"])]
    grads = torch.autograd.grad(ploss(apply_mlp(pp, xt)), [xt] + leaves)
    return {"name": request.param,
            "jax": [np.asarray(jgx)] + [np.asarray(layer[k]) for layer in jgp for k in ("w", "b")],
            "port": [g.numpy() for g in grads]}


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


@pytest.mark.parametrize("which", ["x"] + [f"{k}{i}" for i in range(6) for k in ("w", "b")])
def test_apply_mlp_gradients_match_jax(mlp_grads, which):
    names = ["x"] + [f"{k}{i}" for i in range(6) for k in ("w", "b")]
    k = names.index(which)
    a, b = mlp_grads["port"][k], mlp_grads["jax"][k]
    assert np.isfinite(a).all() and np.linalg.norm(b) > 0
    if which[0] in "xw":
        # JAX's transpose rounds these to bf16; so does the port.
        np.testing.assert_array_equal(_bf16(b), b)
        np.testing.assert_array_equal(_bf16(a), a)
        if mlp_grads["name"] == "cache loss":
            assert (a == b).mean() >= 0.99, f"{which}: {(a == b).mean():.4f} equal"
    else:
        assert not (_bf16(a) == a).all(), "bias gradients stay float32"
    a64, b64 = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    assert a64 @ b64 / (np.linalg.norm(a64) * np.linalg.norm(b64)) >= 0.9999


def test_mlp_backward_without_input_gradient():
    """Weights only (the cache's own step): the same weight gradients as
    with the input's, and no input gradient is formed."""
    from nebulae_tpu_torch.nrc.mlp import apply_mlp

    pp = [{k: t.clone().requires_grad_(True) for k, t in layer.items()} for layer in _port_params(
        _jax_params()["params"])]
    x = _t(_mlp_inputs(256))
    g1 = torch.autograd.grad(apply_mlp(pp, x).sum(), [pp[0]["w"], pp[5]["b"]])
    xg = x.clone().requires_grad_(True)
    g2 = torch.autograd.grad(apply_mlp(pp, xg).sum(), [pp[0]["w"], pp[5]["b"]])
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The optimizer and one cache step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    from nebulae_tpu_torch.nrc.cache import clip_by_global_norm

    rng = np.random.default_rng(5)
    g = [{"w": rng.normal(size=(8, 4)).astype(np.float32) * scale, "b": rng.normal(size=4).astype(np.float32) * scale}
         for _ in range(3)]
    norm = np.sqrt(sum((x.astype(np.float64) ** 2).sum() for layer in g for x in layer.values()))
    assert (norm < 1.0) == (scale < 1.0)
    ref, _ = optax.clip_by_global_norm(1.0).update(jax.tree.map(jnp.asarray, g), optax.EmptyState())
    out = clip_by_global_norm([{k: _t(v) for k, v in layer.items()} for layer in g], 1.0)
    for lo, lr in zip(out, ref):
        for k in ("w", "b"):
            np.testing.assert_allclose(lo[k].numpy(), np.asarray(lr[k]), rtol=1e-6, atol=0.0)


def _records(n, seed=6):
    rng = np.random.default_rng(seed)
    return {
        "position": rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32),
        "normal": _unit(rng, n),
        "view": _unit(rng, n),
        "roughness": rng.uniform(0.02, 1.0, n).astype(np.float32),
        "albedo": rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32),
        "metalness": rng.uniform(0.0, 1.0, n).astype(np.float32),
        "target": (rng.uniform(0.0, 3.0, (n, 3)) ** 2).astype(np.float32),
        "weight": (rng.uniform(0, 1, n) > 0.2).astype(np.float32),
    }


def _rel_l2(port_params, jax_params):
    a = np.concatenate([layer[k].numpy().ravel() for layer in port_params for k in ("w", "b")]).astype(np.float64)
    b = np.concatenate([np.asarray(layer[k]).ravel() for layer in jax_params for k in ("w", "b")]).astype(np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_cache_step_matches_jax(steps):
    from nebulae_tpu.nrc import cache as jc

    from nebulae_tpu_torch.interop import nrc_state_from_arrays
    from nebulae_tpu_torch.nrc import cache as pc

    lo, hi = np.array([-2.0, -2.0, -2.0], np.float32), np.array([2.0, 2.0, 2.0], np.float32)
    jstate = jc.init_cache(seed=0)
    jopt = jc.make_optimizer(1e-2)
    pstate = nrc_state_from_arrays(jax.tree.map(np.asarray, jstate), "cpu")
    popt = pc.make_optimizer(1e-2)
    jstep = jax.jit(lambda s, r: jc.train_cache_step(s, jopt, r, jnp.asarray(lo), jnp.asarray(hi)))
    for i in range(steps):
        rec = _records(4096, seed=6 + i)
        jstate, jloss = jstep(jstate, jax.tree.map(jnp.asarray, rec))
        pstate, ploss = pc.train_cache_step(pstate, popt, {k: _t(v) for k, v in rec.items()}, _t(lo), _t(hi))
        # The first step's loss to 1e-5; later steps start from params that
        # differ by Adam's updates of ulp-different gradients: 1e-3, as the
        # training pass holds its steps.
        rtol = 1e-5 if i == 0 else 1e-3
        assert abs(float(ploss) - float(jloss)) <= rtol * abs(float(jloss)), (i, float(ploss), float(jloss))
    assert pstate["opt_state"]["count"] == int(jax.tree.leaves(jstate["opt_state"])[0]) == steps
    tol = 1e-3 if steps == 1 else 1e-2
    assert _rel_l2(pstate["params"], jstate["params"]) <= tol
    assert _rel_l2(pstate["ema_params"], jstate["ema_params"]) <= tol
    adam = jstate["opt_state"][1][0]
    assert _rel_l2(pstate["opt_state"]["mu"], adam.mu) <= tol


def test_memory_footprint_matches_jax():
    from nebulae_tpu.nrc.cache import init_cache as jinit
    from nebulae_tpu.nrc.cache import memory_footprint as jfoot

    from nebulae_tpu_torch.interop import nrc_state_from_arrays
    from nebulae_tpu_torch.nrc.cache import init_cache, memory_footprint

    ref = jfoot(jinit(seed=0))
    assert memory_footprint(init_cache(seed=0)) == ref
    assert memory_footprint(nrc_state_from_arrays(jax.tree.map(np.asarray, jinit(seed=0)), "cpu")) == ref
    assert ref["opt_state"] == 4 + 2 * ref["params"]


def test_nrc_state_from_arrays_carries_the_nested_optax_state():
    from nebulae_tpu.nrc.cache import init_cache as jinit

    from nebulae_tpu_torch.interop import nrc_state_from_arrays

    j = jax.tree.map(np.asarray, jinit(seed=2))
    p = nrc_state_from_arrays(j, "cpu")
    assert p["opt_state"]["count"] == 0 and len(p["params"]) == 6
    for a, b in zip(p["params"], j["params"]):
        np.testing.assert_array_equal(a["w"].numpy(), b["w"])
    assert all(not layer["w"].any() for layer in p["opt_state"]["nu"])


@pytest.mark.parametrize("wh,want", [((1920, 1080), (172, 96)), ((64, 64), (64, 64)), ((48, 48), (48, 48)),
                                     ((1280, 720), (172, 96)), ((3840, 2160), (172, 96)), ((256, 256), (128, 128)),
                                     ((16, 4), (16, 8)), ((2560, 1440), (172, 96))])
def test_compute_ideal_training_dims_matches_jax(wh, want):
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.passes.nrc_pathtrace import compute_ideal_training_dims as jdims

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.passes.nrc_pathtrace import compute_ideal_training_dims

    assert jdims(*wh, JCfg()) == want
    assert compute_ideal_training_dims(*wh, RenderConfig()) == want
    small = dict(nrc_records_per_iteration=4096, nrc_max_path_vertices=6)
    assert compute_ideal_training_dims(*wh, RenderConfig(**small)) == jdims(*wh, JCfg(**small))


def test_spread_terms_match_jax():
    from nebulae_tpu.nrc import cache as jc

    from nebulae_tpu_torch.nrc import cache as pc

    rng = np.random.default_rng(7)
    d = rng.uniform(0.0, 10.0, 512).astype(np.float32)
    c = rng.uniform(1e-3, 1.0, 512).astype(np.float32)
    pdf = rng.uniform(0.0, 0.5, 512).astype(np.float32)
    d[:3] = np.inf
    np.testing.assert_allclose(pc.spread_term(_t(d), _t(c), _t(pdf)).numpy(),
                               np.asarray(jc.spread_term(jnp.asarray(d), jnp.asarray(c), jnp.asarray(pdf))), rtol=1e-6)
    np.testing.assert_allclose(pc.primary_spread(_t(d), _t(c)).numpy(),
                               np.asarray(jc.primary_spread(jnp.asarray(d), jnp.asarray(c))), rtol=1e-6)


# ---------------------------------------------------------------------------
# The passes, on the small atrium
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def atrium():
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.config import SunLight as JSun
    from nebulae_tpu.core.camera import Camera as JCamera
    from nebulae_tpu.core.scene import FlatScene as JFlatScene
    from nebulae_tpu.engine.renderer import Renderer as JRenderer
    from nebulae_tpu.passes.gbuffer import make_camera_arrays as jcam_arrays

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays
    from nebulae_tpu_torch.utils.testscenes import atrium_camera, small_atrium

    fs = small_atrium(0)
    cam = atrium_camera(fs)
    jcfg = JCfg(**KW)
    jr = JRenderer(JFlatScene(**fs.field_arrays()), jcfg)
    pr = Renderer(fs, RenderConfig(**KW), device="cpu")
    jcam = jcam_arrays(JCamera(eye=cam.eye, target=cam.target, fov_y_deg=cam.fov_y_deg), S, S)
    return {"fs": fs, "jr": jr, "pr": pr, "jcam": jcam, "pcam": make_camera_arrays(cam, S, S, "cpu"),
            "jsun": jax.tree.map(jnp.asarray, JSun.default(np)), "jcache": init_jax_cache()}


def init_jax_cache():
    from nebulae_tpu.nrc.cache import init_cache

    return init_cache(seed=0)


def _jax_rng(width, n_pix, frame, draws):
    from nebulae_tpu.core import rng as jrng

    ys, xs = np.meshgrid(np.arange(n_pix // width, dtype=np.uint32), np.arange(width, dtype=np.uint32),
                         indexing="ij")
    state = jrng.init_rng(jnp.asarray(xs.reshape(-1)), jnp.asarray(ys.reshape(-1)), width, jnp.uint32(frame))
    for _ in range(draws):
        state, _ = jrng.next_float(state)
    return np.asarray(state).astype(np.int64)


@pytest.fixture(scope="module", params=["inline", "latched"])
def query(request, atrium):
    """path_trace_nrc_query in both packages from JAX's G-buffer."""
    from nebulae_tpu.core import rng as jrng
    from nebulae_tpu.passes.gbuffer import camera_rays_jax
    from nebulae_tpu.passes.gbuffer import render_gbuffer as jgbuffer
    from nebulae_tpu.passes.nrc_pathtrace import path_trace_nrc_query as jquery
    from nebulae_tpu.tracer.trace import make_tracer as jtracer

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.core import rng as prng
    from nebulae_tpu_torch.interop import mlp_params_from_arrays
    from nebulae_tpu_torch.passes.nrc_pathtrace import path_trace_nrc_query
    from nebulae_tpu_torch.tracer.trace import make_tracer

    from nebulae_tpu.config import RenderConfig as JCfg

    kw = dict(KW, nrc_inline_resolve=request.param == "inline")
    jcfg, pcfg = JCfg(**kw), RenderConfig(**kw)
    jr, pr = atrium["jr"], atrium["pr"]

    def jrun(scene, bvh, sun, cam, params):
        closest, any_fn = jtracer(scene, bvh, jcfg)
        o, d = camera_rays_jax(cam, S, S)
        gbuf = jgbuffer(scene, closest, o, d, image_hw=(S, S))
        ys, xs = jnp.meshgrid(jnp.arange(S, dtype=jnp.uint32), jnp.arange(S, dtype=jnp.uint32), indexing="ij")
        rng = jrng.init_rng(xs.reshape(-1), ys.reshape(-1), S, jnp.uint32(0))
        rad, rng, aux = jquery(scene, gbuf, sun, closest, any_fn, rng, jcfg, params)
        return gbuf, rad, rng, aux

    gbuf, rad, rng, aux = jax.jit(jrun)(jr.scene, jr.bvh, atrium["jsun"], atrium["jcam"],
                                        atrium["jcache"]["params"])
    pgbuf = {k: torch.from_numpy(np.array(v)) for k, v in gbuf.items()}
    closest, any_fn = make_tracer(pr.scene, pr.tables, pcfg, device="cpu")
    ys, xs = torch.meshgrid(torch.arange(S), torch.arange(S), indexing="ij")
    prng_state = prng.init_rng(xs.reshape(-1), ys.reshape(-1), S, 0)
    params = mlp_params_from_arrays(jax.tree.map(np.asarray, atrium["jcache"]["params"]), "cpu")
    prad, prng_state, paux = path_trace_nrc_query(pr.scene, pgbuf, pr.sun, closest, any_fn, prng_state, pcfg,
                                                  params)
    return {"name": request.param, "jax": (np.asarray(rad), np.asarray(rng), jax.tree.map(np.asarray, aux)),
            "port": (prad.numpy(), prng_state.numpy(), {k: v.numpy() for k, v in paux.items()})}


def test_query_pass_rng_state_matches_jax(query):
    assert np.array_equal(query["port"][1], query["jax"][1].astype(np.int64))
    # 5 draws a bounce vertex, 2 at the last.
    np.testing.assert_array_equal(query["port"][1], _jax_rng(S, S * S, 0, 5 * (KW["max_bounces"] - 1) + 2))


def test_query_pass_radiance_matches_jax(query):
    p, j = query["port"][0], query["jax"][0]
    assert np.isfinite(p).all()
    frac = _close(p, j, 1e-3, 1e-4).all(-1).mean()
    assert frac >= 0.99, f"{query['name']}: {frac:.4f} of pixels within tolerance"


def test_query_pass_counters_match_jax(query):
    p, j = query["port"][2], query["jax"][2]
    assert 0.05 < float(j["query_frac"]) < 0.95, "the atrium should hand some paths to the cache"
    assert abs(float(p["query_frac"]) - float(j["query_frac"])) <= 0.005
    for k in ("term_bounce", "n_vert", "query_set"):
        assert (p[k] == j[k]).mean() >= 0.999, (k, (p[k] == j[k]).mean())
    np.testing.assert_array_equal(p["query_set"], p["term_bounce"] > 0)


def test_inline_and_latched_resolves_agree(atrium):
    """The two resolves differ only in the order of the float additions."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.utils.testscenes import atrium_camera

    outs = []
    for inline in (True, False):
        cfg = RenderConfig(**dict(KW, enable_nrc=True, nrc_inline_resolve=inline))
        outs.append(Renderer(atrium["fs"], cfg, device="cpu").render(atrium_camera(atrium["fs"])))
    np.testing.assert_allclose(outs[0]["hdr"].numpy(), outs[1]["hdr"].numpy(), rtol=1e-5, atol=1e-6)
    assert float(outs[0]["nrc_query_frac"]) == float(outs[1]["nrc_query_frac"])


@pytest.fixture(scope="module")
def train_pass(atrium):
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.nrc.cache import make_optimizer as jmake_opt
    from nebulae_tpu.passes.nrc_pathtrace import path_trace_nrc_train as jtrain
    from nebulae_tpu.tracer.trace import make_tracer as jtracer

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.interop import nrc_state_from_arrays
    from nebulae_tpu_torch.nrc.cache import make_optimizer
    from nebulae_tpu_torch.passes import nrc_pathtrace as pnp
    from nebulae_tpu_torch.tracer.trace import make_tracer

    frame = 3
    jcfg, pcfg = JCfg(**KW), RenderConfig(**KW)
    jr, pr = atrium["jr"], atrium["pr"]

    def jrun(scene, bvh, sun, cam, cache):
        closest, any_fn = jtracer(scene, bvh, jcfg)
        return jtrain(scene, sun, closest, any_fn, jcfg, cache, jmake_opt(jcfg.nrc_learning_rate), cam,
                      jnp.uint32(frame))

    jcache, jloss = jax.jit(jrun)(jr.scene, jr.bvh, atrium["jsun"], atrium["jcam"], atrium["jcache"])
    closest, any_fn = make_tracer(pr.scene, pr.tables, pcfg, device="cpu")
    seen = {}
    nee = pnp._nee_direct

    def spy(*args, **kwargs):
        out = nee(*args, **kwargs)
        seen["rng"] = out[1]
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pnp, "_nee_direct", spy)
        pcache, ploss = pnp.path_trace_nrc_train(
            pr.scene, pr.sun, closest, any_fn, pcfg, nrc_state_from_arrays(jax.tree.map(np.asarray, atrium["jcache"]),
                                                                           "cpu"),
            make_optimizer(pcfg.nrc_learning_rate), atrium["pcam"], frame)
    return {"jax": (jax.tree.map(np.asarray, jcache), float(jloss)), "port": (pcache, float(ploss)),
            "rng": seen["rng"].numpy(), "frame": frame}


def test_train_pass_rng_state_matches_jax(train_pass):
    # 2 jitter draws, 1 lottery draw, 5 a bounce vertex, 2 at the last.
    draws = 2 + 1 + 5 * (KW.get("nrc_max_path_vertices", 8) - 1) + 2
    np.testing.assert_array_equal(train_pass["rng"], _jax_rng(S, S * S, train_pass["frame"] ^ 0x9E3779B9, draws))


def test_train_pass_loss_and_params_match_jax(train_pass):
    (jcache, jloss), (pcache, ploss) = train_pass["jax"], train_pass["port"]
    assert np.isfinite(ploss) and abs(ploss - jloss) <= 1e-3 * abs(jloss), (ploss, jloss)
    # 48x48 paths x 8 vertices = 18,432 records: 4 steps of 4,096.
    assert pcache["opt_state"]["count"] == 4 == int(jcache["opt_state"][1][0].count)
    assert _rel_l2(pcache["params"], jcache["params"]) <= 1e-2
    assert _rel_l2(pcache["ema_params"], jcache["ema_params"]) <= 1e-2
