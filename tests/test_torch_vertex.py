"""Kernel K9 (a path vertex's draws and ray keys) and its plain twin.

* The twin (`kernels/vertex.py` bounce_draws_plain, last_draws_plain,
  ray_sort_key) against the JAX package's nee_bounce_draws, the shading
  half of its _nee_direct and its ray_sort_key, on a real vertex of the
  ~5k-triangle textured scene (the G-buffer's and the next one,
  reconstructed by a walk) and on stress inputs: RNG states bit-equal to
  5 and 2 XorShift steps and to JAX's, masks and keys equal, floats to
  rtol 1e-5 / atol 1e-6 (as tests/test_torch_core.py holds the shading).
* The dispatch rule: K9 on the card, the twin on the CPU; where autograd
  records, K9 runs inside _VertexGrad, whose gradient is the twin's bit for
  bit (through the emulated build here).
* csrc/vertex.cu built by g++ against tests/cuda_on_cpu.h and held to the
  twin on the CPU: RNG states equal, every other output within CPU libm's
  rounding of sin, cos and pow.
* On the card (skipped here): K9 equals the twin bit for bit, every
  output, at 2,073,600 lanes (a 1080p frame's) and 16,512, and its
  gradient is the twin's.
"""

import ctypes
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import nebulae_tpu_torch
from nebulae_tpu_torch.config import RenderConfig, SunLight
from nebulae_tpu_torch.core import rng as nrng
from nebulae_tpu_torch.core.math import normalize
from nebulae_tpu_torch.engine.renderer import Renderer
from nebulae_tpu_torch.kernels import vertex as kv
from nebulae_tpu_torch.kernels.build import CXX, SIGNATURES
from nebulae_tpu_torch.passes.gbuffer import camera_rays, make_camera_arrays, render_gbuffer
from nebulae_tpu_torch.passes.pathtrace import SURF_KEYS, nee_bounce_step, path_trace
from nebulae_tpu_torch.tracer.sorting import DEAD_ORIGIN
from nebulae_tpu_torch.tracer.trace import make_tracer
from nebulae_tpu_torch.utils.testscenes import bench_camera, textured_scene

VERTEX_CU = Path(nebulae_tpu_torch.__file__).parent / "csrc" / "vertex.cu"
HEADER = Path(__file__).with_name("cuda_on_cpu.h")
W, H = 48, 32
RTOL, ATOL = 1e-5, 1e-6


def _steps(rng_state, n):
    for _ in range(n):
        rng_state = nrng.xorshift32(rng_state)
    return rng_state


def _equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k].detach().numpy(), want[k].detach().numpy(), err_msg=k)


def _jax_inputs(surf, view, sun, alive, state):
    """The port's vertex as the JAX package takes it.  (The JAX package is
    imported in the tests that use it: the card's machine has no JAX.)"""
    import jax.numpy as jnp

    def j(t):
        return jnp.asarray(t.detach().numpy())

    jsurf = {k: j(surf[k]) for k in kv.DIFF_SURF}
    jsun = SimpleNamespace(direction=j(sun.direction), tan_half_angle=j(sun.tan_half_angle),
                           radiance=j(sun.radiance))
    return jsurf, j(view), jsun, j(alive), jnp.asarray(state.numpy().astype(np.uint32))


def _jax_key(o, d, aabb):
    """JAX's int32 key [1 dead][3 octant][21 morton][5 dir][2 low] without
    the dead bit or low bits, moved down to the port's int64 layout."""
    import jax.numpy as jnp
    from nebulae_tpu.tracer import sorting as jsort

    key = jsort.ray_sort_key(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(aabb[0].numpy()),
                             jnp.asarray(aabb[1].numpy()))
    return np.asarray(key).view(np.uint32).astype(np.int64) >> 2


def _held(what, got, want, exact=()):
    for k, w in want.items():
        g = got[k].detach().numpy()
        if k in exact:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def vertices():
    """The textured scene's G-buffer vertex and the next one (full
    shading, reconstructed on the walk's compact hits), each with its view,
    alive mask and RNG state, and the scene box."""
    fs = textured_scene(seed=0)
    cfg = RenderConfig(width=W, height=H)
    r = Renderer(fs, cfg, device="cpu")
    closest, _ = make_tracer(r.scene, r.tables, cfg, device="cpu")
    o, d = camera_rays(make_camera_arrays(bench_camera(fs), W, H, "cpu"), W, H)
    gbuf = render_gbuffer(r.scene, closest, o, d)
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    rng0 = nrng.init_rng(xs.reshape(-1), ys.reshape(-1), W, 7)
    sun = r.sun
    aabb = (r.scene["aabb_min"], r.scene["aabb_max"])
    surf0 = {k: gbuf[k] for k in SURF_KEYS}
    rng1, pre = kv.bounce_vertex(surf0, gbuf["view"], sun, gbuf["hit"], rng0, aabb)
    _vis, found, _t, surf1, _walked = nee_bounce_step(r.scene, pre, gbuf["hit"] & pre["rr_continue"], closest, cfg)
    assert 0 < int(found.sum()) < found.numel()
    return {
        "sun": sun,
        "aabb": aabb,
        "first": (surf0, gbuf["view"], gbuf["hit"], rng0),
        "second": (surf1, -pre["new_d"], gbuf["hit"] & found, rng1),
    }


def _stress(n: int, seed: int, *, alive=None, grazing=False, rough=None, metal=None):
    """n lanes of unit normals, views in the normals' hemisphere (or at
    90 degrees to them), albedo in [0, 1], with the given roughness and
    metalness (else drawn)."""
    g = np.random.default_rng(seed)

    def unit(shape):
        v = g.normal(size=shape)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    ns = unit((n, 3))
    ng = ns + 0.2 * unit((n, 3))
    ng /= np.linalg.norm(ng, axis=-1, keepdims=True)
    view = unit((n, 3))
    if grazing:
        view = view - (view * ns).sum(-1, keepdims=True) * ns
        view /= np.maximum(np.linalg.norm(view, axis=-1, keepdims=True), 1e-12)
    else:
        view *= np.sign((view * ns).sum(-1, keepdims=True) + 1e-9)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    surf = {
        "position": f32(g.uniform(-5.0, 5.0, (n, 3))),
        "normal_g": f32(ng),
        "normal_s": f32(ns),
        "albedo": f32(g.uniform(0.0, 1.0, (n, 3))),
        "roughness": f32(np.full(n, rough) if rough is not None else g.uniform(0.02, 1.0, n)),
        "metalness": f32(np.full(n, metal) if metal is not None else g.uniform(0.0, 1.0, n)),
    }
    live = torch.from_numpy(g.uniform(size=n) < 0.8) if alive is None else torch.full((n,), alive)
    state = nrng.init_rng(torch.arange(n), torch.zeros(n, dtype=torch.int64), max(n, 1), seed)
    return surf, normalize(f32(view)), live, state


STRESS = {
    "0 lanes": dict(n=0),
    "1 lane": dict(n=1),
    "all dead": dict(n=257, alive=False),
    "grazing": dict(n=257, grazing=True),
    "rough 0.02, metal 0": dict(n=257, rough=0.02, metal=0.0),
    "rough 1, metal 1": dict(n=257, rough=1.0, metal=1.0),
}


def _cases(vertices):
    for name in ("first", "second"):
        yield name, vertices[name]
    for name, kw in STRESS.items():
        kw = dict(kw)
        yield name, _stress(kw.pop("n"), 11, **kw)


def test_bounce_twin_matches_the_jax_vertex(vertices):
    from nebulae_tpu.passes import pathtrace as jpt

    sun, aabb = vertices["sun"], vertices["aabb"]
    for name, (surf, view, alive, state) in _cases(vertices):
        got_rng, got = kv.bounce_vertex(surf, view, sun, alive, state, aabb)
        np.testing.assert_array_equal(got_rng.numpy(), _steps(state, 5).numpy(), err_msg=name)
        want_rng, want = jpt.nee_bounce_draws(*_jax_inputs(surf, view, sun, alive, state))
        np.testing.assert_array_equal(got_rng.numpy(), np.asarray(want_rng).astype(np.int64), err_msg=name)
        assert set(got) == {*want, "key"}, name
        _held(f"bounce {name}", got, want, exact=("shoot", "rr_continue"))
        np.testing.assert_array_equal(got["key"].numpy(), _jax_key(got["origin"], got["new_d"], aabb),
                                      err_msg=name)
        # Without the box there is no key, and the rest is the same.
        _rng, unkeyed = kv.bounce_vertex(surf, view, sun, alive, state)
        assert "key" not in unkeyed
        _equal(unkeyed, {k: v for k, v in got.items() if k != "key"})


def test_last_twin_matches_the_jax_vertex(vertices):
    """JAX's _nee_direct, its shadow trace replaced by one that records its
    rays and finds no occluder: the shadow origin and direction, the mask,
    the state, and f * n_dot_l * radiance as its `direct`."""
    import jax.numpy as jnp
    from nebulae_tpu.passes import pathtrace as jpt

    sun, aabb = vertices["sun"], vertices["aabb"]
    for name, (surf, view, alive, state) in _cases(vertices):
        got_rng, got = kv.last_vertex(surf, view, sun, alive, state, aabb)
        np.testing.assert_array_equal(got_rng.numpy(), _steps(state, 2).numpy(), err_msg=name)
        rays = []

        def no_occluder(o, d):
            rays.append((o, d))
            return jnp.zeros(o.shape[0], bool)

        jsurf, jview, jsun, jalive, jstate = _jax_inputs(surf, view, sun, alive, state)
        direct, want_rng, shoot = jpt._nee_direct(None, jsurf, jview, jsun, jalive, no_occluder, jstate, None,
                                                  sort=False)
        np.testing.assert_array_equal(got_rng.numpy(), np.asarray(want_rng).astype(np.int64), err_msg=name)
        (o_sh, l_sh), = rays
        lit = got["f"] * (got["n_dot_l"] * got["shoot"].float())[..., None] * sun.radiance[None, :]
        _held(f"last {name}", {**got, "direct": lit},
              {"shoot": shoot, "origin": o_sh, "l": l_sh, "direct": direct}, exact=("shoot",))
        np.testing.assert_array_equal(got["key"].numpy(), _jax_key(got["origin"], got["l"], aabb), err_msg=name)
        if alive.numel() and not bool(alive.any()):
            assert not bool(got["shoot"].any()) and bool((got["origin"] == DEAD_ORIGIN).all())


def _tracking(surf, sun):
    """The inputs of a train step: materials and the sun track gradients."""
    surf = {k: (v.detach().clone().requires_grad_(True) if k in ("albedo", "roughness") else v)
            for k, v in surf.items()}
    sun = SunLight(sun.direction.detach().clone().requires_grad_(True), sun.radiance,
                   sun.tan_half_angle.detach().clone().requires_grad_(True), sun.sky_color)
    return surf, sun


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, to put the dispatch
    rule's device test aside."""

    @property
    def is_cuda(self):
        return True


def test_the_card_runs_k9_and_the_cpu_the_twin_under_grad_too(vertices):
    surf, view, alive, state = vertices["first"]
    assert kv._kernel_runs(view.as_subclass(_CudaLooking))
    assert not kv._kernel_runs(view)
    g_surf, g_sun = _tracking(surf, vertices["sun"])
    before = kv.vertex_kernel.launches
    _rng, pre = kv.bounce_vertex(g_surf, view, g_sun, alive, state, vertices["aabb"])
    _rng, nee = kv.last_vertex(g_surf, view, g_sun, alive, state, vertices["aabb"])
    assert pre["f"].grad_fn is not None and pre["weight"].grad_fn is not None
    assert nee["f"].grad_fn is not None and nee["l"].grad_fn is not None
    # A whole path traced under grad on the CPU reaches the materials and the sun.
    fs = textured_scene(seed=0)
    cfg = RenderConfig(width=16, height=16, max_bounces=3)
    r = Renderer(fs, cfg, device="cpu")
    closest, any_fn = make_tracer(r.scene, r.tables, cfg, device="cpu")
    o, d = camera_rays(make_camera_arrays(bench_camera(fs), 16, 16, "cpu"), 16, 16)
    scene = dict(r.scene)
    scene["mat_base_color"] = scene["mat_base_color"].clone().requires_grad_(True)
    gbuf = render_gbuffer(scene, closest, o, d)
    rng0 = nrng.init_rng(torch.arange(256) % 16, torch.arange(256) // 16, 16, 1)
    _g, t_sun = _tracking({}, r.sun)
    radiance, _ = path_trace(scene, gbuf, t_sun, closest, any_fn, rng0, cfg)
    radiance.sum().backward()
    assert scene["mat_base_color"].grad is not None and t_sun.direction.grad is not None
    assert kv.vertex_kernel.launches == before


# ---------------------------------------------------------------------------
# csrc/vertex.cu on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    from test_torch_emulated import emulated_source

    out = tmp_path_factory.mktemp("vertex_emulated")
    text = VERTEX_CU.read_text()
    src = emulated_source(text)
    assert src.count("emu_launch(") == text.count("<<<") == 1
    cpp = out / "vertex_emulated.cpp"
    cpp.write_text(src.replace("#include <cuda_runtime.h>", f'#include "{HEADER}"'))
    so = out / "libvertex_emulated.so"
    subprocess.run([CXX, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
                    "-Wno-unknown-pragmas", str(cpp), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    for name in ("nb_vertex", "nb_vertex_args_size"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = SIGNATURES[name]
    return lib


def _use_emulated(lib, monkeypatch):
    """Have kv launch the emulated build on CPU tensors."""
    monkeypatch.setattr(kv, "native", lambda: SimpleNamespace(lib=lib))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=0))


def _emulated_run(lib, last, surf, view, sun, alive, state, aabb, monkeypatch):
    """kv.vertex_kernel on CPU tensors, launching the emulated build."""
    _use_emulated(lib, monkeypatch)
    return kv.vertex_kernel(last, surf, view, sun, alive, state, aabb)


def _close(got: dict, want: dict, what: str, mask_share: float):
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        if not w.numel():
            continue
        if w.dtype == torch.float32:
            # CPU libm's sinf, cosf and powf against torch's own, and
            # x / pi against x * (1 / pi): a few ulps, carried along.
            far = (g - w).abs() > 2e-6 * w.abs() + 1e-6
            assert float(far.float().mean()) <= mask_share, (what, k, g[far][:4], w[far][:4])
        else:
            assert float((g != w).float().mean()) <= mask_share, (what, k)


def test_emulated_kernel_matches_the_twin(vertices, emulated, monkeypatch):
    assert emulated.nb_vertex_args_size() == ctypes.sizeof(kv._Args)
    sun, aabb = vertices["sun"], vertices["aabb"]
    launches = kv.vertex_kernel.launches
    for name, (surf, view, alive, state) in _cases(vertices):
        for box in (aabb, None):
            rng_k, out_k = _emulated_run(emulated, False, surf, view, sun, alive, state, box, monkeypatch)
            rng_p, out_p = kv.bounce_draws_plain(surf, view, sun, alive, state)
            if box is not None:
                out_p["key"] = kv.ray_sort_key(out_p["origin"], out_p["new_d"], *box)
            np.testing.assert_array_equal(rng_k.numpy(), rng_p.numpy(), err_msg=name)
            _close(out_k, out_p, f"bounce {name}", 0.01)
            rng_k, out_k = _emulated_run(emulated, True, surf, view, sun, alive, state, box, monkeypatch)
            rng_p, out_p = kv.last_draws_plain(surf, view, sun, alive, state)
            if box is not None:
                out_p["key"] = kv.ray_sort_key(out_p["origin"], out_p["l"], *box)
            np.testing.assert_array_equal(rng_k.numpy(), rng_p.numpy(), err_msg=name)
            _close(out_k, out_p, f"last {name}", 0.01)
    # A strided albedo (a gathered table's first 3 of 4 columns) is read in place.
    surf, view, alive, state = vertices["second"]
    wide = torch.cat([surf["albedo"], torch.ones_like(surf["albedo"][:, :1])], 1)
    strided = {**surf, "albedo": wide[:, :3]}
    assert not strided["albedo"].is_contiguous()
    rng_k, out_k = _emulated_run(emulated, False, strided, view, sun, alive, state, aabb, monkeypatch)
    _rng, out_c = _emulated_run(emulated, False, surf, view, sun, alive, state, aabb, monkeypatch)
    _equal(out_k, out_c)
    assert kv.vertex_kernel.launches > launches
    # The record hook keeps a copy: writing to an input afterwards leaves it.
    kv.vertex_kernel.record = []
    try:
        albedo = surf["albedo"].clone()
        _emulated_run(emulated, True, {**surf, "albedo": albedo}, view, sun, alive, state, aabb, monkeypatch)
        albedo.add_(1.0)
        (last, rec_surf, *_rest), = kv.vertex_kernel.record
    finally:
        kv.vertex_kernel.record = None
    assert last and torch.equal(rec_surf["albedo"], surf["albedo"])


def _gradients(outs: dict, weights: dict, leaves) -> list:
    """d sum_k <weights[k], outs[k]> / d leaves, over the float outputs."""
    loss = sum((outs[k] * w).sum() for k, w in weights.items())
    return torch.autograd.grad(loss, leaves, allow_unused=True, retain_graph=True)


def _weights(out: dict, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g, dtype=v.dtype).to(v.device)
            for k, v in out.items() if v.dtype == torch.float32}


def test_k9_outputs_track_gradients_as_the_twins_do(vertices, emulated, monkeypatch):
    """Each output of _VertexGrad takes part in the graph exactly where the
    twin's does, for each input that alone tracks a gradient: a bounce's
    new_d (the next vertex's view) follows normal_s alone."""
    _use_emulated(emulated, monkeypatch)
    surf, view, alive, state = vertices["first"]
    names = (*kv.DIFF_SURF, "view", "direction", "tan_half_angle")
    for i, name in enumerate(names):
        ins = [t.detach().clone().requires_grad_(j == i) for j, t in
               enumerate((*(surf[k] for k in kv.DIFF_SURF), view, vertices["sun"].direction,
                          vertices["sun"].tan_half_angle))]
        g_surf, g_view = dict(zip(kv.DIFF_SURF, ins[:6])), ins[6]
        g_sun = SimpleNamespace(direction=ins[7], tan_half_angle=ins[8])
        for last in (False, True):
            _rng, out_k = kv._launch(last, g_surf, g_view, g_sun, alive, state, vertices["aabb"])
            _rng, out_p = (kv.last_draws_plain if last else kv.bounce_draws_plain)(g_surf, g_view, g_sun, alive, state)
            assert {k: out_k[k].requires_grad for k in out_p} == {k: v.requires_grad for k, v in out_p.items()}, \
                (name, last)
            assert not out_k["key"].requires_grad


@pytest.mark.parametrize("last", [False, True], ids=["bounce", "last"])
def test_k9_under_grad_gives_the_twins_gradient(vertices, emulated, monkeypatch, last):
    """Where autograd records, K9 runs inside _VertexGrad; its backward runs
    the twin again, so the gradient equals the twin's bit for bit whatever
    the forward rounded (the emulated build rounds sin, cos and pow as CPU
    libm does).  With no gradient recorded, the same call launches alone."""
    _use_emulated(emulated, monkeypatch)
    surf, view, alive, state = vertices["second"]
    g_surf, g_sun = _tracking(surf, vertices["sun"])
    g_view = view.detach().clone().requires_grad_(True)
    leaves = [g_surf["albedo"], g_surf["roughness"], g_view, g_sun.direction, g_sun.tan_half_angle]
    launches = kv.vertex_kernel.launches
    rng_k, out_k = kv._launch(last, g_surf, g_view, g_sun, alive, state, vertices["aabb"])
    assert kv.vertex_kernel.launches == launches + 1
    assert type(out_k["f"].grad_fn).__name__ == "_VertexGradBackward"
    assert not any(out_k[k].requires_grad for k in ("shoot", "rr_continue", "key") if k in out_k)
    rng_p, out_p = (kv.last_draws_plain if last else kv.bounce_draws_plain)(g_surf, g_view, g_sun, alive, state)
    np.testing.assert_array_equal(rng_k.numpy(), rng_p.numpy())
    weights = _weights(out_p, 3)
    got = _gradients(out_k, weights, leaves)
    want = _gradients(out_p, weights, leaves)
    for name, g, w in zip(("albedo", "roughness", "view", "sun.direction", "sun.tan_half_angle"), got, want):
        assert w is not None and bool(w.abs().sum() > 0), name
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
    # An output that takes no part in the loss gets no gradient work.
    (g_only_l,) = torch.autograd.grad(out_k["l"].sum(), [g_sun.direction])
    (w_only_l,) = torch.autograd.grad(out_p["l"].sum(), [g_sun.direction])
    np.testing.assert_array_equal(g_only_l.numpy(), w_only_l.numpy())
    with torch.no_grad():
        _rng, plain_launch = kv._launch(last, g_surf, g_view, g_sun, alive, state, vertices["aabb"])
    assert plain_launch["f"].grad_fn is None
    assert kv.vertex_kernel.launches == launches + 2


def test_kernel_refuses_what_it_does_not_take(vertices):
    surf, view, alive, state = vertices["first"]
    sun = vertices["sun"]
    with pytest.raises(ValueError, match="int64"):
        kv.vertex_kernel(False, surf, view, sun, alive, state.to(torch.int32))
    with pytest.raises(ValueError, match="albedo"):
        kv.vertex_kernel(False, {**surf, "albedo": surf["albedo"].double()}, view, sun, alive, state)
    with pytest.raises(ValueError, match="view"):
        kv.vertex_kernel(False, surf, view[:-1], sun, alive, state)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2_073_600, 16_512])
def test_kernel_matches_the_twin_on_the_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nebulae_tpu_torch.kernels.build import native

    native()
    surf, view, alive, state = _stress(n, 5)
    surf = {k: v.cuda() for k, v in surf.items()}
    view, alive, state = view.cuda(), alive.cuda(), state.cuda()
    sun = SunLight.default("cuda")
    aabb = (torch.tensor([-5.0, -5.0, -5.0], device="cuda"), torch.tensor([5.0, 5.0, 5.0], device="cuda"))
    with torch.no_grad():
        for last in (False, True):
            launches = kv.vertex_kernel.launches
            rng_k, out_k = (kv.last_vertex if last else kv.bounce_vertex)(surf, view, sun, alive, state, aabb)
            assert kv.vertex_kernel.launches == launches + 1
            rng_p, out_p = (kv.last_draws_plain if last else kv.bounce_draws_plain)(surf, view, sun, alive, state)
            out_p["key"] = kv.ray_sort_key(out_p["origin"], out_p["new_d"] if not last else out_p["l"], *aabb)
            # Bit for bit: K9 rounds as ATen's eager ops do on the card.
            assert torch.equal(rng_k, rng_p)
            assert set(out_k) == set(out_p)
            for k, w in out_p.items():
                assert torch.equal(out_k[k], w), k


def test_k9_gradient_is_the_twins_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    surf, view, alive, state = _stress(16_512, 6)
    surf = {k: v.cuda() for k, v in surf.items()}
    view, alive, state = view.cuda(), alive.cuda(), state.cuda()
    g_surf, g_sun = _tracking(surf, SunLight.default("cuda"))
    g_view = view.clone().requires_grad_(True)
    leaves = [g_surf["albedo"], g_surf["roughness"], g_view, g_sun.direction, g_sun.tan_half_angle]
    aabb = (torch.tensor([-5.0, -5.0, -5.0], device="cuda"), torch.tensor([5.0, 5.0, 5.0], device="cuda"))
    for last in (False, True):
        launches = kv.vertex_kernel.launches
        rng_k, out_k = (kv.last_vertex if last else kv.bounce_vertex)(g_surf, g_view, g_sun, alive, state, aabb)
        assert kv.vertex_kernel.launches == launches + 1
        rng_p, out_p = (kv.last_draws_plain if last else kv.bounce_draws_plain)(g_surf, g_view, g_sun, alive, state)
        assert torch.equal(rng_k, rng_p)
        weights = _weights(out_p, 4)
        for name, g, w in zip(("albedo", "roughness", "view", "sun.direction", "sun.tan_half_angle"),
                              _gradients(out_k, weights, leaves), _gradients(out_p, weights, leaves)):
            assert torch.equal(g, w), name
