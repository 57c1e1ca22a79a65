"""One forward frame of the port against the JAX Renderer, on the CPU.

The ~5k-triangle procedural textured scene at 64x64, 4 bounces, full
shading, SVGF and ACES.  JAX traces with its XLA BVH walk here; the port
with the plain versions of K1-K3 and K4.  Tolerances:
  * hit mask equal; depth, normal and albedo within rtol 1e-5 / atol 1e-5
    on at least 99.9% of pixels and within 1e-3 everywhere: XLA contracts
    the Moller-Trumbore products into FMAs and the port does not, which
    moves barycentrics at grazing hits by up to ~1e-4 and, through the
    normal map's texel gradient, a few normals by ~5e-5 (ROADMAP Queue 3);
  * hdr, denoised and ldr within rtol 1e-3 / atol 1e-4 on at least 99% of
    pixels, and mean |d ldr| < 1e-3: an ulp in a hit point can flip a
    Russian-roulette or hit/miss decision on a few paths.
"""

import dataclasses

import numpy as np
import pytest
import torch

KW = dict(width=64, height=64, max_bounces=4, enable_svgf=True, enable_tonemap=True,
          bucket_scheduling=False)


def _camera(fs, cls):
    lo, hi = fs.aabb_min, fs.aabb_max
    c = (lo + hi) / 2
    c[1] = 0.5
    ext = float((hi - lo).max())
    return cls(eye=(c + np.array([0.12, 0.15, 0.22]) * ext).astype(np.float32), target=c.astype(np.float32))


@pytest.fixture(scope="module")
def frames():
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.core.camera import Camera as JCamera
    from nebulae_tpu.core.scene import FlatScene as JFlatScene
    from nebulae_tpu.engine.renderer import Renderer as JRenderer

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.core.camera import Camera
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.interop import frame_state_from_arrays
    from nebulae_tpu_torch.utils.testscenes import textured_scene

    fs = textured_scene(seed=0)
    cam = _camera(fs, Camera)
    jr = JRenderer(JFlatScene(**fs.field_arrays()), JCfg(**KW))
    jcam = JCamera(eye=cam.eye, target=cam.target, fov_y_deg=cam.fov_y_deg)
    jax_out = []
    jax_state1 = None
    for i in range(2):
        jax_out.append({k: np.asarray(v) for k, v in jr.render(jcam).items()})
        if i == 0:
            import jax

            jax_state1 = jax.tree.map(np.asarray, jr.state)

    pr = Renderer(fs, RenderConfig(**KW), device="cpu")
    port_out = [{k: v.numpy() for k, v in pr.render(cam).items()} for _ in range(2)]

    # Frame 2 of the port, continued from JAX's frame-1 state.
    pr2 = Renderer(fs, RenderConfig(**KW), device="cpu")
    pr2.state = frame_state_from_arrays(jax_state1, "cpu")
    pr2._last_cam = None
    cont = {k: v.numpy() for k, v in pr2.render(cam).items()}
    return {"fs": fs, "cam": cam, "jax": jax_out, "port": port_out, "from_jax": cont, "renderer": pr}


def _pixels_close(a, b, rtol, atol, n_pixels):
    """Share of pixels whose every channel is within tolerance."""
    return np.isclose(a, b, rtol=rtol, atol=atol).reshape(n_pixels, -1).all(-1).mean()


def test_gbuffer_matches(frames):
    j, p = frames["jax"][0], frames["port"][0]
    np.testing.assert_array_equal(p["hit"], j["hit"])
    assert j["hit"].mean() > 0.6
    hit = j["hit"]
    np.testing.assert_array_equal(np.isinf(p["depth"]), np.isinf(j["depth"]))
    for k in ("depth", "normal", "albedo"):
        a, b = p[k][hit], j[k][hit]
        assert _pixels_close(a, b, 1e-5, 1e-5, int(hit.sum())) >= 0.999, k
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3, err_msg=k)


def _assert_frame_close(p, j):
    for k in ("hdr", "denoised", "ldr"):
        assert np.isfinite(p[k]).all(), k
        frac = _pixels_close(p[k], j[k], 1e-3, 1e-4, p[k].shape[0] * p[k].shape[1])
        assert frac >= 0.99, f"{k}: {frac:.4f} of pixels within tolerance"
    assert np.abs(p["ldr"] - j["ldr"]).mean() < 1e-3


@pytest.mark.parametrize("frame", [0, 1])
def test_frame_matches_jax(frames, frame):
    _assert_frame_close(frames["port"][frame], frames["jax"][frame])


def test_second_frame_from_jax_state_matches(frames):
    """The JAX frame-1 state (SVGF history included), carried over through
    interop, gives the port the same second frame as JAX."""
    _assert_frame_close(frames["from_jax"], frames["jax"][1])
    np.testing.assert_allclose(frames["from_jax"]["ldr"], frames["port"][1]["ldr"], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("variant", ["direct_only", "moving_camera"])
def test_frame_variants_match_jax(frames, variant):
    """Direct lighting only (shade_direct, kernel K3), and a second frame
    after the camera moved (SVGF reprojection of the history)."""
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.core.camera import Camera as JCamera
    from nebulae_tpu.core.scene import FlatScene as JFlatScene
    from nebulae_tpu.engine.renderer import Renderer as JRenderer

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.core.camera import Camera
    from nebulae_tpu_torch.engine.renderer import Renderer

    fs, cam = frames["fs"], frames["cam"]
    kw = dict(KW, enable_gi=False) if variant == "direct_only" else dict(KW, max_bounces=2)
    cams = [cam, cam]
    if variant == "moving_camera":
        cams[1] = Camera(eye=cam.eye + np.float32([0.15, 0.05, -0.1]), target=cam.target)
    jr = JRenderer(JFlatScene(**fs.field_arrays()), JCfg(**kw))
    pr = Renderer(fs, RenderConfig(**kw), device="cpu")
    for c in cams:
        j = {k: np.asarray(v) for k, v in jr.render(JCamera(eye=c.eye, target=c.target)).items()}
        p = {k: v.numpy() for k, v in pr.render(c).items()}
        np.testing.assert_array_equal(p["hit"], j["hit"])
        _assert_frame_close(p, j)


def test_tpu_strategy_knobs_do_not_change_output(frames):
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer

    knobs = dict(chunk_mode="paged", bucket_scheduling=True, bucket_schedule=(4, 16, 1, 4),
                 bvh_tri_group=4, sort_segments=4, svgf_pallas=False, bvh_wide=2)
    r = Renderer(frames["fs"], RenderConfig(**{**KW, **knobs}), device="cpu")
    out = r.render(frames["cam"])
    for k, v in frames["port"][0].items():
        np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)


def test_lean_outputs_hold_only_the_image(frames):
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer

    r = Renderer(frames["fs"], RenderConfig(**{**KW, "lean_outputs": True}), device="cpu")
    out = r.render(frames["cam"])
    assert set(out) == {"ldr", "nrc_loss", "nrc_query_frac"}
    np.testing.assert_array_equal(out["ldr"].numpy(), frames["port"][0]["ldr"])


def test_renderer_needs_cuda_unless_cpu_is_asked_for(frames):
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer, render_frame

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(frames["fs"], RenderConfig(**KW))
    r = frames["renderer"]
    with pytest.raises(RuntimeError, match="CUDA"):
        render_frame(r.scene, r.tables, r.sun, {}, r.state, r.cfg)


@pytest.mark.parametrize("change", [{"enable_nrc": True}, {"tracer": "bvh"}])
def test_unported_configurations_raise(frames, change):
    """No configuration is refused any more.  The neural radiance cache: a
    Renderer with enable_nrc builds and renders (its parity with JAX is
    tests/test_torch_nrc_frame.py's).  tracer="bvh" (JAX's XLA walk) is a
    strategy knob in the port: it builds the tables and walks them with
    the kernels' plain versions, so its frame equals the "pallas" frame
    bit for bit, and it matches JAX's "bvh" frame as the frame tests do
    (JAX's "auto" frame here: off the TPU, "auto" resolves to "bvh")."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer

    cfg = dataclasses.replace(RenderConfig(**KW), **change)
    r = Renderer(frames["fs"], cfg, device="cpu")
    if change.get("enable_nrc"):
        assert r.state["nrc"]["opt_state"]["count"] == 0
        out = r.render(frames["cam"])
        assert np.isfinite(out["ldr"].numpy()).all()
        assert float(out["nrc_loss"]) > 0.0 and r.state["nrc"]["opt_state"]["count"] > 0
        return
    assert r.route == "single" and r.tables is not None
    out = {k: v.numpy() for k, v in r.render(frames["cam"]).items()}
    pallas = Renderer(frames["fs"], dataclasses.replace(cfg, tracer="pallas"), device="cpu")
    for k, v in pallas.render(frames["cam"]).items():
        np.testing.assert_array_equal(out[k], v.numpy(), err_msg=k)
    np.testing.assert_array_equal(out["hit"], frames["jax"][0]["hit"])
    _assert_frame_close(out, frames["jax"][0])
