"""Frames with the neural radiance cache, in the port against the JAX
Renderer on the CPU, and the cache's runtime API.

The small atrium (utils.testscenes.small_atrium: the ~5k-triangle torus
field inside four walls, open to the sky) at 64x64, 4 bounces, SVGF and
ACES, the cache on, from JAX's init_cache(seed=0) carried across
(interop.frame_state_from_arrays).  Tolerances:
  * two frames: ldr on >= 99% of pixels within rtol 1e-2 / atol 1e-3,
    nrc_loss to a relative 1e-3, nrc_query_frac within 0.5%, and the
    query_bounce debug view on >= 99.9% of pixels: each frame trains the
    cache first, and Adam's updates of ulp-different gradients move the
    weights by up to 2 lr each (tests/test_torch_nrc.py), so the query
    radiance differs by more than the plain path's 1e-3.
The train step is held in tests/test_torch_nrc_step.py.  The port's
quality probe runs at a reduced size (its plumbing: finite MSEs and its
keys): at its defaults it takes ~11 min on the CPU, and chip_smoke.py
asserts its ratio there.
Run as a script (JAX_PLATFORMS=cpu python tests/test_torch_nrc_frame.py
--jax-probe, or --port-probe), this file prints JAX's probe on the same
small atrium, or the port's at its defaults, both on the CPU; with
--ema-drift it runs the probe's cache-on warm-up in both packages from one
cache and prints the relative L2 between their EMA parameters after each
frame.
"""

import sys

import numpy as np
import pytest
import torch

S = 64
KW = dict(width=S, height=S, max_bounces=4, enable_svgf=True, enable_tonemap=True, bucket_scheduling=False,
          enable_nrc=True)


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
def frames(scene):
    import jax

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.interop import nrc_state_from_arrays

    kw = dict(KW, nrc_debug="query_bounce")
    jr = _jax_renderer(scene, kw)
    jcache = jax.tree.map(np.asarray, jr.state["nrc"])
    jax_out = [{k: np.asarray(v) for k, v in jr.render(_jcam(scene["cam"])).items()} for _ in range(2)]
    pr = Renderer(scene["fs"], RenderConfig(**kw), device="cpu")
    pr.state["nrc"] = nrc_state_from_arrays(jcache, "cpu")
    port_out = [{k: v.numpy() for k, v in pr.render(scene["cam"]).items()} for _ in range(2)]
    return {"jax": jax_out, "port": port_out, "renderer": pr, "jax_cache": jcache}


@pytest.mark.parametrize("i", [0, 1])
def test_nrc_frame_matches_jax(frames, i):
    p, j = frames["port"][i], frames["jax"][i]
    np.testing.assert_array_equal(p["hit"], j["hit"])
    assert np.isfinite(p["ldr"]).all()
    frac = np.isclose(p["ldr"], j["ldr"], rtol=1e-2, atol=1e-3).all(-1).mean()
    assert frac >= 0.99, f"frame {i}: {frac:.4f} of pixels within tolerance"
    assert float(j["nrc_loss"]) > 0.0
    assert abs(float(p["nrc_loss"]) - float(j["nrc_loss"])) <= 1e-3 * abs(float(j["nrc_loss"]))
    assert abs(float(p["nrc_query_frac"]) - float(j["nrc_query_frac"])) <= 0.005
    assert (p["nrc_debug"] == j["nrc_debug"]).mean() >= 0.999


def test_nrc_frame_hands_paths_to_the_cache(frames):
    """In the atrium the spread heuristic fires: a real share of the paths
    ends in the cache, and the cache's loss falls from frame to frame."""
    p = frames["port"]
    assert 0.05 < float(p[0]["nrc_query_frac"]) < 0.95
    assert float(p[1]["nrc_loss"]) < float(p[0]["nrc_loss"])
    assert frames["renderer"].state["nrc"]["opt_state"]["count"] == 4  # 2 frames x 2 batches of 16,384


def test_nrc_debug_views(frames, scene):
    """bounce_heatmap and query_bounce are the query pass's counters of the
    frame; cache_view is the cache (before this frame's training) at the
    primary hits, as JAX's query_cache gives it; an unknown mode raises."""
    import jax
    import jax.numpy as jnp
    from nebulae_tpu.nrc.cache import query_cache as jquery

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine import renderer as rmod
    from nebulae_tpu_torch.interop import nrc_state_from_arrays

    seen = {}
    query = rmod.path_trace_nrc_query

    def spy(*args, **kwargs):
        out = query(*args, **kwargs)
        seen["aux"] = out[2]
        return out

    views = {}
    for mode in ("bounce_heatmap", "query_bounce", "cache_view"):
        r = rmod.Renderer(scene["fs"], RenderConfig(**dict(KW, nrc_debug=mode)), device="cpu")
        r.state["nrc"] = nrc_state_from_arrays(frames["jax_cache"], "cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(rmod, "path_trace_nrc_query", spy)
            out = r.render(scene["cam"])
        views[mode] = out["nrc_debug"]
    assert torch.equal(views["bounce_heatmap"], seen["aux"]["n_vert"].reshape(S, S))
    assert torch.equal(views["query_bounce"], seen["aux"]["term_bounce"].reshape(S, S))
    assert float(views["bounce_heatmap"].max()) <= KW["max_bounces"]
    np.testing.assert_array_equal(views["query_bounce"].numpy(), frames["port"][0]["nrc_debug"])

    # cache_view against JAX's query_cache on the port's own G-buffer.
    from nebulae_tpu_torch.passes.gbuffer import camera_rays, make_camera_arrays, render_gbuffer
    from nebulae_tpu_torch.tracer.trace import make_tracer

    cfg = RenderConfig(**KW)
    closest, _ = make_tracer(r.scene, r.tables, cfg, device="cpu")
    o, d = camera_rays(make_camera_arrays(scene["cam"], S, S, "cpu"), S, S)
    g = {k: v.numpy() for k, v in render_gbuffer(r.scene, closest, o, d, image_hw=(S, S)).items()}
    surf = {k: jnp.asarray(g[k]) for k in ("position", "normal_s", "albedo", "roughness", "metalness")}
    ref = jax.jit(jquery)(jax.tree.map(jnp.asarray, frames["jax_cache"]["ema_params"]), surf,
                          jnp.asarray(g["view"]), jnp.asarray(r.scene["aabb_min"].numpy()),
                          jnp.asarray(r.scene["aabb_max"].numpy()))
    ref = np.where(g["hit"][..., None], np.asarray(ref), 0.0).reshape(S, S, 3)
    view = views["cache_view"].numpy()
    assert (view[~g["hit"].reshape(S, S)] == 0).all() and view.max() > 0
    assert np.isclose(view, ref, rtol=1e-5, atol=0).mean() >= 0.999
    np.testing.assert_allclose(view, ref, rtol=1e-2)

    with pytest.raises(ValueError, match="nrc_debug"):
        r.update_config(RenderConfig(**dict(KW, nrc_debug="no such view")))
        r.render(scene["cam"])


def test_unroll_query_changes_no_output(scene):
    """nrc_unroll_query picks a TPU loop strategy; the port's bounce loop is
    a Python loop either way."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer

    kw = dict(KW, width=24, height=24)
    outs = [Renderer(scene["fs"], RenderConfig(**dict(kw, nrc_unroll_query=u)), device="cpu").render(scene["cam"])
            for u in (False, True)]
    for k in ("hdr", "ldr", "nrc_loss", "nrc_query_frac"):
        assert torch.equal(outs[0][k], outs[1][k]), k


def test_lean_outputs_carry_the_cache_scalars(scene):
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer

    out = Renderer(scene["fs"], RenderConfig(**dict(KW, lean_outputs=True, width=24, height=24)),
                   device="cpu").render(scene["cam"])
    assert set(out) == {"ldr", "nrc_loss", "nrc_query_frac"}
    assert float(out["nrc_loss"]) > 0.0 and 0.0 < float(out["nrc_query_frac"]) < 1.0


def test_nrc_without_gi_neither_trains_nor_queries(scene):
    """As in JAX, the cache trains and answers only on the GI path."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer

    kw = dict(KW, enable_gi=False, width=24, height=24)
    r = Renderer(scene["fs"], RenderConfig(**kw), device="cpu")
    before = r.state["nrc"]
    out = r.render(scene["cam"])
    assert r.state["nrc"] is before
    assert float(out["nrc_loss"]) == 0.0 and float(out["nrc_query_frac"]) == 0.0
    plain = Renderer(scene["fs"], RenderConfig(**dict(kw, enable_nrc=False)), device="cpu").render(scene["cam"])
    assert torch.equal(out["ldr"], plain["ldr"])


def test_resize_keeps_the_cache_and_update_config_creates_one(scene):
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer

    kw = dict(KW, width=24, height=16)
    r = Renderer(scene["fs"], RenderConfig(**kw), device="cpu")
    r.render(scene["cam"])
    cache = r.state["nrc"]
    assert cache["opt_state"]["count"] == 1
    r.resize(20, 12)
    assert r.state["nrc"] is cache and r.state["frame"] == 0
    out = r.render(scene["cam"])
    assert out["ldr"].shape == (12, 20, 3) and r.state["nrc"]["opt_state"]["count"] == 2

    off = Renderer(scene["fs"], RenderConfig(**dict(kw, enable_nrc=False)), device="cpu")
    assert "nrc" not in off.state
    off.update_config(RenderConfig(**kw))
    assert off.state["nrc"]["opt_state"]["count"] == 0
    out = off.render(scene["cam"])
    assert off.state["nrc"]["opt_state"]["count"] == 1 and float(out["nrc_query_frac"]) > 0.0


# ---------------------------------------------------------------------------
# The quality probe
# ---------------------------------------------------------------------------


def test_quality_probe_plumbing():
    """The probe at a reduced size on the CPU: finite MSEs and the keys of
    JAX's probe.  Its ratio at the defaults (< 1) is chip_smoke.py's."""
    from nebulae_tpu_torch.utils.nrc_quality import nrc_quality_probe

    out = nrc_quality_probe(res=16, budget_bounces=2, truth_bounces=4, frames=2, truth_frames=4, warmup=2,
                            device="cpu")
    assert set(out) == {"mse_nrc_on", "mse_nrc_off", "ratio", "res", "frames", "budget_bounces", "truth_bounces"}
    assert np.isfinite(out["mse_nrc_on"]) and np.isfinite(out["mse_nrc_off"]) and out["ratio"] > 0.0


def jax_probe() -> dict:
    """JAX's nrc_quality_probe at its defaults on the port's small atrium
    (the same numpy scene and camera), on the CPU."""
    from nebulae_tpu.core.camera import Camera as JCamera
    from nebulae_tpu.core.scene import FlatScene as JFlatScene
    from nebulae_tpu.utils.nrc_quality import nrc_quality_probe as jprobe

    from nebulae_tpu_torch.utils.testscenes import atrium_camera, small_atrium

    fs = small_atrium(0)
    cam = atrium_camera(fs)
    return jprobe(seed_scene=JFlatScene(**fs.field_arrays()),
                  camera=JCamera(eye=cam.eye, target=cam.target, fov_y_deg=cam.fov_y_deg))


def port_probe() -> dict:
    """The port's nrc_quality_probe at its defaults, on the CPU."""
    from nebulae_tpu_torch.utils.nrc_quality import nrc_quality_probe

    return nrc_quality_probe(device="cpu")


def ema_drift(frames: int = 64) -> list:
    """The quality probe's cache-on renderer (small atrium, 48x48, 3
    bounces, 8 cache path vertices, fast bounce shading, no SVGF or
    tonemap) in JAX and in the port on the CPU, the port starting from
    JAX's initial cache: after each of `frames` warm-up frames, the
    relative L2 between the two packages' EMA parameters (all leaves in
    one vector).  Prints one line per frame; returns the list."""
    import jax

    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.core.scene import FlatScene as JFlatScene
    from nebulae_tpu.engine.renderer import Renderer as JRenderer

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.interop import nrc_state_from_arrays
    from nebulae_tpu_torch.utils.testscenes import atrium_camera, small_atrium

    fs = small_atrium(0)
    cam = atrium_camera(fs)
    kw = dict(width=48, height=48, spp=1, max_bounces=3, enable_svgf=False, enable_tonemap=False,
              fast_bounce_shading=True, jitter_primary=False, enable_nrc=True, nrc_max_path_vertices=8)
    jr = JRenderer(JFlatScene(**fs.field_arrays()), JCfg(**kw))
    pr = Renderer(fs, RenderConfig(**kw), device="cpu")
    pr.state["nrc"] = nrc_state_from_arrays(jax.tree.map(np.asarray, jr.state["nrc"]), "cpu")

    def leaves(params):
        return np.concatenate([np.asarray(layer[k], np.float64).reshape(-1) for layer in params for k in ("w", "b")])

    out = []
    for i in range(frames):
        jl = float(np.asarray(jr.render(_jcam(cam))["nrc_loss"]))
        pl = float(pr.render(cam)["nrc_loss"])
        j = leaves(jax.tree.map(np.asarray, jr.state["nrc"]["ema_params"]))
        p = leaves([{k: t.numpy() for k, t in layer.items()} for layer in pr.state["nrc"]["ema_params"]])
        rel = float(np.linalg.norm(p - j) / np.linalg.norm(j))
        out.append(rel)
        print(f"frame {i + 1}: EMA params relative L2 {rel:.3e}; nrc_loss JAX {jl:.6f} port {pl:.6f}", flush=True)
    return out


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_nrc_frame.py --jax-probe | --port-probe | --ema-drift
    print({"--jax-probe": jax_probe, "--port-probe": port_probe, "--ema-drift": ema_drift}[sys.argv[1]]())
