"""Parity of the port's a-trous step (plain K4), SVGF and ACES with JAX.

K4's plain version is held to atrous_step_pallas (interpret mode) and to
the XLA step svgf_atrous_step at rtol 1e-5 / atol 1e-6 on an odd 37x70
frame; the denoiser and tonemap over two frames.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

H, W = 37, 70


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    rad = rng.uniform(0, 2, (H, W, 3)).astype(np.float32)
    var = (rng.uniform(0, 1, (H, W)) * 0.05).astype(np.float32)
    # Smooth depth and normals so that the edge stops keep many taps.
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dep = (3.0 + 0.001 * xx + 0.0005 * yy + rng.uniform(0, 2e-3, (H, W))).astype(np.float32)
    n = rng.normal(size=(H, W, 3)) * 0.05 + [0, 0, 1]
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    dep[5:9, 10:20] = np.inf  # a miss patch (depth clamps to 1e8)
    return rad, var, dep, n


@pytest.mark.parametrize("step", [1, 2, 4, 8])
def test_plain_atrous_matches_pallas_and_xla(step):
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.kernels.pallas_svgf import atrous_step_pallas
    from nebulae_tpu.passes.svgf import svgf_atrous_step

    from nebulae_tpu_torch.kernels.svgf import atrous_step

    cfg = JCfg()
    rad, var, dep, n = _inputs()
    j = [jnp.asarray(x) for x in (rad, var, dep, n)]
    out, sum_w = atrous_step(*(torch.from_numpy(x) for x in (rad, var, dep, n)), step,
                             (cfg.svgf_phi_color, cfg.svgf_phi_normal, cfg.svgf_phi_depth))
    pallas = np.asarray(atrous_step_pallas(*j, step, cfg, interpret=True))
    xla = np.asarray(svgf_atrous_step(*j, step, cfg))
    np.testing.assert_allclose(out.numpy(), pallas, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), xla, rtol=1e-5, atol=1e-6)
    assert float(sum_w.min()) > 0.0


def _hist_np(hist):
    return {k: np.asarray(v) for k, v in hist.items()}


def test_svgf_denoise_and_aces_two_frames():
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.passes.svgf import init_history as jinit
    from nebulae_tpu.passes.svgf import svgf_denoise as jden
    from nebulae_tpu.passes.tonemap import aces_tonemap as jaces

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.passes.svgf import init_history, svgf_denoise
    from nebulae_tpu_torch.passes.tonemap import aces_tonemap

    jcfg, pcfg = JCfg(), RenderConfig()
    jh = jinit(H, W)
    ph = init_history(H, W, "cpu")
    for frame in range(2):
        rad, _, dep, n = _inputs(seed=frame)
        hit = np.isfinite(dep)
        jout, jh = jden(jnp.asarray(rad), jnp.asarray(dep), jnp.asarray(n), jh, jcfg, hit=jnp.asarray(hit))
        pout, ph = svgf_denoise(torch.from_numpy(rad), torch.from_numpy(dep), torch.from_numpy(n),
                                ph, pcfg, hit=torch.from_numpy(hit))
        np.testing.assert_allclose(pout.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-5)
        for k, v in _hist_np(jh).items():
            np.testing.assert_allclose(ph[k].numpy(), v, rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(aces_tonemap(pout).numpy(), np.asarray(jaces(jout)), rtol=1e-5, atol=1e-5)
    assert float(ph["histlen"].max()) == 2.0


def test_aces_matches_on_hdr_range():
    from nebulae_tpu.passes.tonemap import aces_tonemap as jaces

    from nebulae_tpu_torch.passes.tonemap import aces_tonemap

    hdr = np.random.default_rng(1).exponential(2.0, (64, 48, 3)).astype(np.float32)
    np.testing.assert_allclose(aces_tonemap(torch.from_numpy(hdr)).numpy(), np.asarray(jaces(jnp.asarray(hdr))),
                               rtol=1e-5, atol=1e-6)


def test_reproject_history_matches():
    from nebulae_tpu.passes.svgf import reproject_history as jrep

    from nebulae_tpu_torch.passes.svgf import reproject_history

    rng = np.random.default_rng(2)
    hist = {
        "radiance": rng.uniform(0, 1, (H, W, 3)), "depth": rng.uniform(1, 5, (H, W)),
        "normal": rng.normal(size=(H, W, 3)), "moments": rng.uniform(0, 1, (H, W, 2)),
        "histlen": rng.integers(0, 5, (H, W)).astype(np.float64),
    }
    hist = {k: v.astype(np.float32) for k, v in hist.items()}
    pos = (rng.uniform(-3.5, 3.5, (H, W, 3)) + [0, 0, -4]).astype(np.float32)
    depth = rng.uniform(1, 6, (H, W)).astype(np.float32)
    f = 1.0 / np.tan(np.deg2rad(30.0))
    proj = np.float32([[f * H / W, 0, 0, 0], [0, f, 0, 0], [0, 0, -1.0, -0.02], [0, 0, -1, 0]])
    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = [0.05, -0.02, 0.1]
    vp = proj @ view
    eye = np.float32([-0.05, 0.02, -0.1])
    jw, jv = jrep({k: jnp.asarray(v) for k, v in hist.items()}, jnp.asarray(pos), jnp.asarray(vp), W, H,
                  prev_eye=jnp.asarray(eye), current_depth=jnp.asarray(depth))
    pw, pv = reproject_history({k: torch.from_numpy(v) for k, v in hist.items()}, torch.from_numpy(pos),
                               torch.from_numpy(vp), W, H, torch.from_numpy(eye), torch.from_numpy(depth))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert 0.3 < pv.numpy().mean() < 1.0
    for k in jw:
        np.testing.assert_allclose(pw[k].numpy(), np.asarray(jw[k]), rtol=1e-4, atol=1e-4, err_msg=k)
