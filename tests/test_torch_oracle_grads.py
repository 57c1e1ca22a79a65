"""The port's gradients held to its reference tracer on the CPU: the
counterpart of JAX's tests/test_pipeline.py:62-104, which needs the absent
Cornell asset, on the procedural small atrium.

torch.autograd through `render_frame` (device="cpu") of mean(hdr) at 48x48,
2 bounces, SVGF and ACES off, with respect to three `mat_base_color`
entries and the three channels of `sun.radiance`, against central
differences (eps 1e-3) of `nebulae_tpu_torch.ref.tracer.path_trace` on the
same scene tables: |g - fd| < 2e-3 * max(1, |fd|), as test_pipeline.py:100.
The sampling does not depend on the sun's radiance, and on the base colour
only through the roulette's diffuse probability: eps is small enough that
no draw of this frame crosses it.
"""

import numpy as np
import pytest
import torch

from test_torch_ref import one_torch_thread  # noqa: F401  (an autouse fixture)

S = 48
KW = dict(width=S, height=S, spp=1, max_bounces=2, enable_svgf=False, enable_tonemap=False)
EPS = 1e-3
ENTRIES = [(0, 0), (1, 1), (2, 2)]


@pytest.fixture(scope="module")
def grads():
    from nebulae_tpu_torch.config import RenderConfig, SunLight
    from nebulae_tpu_torch.engine.renderer import Renderer, init_frame_state, render_frame
    from nebulae_tpu_torch.passes.gbuffer import make_camera_arrays
    from nebulae_tpu_torch.utils.testscenes import atrium_camera, small_atrium

    fs = small_atrium(0)
    cam = atrium_camera(fs)
    cfg = RenderConfig(**KW)
    r = Renderer(fs, cfg, device="cpu")
    base = r.scene["mat_base_color"].clone().requires_grad_(True)
    radiance = r.sun.radiance.clone().requires_grad_(True)
    sun = SunLight(r.sun.direction, radiance, r.sun.tan_half_angle, r.sun.sky_color)
    out, _ = render_frame({**r.scene, "mat_base_color": base}, r.tables, sun, make_camera_arrays(cam, S, S, "cpu"),
                          init_frame_state(cfg, "cpu"), cfg, device="cpu")
    g_base, g_rad = torch.autograd.grad(out["hdr"].mean(), [base, radiance])
    return {"fs": fs, "cam": cam, "cfg": cfg, "sun": SunLight.default("cpu"), "hdr": out["hdr"].detach(),
            "g_base": g_base.numpy(), "g_rad": g_rad.numpy()}


def _loss(g, arrays=None, sun=None):
    from nebulae_tpu_torch.ref.tracer import path_trace

    arrays = g["fs"].device_arrays() if arrays is None else arrays
    return float(path_trace(arrays, g["cam"], g["cfg"], g["sun"] if sun is None else sun, device="cpu").double().mean())


def test_frame_is_the_reference_frame(grads):
    """The differentiated frame is the reference tracer's frame."""
    from nebulae_tpu_torch.ref.tracer import path_trace

    g = grads
    ref = path_trace(g["fs"].device_arrays(), g["cam"], g["cfg"], g["sun"], device="cpu")
    torch.testing.assert_close(g["hdr"], ref, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("mat,ch", ENTRIES)
def test_base_color_gradient_matches_reference_fd(grads, mat, ch):
    g = grads
    arrays = g["fs"].device_arrays()
    losses = []
    for sign in (1.0, -1.0):
        bc = arrays["mat_base_color"].copy()
        bc[mat, ch] += sign * EPS
        losses.append(_loss(g, {**arrays, "mat_base_color": bc}))
    fd = (losses[0] - losses[1]) / (2 * EPS)
    got = float(g["g_base"][mat, ch])
    print(f"d mean(hdr) / d mat_base_color[{mat}, {ch}]: autograd {got:.6g}, central difference {fd:.6g}")
    assert abs(got - fd) < 2e-3 * max(1.0, abs(fd)), (got, fd)


@pytest.mark.parametrize("ch", [0, 1, 2])
def test_sun_radiance_gradient_matches_reference_fd(grads, ch):
    from nebulae_tpu_torch.config import SunLight

    g = grads
    losses = []
    for sign in (1.0, -1.0):
        rad = g["sun"].radiance.clone()
        rad[ch] += sign * EPS
        losses.append(_loss(g, sun=SunLight(g["sun"].direction, rad, g["sun"].tan_half_angle, g["sun"].sky_color)))
    fd = (losses[0] - losses[1]) / (2 * EPS)
    got = float(g["g_rad"][ch])
    print(f"d mean(hdr) / d sun.radiance[{ch}]: autograd {got:.6g}, central difference {fd:.6g}")
    assert abs(got - fd) < 2e-3 * max(1.0, abs(fd)), (got, fd)


def test_gradients_are_nonzero(grads):
    assert np.abs(grads["g_base"]).max() > 1e-4
    assert (grads["g_rad"] > 0).all()  # more sun, a brighter frame
