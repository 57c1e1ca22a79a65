"""The port's 2-rank frames and gradients against JAX's distribution, on the CPU.

The port runs as 2 gloo processes of `python -m nebulae_tpu_torch.dist.dryrun`
(as in tests/test_torch_dist.py, one thread each, 120 s timeout), JAX on a
2-device CPU mesh (conftest forces 8 CPU devices), from the same scene,
cameras and target.  Tolerances:
  * frames (32x32, 4 bounces, SVGF, ACES; still, then orbiting) against
    JAX's DistRenderer: hit mask equal, >= 99% of pixels within rtol 1e-3 /
    atol 1e-4 (tests/test_torch_frame.py's tolerance for one process);
  * the train step's loss and gradients against JAX's render_loss under
    jit with the rows sharded (as tests/test_dist.py:60-104): loss within a
    relative 1e-5, each gradient with a cosine >= 0.9999 and a relative L2
    <= 1e-3.
One fixture compiles JAX's frame and its gradient (~90 s together).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_dist import CASES, grad_close, recorded, results

MAT_KEYS = ("mat_base_color", "mat_metallic", "mat_roughness", "mat_emissive")
SUN_KEYS = ("direction", "radiance", "tan_half_angle", "sky_color")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from nebulae_tpu.config import RenderConfig as JCfg
    from nebulae_tpu.core.camera import Camera as JCamera
    from nebulae_tpu.core.scene import FlatScene as JFlatScene
    from nebulae_tpu.dist.mesh import make_mesh, replicated, shard_frame_state, shard_pixels
    from nebulae_tpu.dist.runner import DistRenderer as JDist
    from nebulae_tpu.dist.runner import present_gather as jgather
    from nebulae_tpu.engine.renderer import init_frame_state as jinit
    from nebulae_tpu.engine.train import render_loss as jloss
    from nebulae_tpu.engine.train import split_scene_params as jsplit
    from nebulae_tpu.passes.gbuffer import make_camera_arrays as jcam_arrays

    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.dist.dryrun import cameras, train_target
    from nebulae_tpu_torch.utils.testscenes import textured_scene

    tmp = tmp_path_factory.mktemp("dist_jax") / "2r32"
    n, w, h, flags = CASES["2r32"]
    procs = recorded(tmp, n, w, h, flags)

    fs = textured_scene(0)
    jcfg = JCfg(width=w, height=h, max_bounces=4)
    mesh = make_mesh(2)
    jr = JDist(JFlatScene(**fs.field_arrays()), jcfg, mesh=mesh)
    jcams = [JCamera(eye=c.eye, target=c.target, fov_y_deg=c.fov_y_deg) for c in cameras(fs, 2, 4.0)]
    frames = []
    for cam in jcams:
        # JAX's jitted frame takes the state in shard_frame_state's
        # placement, whose shape rule row-shards the 4x4 prev_viewproj on 2
        # devices, and returns it replicated: it refuses its own second
        # frame unless the state is put back in that placement.
        jr.state = jax.device_put(jr.state, shard_frame_state(mesh, jr.state))
        out = jr.render(cam)
        frames.append({k: jgather(out[k]) for k in ("hdr", "denoised", "ldr", "hit")})

    jp, jfrozen = jsplit(jr.scene)
    jp["sun"] = jr.sun
    jstate = jinit(jcfg)
    in_sh = (jax.tree.map(lambda _: replicated(mesh), jp), shard_frame_state(mesh, jstate),
             shard_pixels(mesh, 3, axis=0))
    jcam = jcam_arrays(jcams[0], w, h)

    def grads_fn(p, st, tgt):
        return jax.value_and_grad(partial(jloss, cfg=jcfg, train_sun=True), has_aux=True)(
            p, jfrozen, jr.bvh, jcam, st, tgt)

    target = jnp.asarray(train_target(RenderConfig(width=w, height=h)))
    (loss, _), g = jax.jit(grads_fn, in_shardings=in_sh)(
        jp, jax.device_put(jstate, in_sh[1]), jax.device_put(target, in_sh[2]))
    grads = [np.asarray(g[k]) for k in MAT_KEYS] + [np.asarray(getattr(g["sun"], k)) for k in SUN_KEYS]
    return {"port": results(tmp, procs)[0], "frames": frames, "loss": float(loss), "grads": grads}


@pytest.mark.parametrize("frame", [0, 1])
def test_sharded_frames_match_jax_dist_renderer(runs, frame):
    got, ref = runs["port"], runs["frames"][frame]
    np.testing.assert_array_equal(got[f"frame{frame}_hit"], ref["hit"].astype(np.uint8))
    for k in ("hdr", "denoised", "ldr"):
        close = np.isclose(got[f"frame{frame}_{k}"], ref[k], rtol=1e-3, atol=1e-4).all(-1).mean()
        assert close >= 0.99, f"{k}: {close:.4f} of pixels within tolerance"


def test_sharded_gradients_match_jax(runs):
    got = runs["port"]
    np.testing.assert_allclose(got["loss"], runs["loss"], rtol=1e-5)
    for i, g in enumerate(runs["grads"]):
        grad_close(got[f"grad{i}"], g, f"grad {i} ({(MAT_KEYS + SUN_KEYS)[i]})")
