"""The radiance cache's quality at an equal frame budget.

Counterpart of `nebulae_tpu/utils/nrc_quality.py`: in an interior (where
the spread heuristic hands paths to the cache) accumulate a few
short-path frames with the cache on and off and compare both with a
long-path accumulation.  A trained cache recovers the energy the short
paths lose, so mse_nrc_on < mse_nrc_off; an under-trained one inverts that.
The default scene is utils.testscenes.small_atrium (the JAX probe's
helmet_atrium needs an asset this repository does not ship).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np


def _accumulate(renderer, camera, frames: int, skip: int = 0) -> np.ndarray:
    """Mean HDR radiance over `frames` renders after `skip` unaccumulated
    ones (the cache's warm-up); the frame counter reseeds each frame."""
    acc = None
    for _ in range(skip):
        renderer.render(camera)
    for _ in range(frames):
        img = renderer.render(camera)["hdr"].double().cpu().numpy()
        acc = img if acc is None else acc + img
    return acc / frames


def nrc_quality_probe(res: int = 48, budget_bounces: int = 3, truth_bounces: int = 8, frames: int = 4,
                      truth_frames: int = 48, warmup: int = 64, seed_scene=None, camera=None, device=None):
    """{mse_nrc_on, mse_nrc_off, ratio (on / off; < 1: the cache helps),
    res, frames, budget_bounces, truth_bounces}, rendered on `device`
    (CUDA unless "cpu" is asked for)."""
    from nebulae_tpu_torch.config import RenderConfig
    from nebulae_tpu_torch.engine.renderer import Renderer
    from nebulae_tpu_torch.utils.testscenes import atrium_camera, small_atrium

    fs = seed_scene if seed_scene is not None else small_atrium(0)
    cam = camera if camera is not None else atrium_camera(fs)
    base = RenderConfig(width=res, height=res, spp=1, max_bounces=budget_bounces, enable_svgf=False,
                        enable_tonemap=False, fast_bounce_shading=True, jitter_primary=False)

    r_truth = Renderer(fs, replace(base, max_bounces=truth_bounces), device=device)
    truth = _accumulate(r_truth, cam, truth_frames)
    bvh = r_truth.bvh
    img_off = _accumulate(Renderer(fs, base, bvh=bvh, device=device), cam, frames)
    r_on = Renderer(fs, replace(base, enable_nrc=True, nrc_max_path_vertices=truth_bounces), bvh=bvh,
                    device=device)
    img_on = _accumulate(r_on, cam, frames, skip=warmup)

    mse_on = float(np.mean((img_on - truth) ** 2))
    mse_off = float(np.mean((img_off - truth) ** 2))
    return {
        "mse_nrc_on": round(mse_on, 6),
        "mse_nrc_off": round(mse_off, 6),
        "ratio": round(mse_on / max(mse_off, 1e-12), 4),
        "res": res,
        "frames": frames,
        "budget_bounces": budget_bounces,
        "truth_bounces": truth_bounces,
    }
