"""The neural radiance cache's knobs, and all three frame options together,
in the port against the JAX Renderer on the CPU.

tests/test_torch_nrc_options.py's setting (the small atrium at 48x48, 4
bounces, SVGF and ACES, the cache on; two frames, the port's each from
JAX's frame state before it) and tolerances (the hit mask equal, ldr on
>= 99% of pixels within rtol 1e-2 / atol 1e-3, nrc_loss to a relative
1e-3, nrc_query_frac within 0.5%; the RNG state after each frame's
samples bit-equal to JAX's).  Each case is one JAX compile; two knobs
share one where they touch separate code:
  * "all options": jitter_primary, fast_bounce_shading and enable_envmap
    (JAX's app's procedural sky) together;
  * "spp2, one iteration": two samples a pixel, each its own query pass
    (the counters of the last one), and nrc_train_iterations=1 at 4,096
    records an iteration, so the training pass shrinks to 32x32 and takes
    one optimizer step where the default takes four (at 16,384 records a
    48x48 frame's training pass holds one batch either way);
  * "no irradiance, no self-training": nrc_learn_irradiance=False, so
    neither query_cache nor train_cache_step (de)modulates by the vertex's
    F0 plus diffuse reflectance, and nrc_self_training=False, so the
    training pass's targets take no cache query as their tail.
The cache's optimizer step count equals JAX's after each case.
"""

import numpy as np
import pytest
from test_torch_nrc_options import KW, assert_nrc_frame_close, jax_and_port_frames, jax_rng_after_samples
from test_torch_nrc_options import one_torch_thread, scene  # noqa: F401  (fixtures)

CASES = {
    "all options": dict(jitter_primary=True, fast_bounce_shading=True, enable_envmap=True),
    "spp2, one iteration": dict(spp=2, nrc_train_iterations=1, nrc_records_per_iteration=4096),
    "no irradiance, no self-training": dict(nrc_learn_irradiance=False, nrc_self_training=False),
}


@pytest.fixture(scope="module", params=list(CASES))
def frames(request, scene):
    kw = dict(KW, **CASES[request.param])
    jax_out, port_out, rngs, counts = jax_and_port_frames(scene, kw)
    return {"name": request.param, "kw": kw, "jax": jax_out, "port": port_out, "rng": rngs, "counts": counts}


@pytest.mark.parametrize("i", [0, 1])
def test_nrc_knob_frame_matches_jax(frames, i):
    assert_nrc_frame_close(frames["port"][i], frames["jax"][i], f"{frames['name']} frame {i}")


def test_nrc_knob_rng_state_matches_jax(frames):
    assert len(frames["rng"]) == 2
    for i, rng in enumerate(frames["rng"]):
        np.testing.assert_array_equal(rng.numpy(), jax_rng_after_samples(frames["kw"], i))


def test_nrc_knob_optimizer_steps_match_jax(frames):
    """The training pass takes JAX's number of optimizer steps a frame:
    one under nrc_train_iterations=1, else as many batches as its records
    fill."""
    port, jax_count = frames["counts"]
    assert port == jax_count
    if frames["name"] == "spp2, one iteration":
        assert port == 2
