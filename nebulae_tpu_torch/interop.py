"""Carry state across from the JAX package, as numpy, into the port's tensors.

Nothing here imports JAX: the caller converts JAX arrays with `np.asarray`
first.  Used by the parity tests to feed both packages the same inputs, and
to hand a JAX frame state (SVGF history included), train parameters and
optax Adam state to the port's next frame or train step.
"""

from __future__ import annotations

import numpy as np
import torch

from nebulae_tpu_torch.bvh.builder import FlatBVH
from nebulae_tpu_torch.config import SUN_LEAVES, SunLight
from nebulae_tpu_torch.core.scene import to_tensors
from nebulae_tpu_torch.engine.train import TRAINABLE_SCENE_KEYS

_BVH_KEYS = ("node_lo", "node_hi", "node_first", "node_count", "node_skip", "node_right", "tri_index")
_HIST_KEYS = ("radiance", "depth", "normal", "moments", "histlen", "prev_viewproj", "prev_eye")


def scene_from_arrays(arrays: dict, device) -> dict:
    """A `FlatScene.device_arrays()` dict (numpy) -> scene tensors."""
    return to_tensors({k: np.asarray(v) for k, v in arrays.items()}, device)


def _tensor(x, device):
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def sun_from_arrays(direction, radiance, tan_half_angle, sky_color, device) -> SunLight:
    """The four SunLight leaves (numpy) -> a SunLight on `device`."""
    return SunLight(*(_tensor(x, device) for x in (direction, radiance, tan_half_angle, sky_color)))


def bvh_from_arrays(arrays) -> FlatBVH:
    """A FlatBVH or its `device_arrays()` dict (numpy) -> the port's FlatBVH."""
    get = arrays.get if isinstance(arrays, dict) else (lambda k: getattr(arrays, k))
    return FlatBVH(**{k: np.asarray(get(k)) for k in _BVH_KEYS})


def frame_state_from_arrays(state: dict, device) -> dict:
    """A JAX frame state (init_frame_state or after a frame, leaves as
    numpy) -> the port's frame state.  Extra JAX-only entries (the bucket
    scheduler's live counts, NRC) are dropped."""
    hist = state["svgf"]
    return {
        "svgf": {k: torch.from_numpy(np.array(hist[k], np.float32)).to(device) for k in _HIST_KEYS},
        "frame": int(np.asarray(state["frame"])),
        "reset_history": bool(np.asarray(state["reset_history"])),
    }


def params_from_arrays(params: dict, device) -> dict:
    """JAX train params (the material tables of TRAINABLE_SCENE_KEYS and
    "sun", leaves as numpy) -> the port's params.  The sun may be a dict or
    any object with SunLight's four fields."""
    out = {k: _tensor(params[k], device) for k in TRAINABLE_SCENE_KEYS if k in params}
    sun = params["sun"]
    get = sun.get if isinstance(sun, dict) else (lambda k: getattr(sun, k))
    out["sun"] = sun_from_arrays(*(get(k) for k in SUN_LEAVES), device=device)
    return out


def adam_state_from_optax(state, device) -> dict:
    """optax's ScaleByAdamState (count, mu, nu; leaves as numpy), or the
    state tuple of optax.adam that starts with it -> the port's Adam state
    (engine.train.Adam)."""
    if not hasattr(state, "mu"):
        state = state[0]
    return {
        "count": int(np.asarray(state.count)),
        "mu": params_from_arrays(state.mu, device),
        "nu": params_from_arrays(state.nu, device),
    }
