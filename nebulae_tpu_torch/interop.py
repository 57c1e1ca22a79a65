"""Carry state across from the JAX package, as numpy, into the port's tensors.

Nothing here imports JAX: the caller converts JAX arrays with `np.asarray`
first.  Used by the parity tests to feed both packages the same inputs, and
to hand a JAX frame state (SVGF history included) to the port's next frame.
"""

from __future__ import annotations

import numpy as np
import torch

from nebulae_tpu_torch.bvh.builder import FlatBVH
from nebulae_tpu_torch.config import SunLight
from nebulae_tpu_torch.core.scene import to_tensors

_BVH_KEYS = ("node_lo", "node_hi", "node_first", "node_count", "node_skip", "node_right", "tri_index")
_HIST_KEYS = ("radiance", "depth", "normal", "moments", "histlen", "prev_viewproj", "prev_eye")


def scene_from_arrays(arrays: dict, device) -> dict:
    """A `FlatScene.device_arrays()` dict (numpy) -> scene tensors."""
    return to_tensors({k: np.asarray(v) for k, v in arrays.items()}, device)


def sun_from_arrays(direction, radiance, tan_half_angle, sky_color, device) -> SunLight:
    """The four SunLight leaves (numpy) -> a SunLight on `device`."""
    def t(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    return SunLight(t(direction), t(radiance), t(tan_half_angle), t(sky_color))


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
