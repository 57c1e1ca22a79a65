"""Carry state across from the JAX package, as numpy, into the port's tensors.

Nothing here imports JAX: the caller converts JAX arrays with `np.asarray`
first.  Used by the parity tests to feed both packages the same inputs, and
to hand a JAX frame state (SVGF history included), train parameters, optax
Adam state and traversal tables (packed or refit) to the port.
"""

from __future__ import annotations

import numpy as np
import torch

from nebulae_tpu_torch.config import SUN_LEAVES, SunLight
from nebulae_tpu_torch.core.scene import to_tensors
from nebulae_tpu_torch.engine.train import TRAINABLE_SCENE_KEYS
from nebulae_tpu_torch.kernels import trace as kt

_HIST_KEYS = ("radiance", "depth", "normal", "moments", "histlen", "prev_viewproj", "prev_eye")


def scene_from_arrays(arrays: dict, device) -> dict:
    """A `FlatScene.device_arrays()` dict (numpy) -> scene tensors."""
    return to_tensors({k: np.asarray(v) for k, v in arrays.items()}, device)


def _tensor(x, device):
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def sun_from_arrays(direction, radiance, tan_half_angle, sky_color, device) -> SunLight:
    """The four SunLight leaves (numpy) -> a SunLight on `device`."""
    return SunLight(*(_tensor(x, device) for x in (direction, radiance, tan_half_angle, sky_color)))


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


def _rows(table, width: int) -> np.ndarray:
    """A TPU table [blocks, width, 128] as row-major [blocks * 128, width]."""
    table = np.asarray(table, np.float32)
    return np.ascontiguousarray(table.transpose(0, 2, 1)).reshape(-1, width)


def _as_bits(cols: np.ndarray) -> np.ndarray:
    """Integers held exactly in f32 -> the same integers as int32 bits."""
    return np.rint(cols).astype(np.int32).view(np.float32)


def _levels_from_children(children: list[np.ndarray], n: int) -> np.ndarray:
    """Depth (root 1) of each row of a table whose child rows follow their
    parent; children[k][i] is row i's k-th child row, or -1."""
    level = np.ones(n, np.int64)
    for i in range(n):
        for c in children:
            if c[i] >= 0:
                level[c[i]] = level[i] + 1
    return level


def _tris_from_array(tris, n_slots: int) -> np.ndarray:
    g = np.asarray(tris).shape[1] // kt.TRI_STRIDE
    out = _rows(tris, kt.TRI_STRIDE * g)[:max(n_slots, 1)].reshape(-1, g, kt.TRI_STRIDE).copy()
    out[..., 9] = _as_bits(out[..., 9])
    return out


def _slot_end(enc: np.ndarray) -> int:
    """One past the last triangle slot the leaf encodings reference."""
    field = enc & 31
    leaf = (field > 0) & (field <= kt.MAX_LEAF_FIELD)
    return int(((enc >> kt.META_SHIFT) + field)[leaf].max(initial=0))


def tables_from_arrays(bvh: dict) -> dict:
    """A JAX Renderer.bvh, or a packer's dict (leaves as numpy), -> the
    port's traversal tables (numpy, for tables_to).

    Takes "fatnodes", "fat4nodes" (with "fat4_slots"), "nodes", "tris" and
    "chunks"; strips the 128-row padding and the paged route's padding,
    turns the f32 encodings into int32 bits, and derives stack_depth as the
    port's packers do.  "inner_idx" comes from node_count when the dict has
    it."""
    if "chunks" in bvh:
        return {"chunks": [tables_from_arrays(c) for c in bvh["chunks"]]}
    out = {}
    if "fatnodes" in bvh:
        rows = _rows(bvh["fatnodes"], kt.FAT_STRIDE)
        rows = rows[:int(np.count_nonzero(rows[:, 12] != 0))].copy()
        enc = np.rint(rows[:, 12:14]).astype(np.int64)
        rows[:, 12:15] = _as_bits(rows[:, 12:15])
        inner = (enc & 31) >= kt.INNER_FIELD
        kids = [np.where(inner[:, k], enc[:, k] >> kt.META_SHIFT, -1) for k in range(2)]
        # Leaves hang one level below the deepest inner row.
        out["stack_depth"] = int(_levels_from_children(kids, rows.shape[0]).max(initial=0)) + 2
        out["fatnodes"] = rows
        if "node_count" in bvh:
            out["inner_idx"] = np.nonzero(np.asarray(bvh["node_count"]) == 0)[0]
    elif "fat4nodes" in bvh:
        rows = _rows(bvh["fat4nodes"], kt.NODE_STRIDE)
        n = int(np.count_nonzero(rows[:, 24] != 0))
        rows = rows[:n].copy()
        enc = np.rint(rows[:, 24:28]).astype(np.int64)
        rows[:, 24:29] = _as_bits(rows[:, 24:29])
        kids = [np.where((enc[:, k] & 31) >= kt.INNER_FIELD, enc[:, k] >> kt.META_SHIFT, -1) for k in range(4)]
        out["stack_depth"] = 3 * int(_levels_from_children(kids, n).max(initial=0)) + 1
        out["fat4nodes"] = rows
        if "fat4_slots" in bvh:
            out["fat4_slots"] = np.asarray(bvh["fat4_slots"], np.int32)[:n]
    else:
        rows = _rows(bvh["nodes"], kt.ONE_NODE_STRIDE)
        rows = rows[:int(np.count_nonzero(rows[:, 6] != 0))].copy()
        enc = np.rint(rows[:, 6:7]).astype(np.int64)
        rows[:, 6] = _as_bits(rows[:, 6])
        inner = (enc[:, 0] & 31) >= kt.INNER_FIELD
        n = rows.shape[0]
        kids = [np.where(inner, np.arange(n) + 1, -1), np.where(inner, enc[:, 0] >> kt.META_SHIFT, -1)]
        out["stack_depth"] = int(_levels_from_children(kids, n).max(initial=0)) + 1
        out["nodes"] = rows
    out["tris"] = _tris_from_array(bvh["tris"], _slot_end(enc))
    return out
