"""ctypes wrapper for the native BVH builder (csrc/bvh_builder.cpp).

The builder is host code compiled by nvcc with the kernels
(kernels/build.py), so it exists where the GPU does.  `build_bvh_for`
picks it for CUDA and the numpy builder for the CPU; both produce the
layout of `bvh/builder.py`.
"""

from __future__ import annotations

import ctypes

import numpy as np

from nebulae_tpu_torch.bvh.builder import MAX_LEAF, FlatBVH, build_bvh
from nebulae_tpu_torch.kernels.build import native


def build_bvh_native(tri_pos: np.ndarray, max_leaf: int = MAX_LEAF) -> FlatBVH:
    """Binned-SAH build in C++ (same flat layout as the numpy builder)."""
    t = int(tri_pos.shape[0])
    if t == 0:
        return build_bvh(tri_pos, max_leaf)
    tri = np.ascontiguousarray(tri_pos, np.float32)
    max_nodes = 2 * t + 1
    out = {
        "node_lo": np.empty((max_nodes, 3), np.float32),
        "node_hi": np.empty((max_nodes, 3), np.float32),
        "node_first": np.empty(max_nodes, np.int32),
        "node_count": np.empty(max_nodes, np.int32),
        "node_skip": np.empty(max_nodes, np.int32),
        "node_right": np.empty(max_nodes, np.int32),
    }
    tri_index = np.empty(t, np.int32)

    def p(a):
        return ctypes.c_void_p(a.ctypes.data)

    n = native().lib.nebulae_build_bvh(
        p(tri), t, max_leaf, max_nodes, p(out["node_lo"]), p(out["node_hi"]),
        p(out["node_first"]), p(out["node_count"]), p(out["node_skip"]),
        p(out["node_right"]), p(tri_index),
    )
    if n < 0:
        raise RuntimeError("native BVH build overflowed its node buffer")
    return FlatBVH(**{k: v[:n].copy() for k, v in out.items()}, tri_index=tri_index)


def build_bvh_for(device, tri_pos: np.ndarray, max_leaf: int = MAX_LEAF) -> FlatBVH:
    """The native builder for CUDA devices, the numpy builder for the CPU."""
    if getattr(device, "type", str(device)) == "cuda":
        return build_bvh_native(tri_pos, max_leaf)
    return build_bvh(tri_pos, max_leaf)
