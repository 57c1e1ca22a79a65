"""Render configuration and lighting parameters.

`RenderConfig` mirrors `nebulae_tpu.config.RenderConfig` field for field,
with the same defaults (a test checks both).  Several fields only choose a
TPU strategy (bucket_scheduling, bucket_schedule, bvh_tri_group,
sort_segments, svgf_pallas, bvh_wide); the port accepts them and they do
not change its output.  chunk_mode picks the traversal tables' route as in
JAX (engine/renderer.py::pack_scene_tables) and does not change the image
either.  `SunLight` holds tensors on one device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class RenderConfig:
    """Static render options (same names and defaults as the JAX package)."""

    width: int = 256
    height: int = 256
    spp: int = 1
    max_bounces: int = 8
    throughput_threshold: float = 0.0
    enable_gi: bool = True
    enable_svgf: bool = True
    enable_nrc: bool = False
    enable_tonemap: bool = True
    enable_envmap: bool = False
    jitter_primary: bool = False
    svgf_temporal_alpha: float = 0.9
    svgf_depth_sigma: float = 0.002
    svgf_variance_eps: float = 1e-4
    svgf_phi_color: float = 4.0
    svgf_phi_normal: float = 128.0
    svgf_phi_depth: float = 0.002
    svgf_atrous_passes: int = 4
    svgf_pallas: bool = True
    svgf_reproject: bool = True
    nrc_max_path_vertices: int = 8
    nrc_train_iterations: int = 4
    nrc_records_per_iteration: int = 16384
    nrc_self_training: bool = True
    nrc_learning_rate: float = 1e-2
    nrc_terminate_threshold: float = 0.01
    nrc_train_terminate_threshold: float = 0.01
    nrc_unbiased_fraction: float = 0.0625
    nrc_learn_irradiance: bool = True
    nrc_inline_resolve: bool = True
    nrc_unroll_query: bool = False
    nrc_debug: str | None = None
    lean_outputs: bool = False
    # "auto" | "bruteforce" | "pallas" (the traversal kernels of the
    # tables' route) | "bvh" (JAX's XLA walk of the same tree; here the
    # tables' kernels, as "pallas").
    tracer: str = "auto"
    # Order the live lanes of each bounce by ray_sort_key before tracing
    # (coherence only: per-ray results do not depend on it).
    sort_rays: bool = True
    sort_segments: int = 1
    bucket_scheduling: bool = False
    bucket_schedule: tuple | None = None
    bucket_check_every: int = 8
    fast_bounce_shading: bool = False
    texture_mips: bool = True
    bruteforce_max_tris: int = 4096
    bvh_max_leaf: int = 15
    bvh_tri_group: int = 8
    bvh_wide: int = 4
    chunk_mode: str = "auto"


# SunLight's fields, which are its trainable leaves (JAX's pytree leaves).
SUN_LEAVES = ("direction", "radiance", "tan_half_angle", "sky_color")


@dataclass
class SunLight:
    """Lighting parameters as tensors on one device.  The four fields are
    the trainable leaves, in SUN_LEAVES order."""

    direction: torch.Tensor  # [3] unit vector toward the sun
    radiance: torch.Tensor  # [3]
    tan_half_angle: torch.Tensor  # scalar, sun disk angular radius
    sky_color: torch.Tensor  # [3] constant sky radiance

    @staticmethod
    def default(device) -> "SunLight":
        d = torch.tensor([0.35, 0.8, 0.45], dtype=torch.float32, device=device)
        d = d / torch.sqrt((d * d).sum())
        return SunLight(
            direction=d,
            radiance=torch.tensor([10.0, 9.5, 9.0], dtype=torch.float32, device=device),
            tan_half_angle=torch.tensor(0.00465, dtype=torch.float32, device=device),
            sky_color=torch.tensor([0.3, 0.45, 0.7], dtype=torch.float32, device=device),
        )

    def leaves(self) -> tuple:
        return tuple(getattr(self, k) for k in SUN_LEAVES)

    def to(self, device) -> "SunLight":
        return SunLight(*(torch.as_tensor(t, dtype=torch.float32).to(device) for t in self.leaves()))
