"""Pinhole camera (host-side numpy), as in `nebulae_tpu/core/camera.py`."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from nebulae_tpu_torch.core.math import look_at, perspective


@dataclass
class Camera:
    eye: np.ndarray  # [3]
    target: np.ndarray  # [3]
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32))
    fov_y_deg: float = 60.0
    near: float = 0.01
    far: float = 1000.0

    def basis(self):
        """(right, up, forward) world-space unit vectors, float32."""
        eye = np.asarray(self.eye, np.float64)
        fwd = np.asarray(self.target, np.float64) - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, np.asarray(self.up, np.float64))
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        return right.astype(np.float32), up.astype(np.float32), fwd.astype(np.float32)

    def view_matrix(self) -> np.ndarray:
        return look_at(np.asarray(self.eye), np.asarray(self.target), np.asarray(self.up))

    def proj_matrix(self, width: int, height: int) -> np.ndarray:
        return perspective(np.deg2rad(self.fov_y_deg), width / height, self.near, self.far)
