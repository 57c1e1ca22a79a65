"""Cameras (host-side numpy), as in `nebulae_tpu/core/camera.py`: the
pinhole `Camera` the renderer takes, and `OrbitCamera`, a spherical orbit
around a target (distance, pitch and yaw in degrees) that the app turns
each frame."""

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


@dataclass
class OrbitCamera:
    """Spherical orbit around `target`: yaw 90 looks down -X."""

    distance: float = 3.0
    pitch_deg: float = 0.0
    yaw_deg: float = 90.0
    target: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    fov_y_deg: float = 60.0

    def eye(self) -> np.ndarray:
        pitch = np.deg2rad(self.pitch_deg)
        yaw = np.deg2rad(self.yaw_deg)
        d = self.distance * np.cos(pitch)
        return (
            np.asarray(self.target)
            + np.array(
                [d * np.cos(yaw), self.distance * np.sin(pitch), d * np.sin(yaw)], np.float32
            )
        ).astype(np.float32)

    def camera(self) -> Camera:
        return Camera(eye=self.eye(), target=np.asarray(self.target, np.float32), fov_y_deg=self.fov_y_deg)

    def rotate(self, dyaw_deg: float, dpitch_deg: float):
        self.yaw_deg += dyaw_deg
        self.pitch_deg = float(np.clip(self.pitch_deg + dpitch_deg, -89.0, 89.0))

    def zoom(self, factor: float):
        self.distance = float(np.clip(self.distance * factor, 1e-3, 1e6))
