"""Camera pose utilities (numpy).

Twin of focnerf_tpu/core/camera.py: ``nerf_matrix_to_ngp``
(nerf/provider.py:24-32), ``rand_poses`` (nerf/provider.py:62-87, with
cameras looking AT the origin along +z, the ngp/OpenCV convention) and the
viewer's ``OrbitCamera`` (nerf/gui.py:10-53).
"""

from __future__ import annotations

import numpy as np


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float = 0.33, offset=(0, 0, 0)) -> np.ndarray:
    """OpenGL-style NeRF c2w pose -> instant-ngp axes: rows permuted (y,z,x),
    y/z axes negated, translation scaled and offset."""
    pose = np.asarray(pose, dtype=np.float32)
    return np.array(
        [
            [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
            [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
            [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-10)


def rand_poses(
    rng: np.random.Generator,
    size: int,
    radius: float = 1.0,
    theta_range=(np.pi / 3, 2 * np.pi / 3),
    phi_range=(0.0, 2 * np.pi),
) -> np.ndarray:
    """Random camera poses on a sphere, looking at the origin -> [size, 4, 4]."""
    thetas = rng.uniform(theta_range[0], theta_range[1], size)
    phis = rng.uniform(phi_range[0], phi_range[1], size)
    centers = np.stack(
        [
            radius * np.sin(thetas) * np.sin(phis),
            radius * np.cos(thetas),
            radius * np.sin(thetas) * np.cos(phis),
        ],
        axis=-1,
    )
    forward = -_normalize(centers)
    up_w = np.broadcast_to(np.array([0.0, 1.0, 0.0]), forward.shape)
    right = _normalize(np.cross(forward, up_w))
    down = np.cross(forward, right)  # +y is image-down in OpenCV convention
    poses = np.tile(np.eye(4, dtype=np.float32), (size, 1, 1))
    poses[:, :3, :3] = np.stack([right, down, forward], axis=-1)
    poses[:, :3, 3] = centers
    return poses.astype(np.float32)


class OrbitCamera:
    """Minimal orbit camera for interactive/offline viewers (nerf/gui.py:10-53)."""

    def __init__(self, W: int, H: int, r: float = 2.0, fovy: float = 60.0):
        self.W = W
        self.H = H
        self.radius = r
        self.fovy = fovy
        self.center = np.zeros(3, dtype=np.float32)
        self.rot = np.eye(3, dtype=np.float32)  # a 3x3 matrix (the reference keeps a scipy Rotation)
        self.up = np.array([0.0, 1.0, 0.0], dtype=np.float32)

    @property
    def pose(self) -> np.ndarray:
        res = np.eye(4, dtype=np.float32)
        res[2, 3] -= self.radius
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = self.rot
        res = rot @ res
        res[:3, 3] -= self.center
        return res

    @property
    def intrinsics(self) -> np.ndarray:
        focal = self.H / (2.0 * np.tan(np.radians(self.fovy) / 2.0))
        return np.array([focal, focal, self.W / 2.0, self.H / 2.0], dtype=np.float32)

    def _rotmat(self, axis: np.ndarray, angle: float) -> np.ndarray:
        """Rodrigues' rotation by ``angle`` about ``axis``."""
        axis = _normalize(axis)
        K = np.array(
            [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]],
            dtype=np.float32,
        )
        return np.eye(3, dtype=np.float32) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)

    def orbit(self, dx: float, dy: float):
        side = self.rot[:3, 0]
        rotvec_x = self._rotmat(self.up, -0.1 * np.radians(dx))
        rotvec_y = self._rotmat(side, -0.1 * np.radians(dy))
        self.rot = rotvec_x @ rotvec_y @ self.rot

    def scale(self, delta: float):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx: float, dy: float, dz: float = 0.0):
        self.center += 0.0005 * self.rot @ np.array([dx, dy, dz], dtype=np.float32)
