"""Interactive orbit camera (host-side numpy) and its render camera.

Counterpart of trase_tpu/cam_utils.py (reference cam_utils.py, the SC-GS
OrbitCamera: orbit / scale / pan with the same sensitivities, OpenGL
pose, the same initial rotation through scipy's Rotation), plus the GUI's
MiniCam rectification (gui.py:120-148) mapped onto the port's
RenderCamera. The pose math stays in numpy (the inverse in float64) so
that the camera buffers equal trase_tpu's bit for bit before they are
uploaded to the device.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as R


def _normalize(v, eps=1e-20):
    return v / np.sqrt(np.maximum((v * v).sum(-1, keepdims=True), eps))


def look_at(campos, target, opengl=True):
    """(3,) eye + (3,) target -> (3,3) rotation (reference look_at)."""
    if not opengl:
        forward = _normalize(target - campos)
        up = np.array([0, 1, 0], dtype=np.float32)
        right = _normalize(np.cross(forward, up))
        up = _normalize(np.cross(right, forward))
    else:
        forward = _normalize(campos - target)
        up = np.array([0, 1, 0], dtype=np.float32)
        right = _normalize(np.cross(up, forward))
        up = _normalize(np.cross(forward, right))
    return np.stack([right, up, forward], axis=1)


def orbit_camera(elevation, azimuth, radius=1, is_degree=True, target=None,
                 opengl=True):
    """Elevation/azimuth -> (4,4) c2w pose (reference orbit_camera)."""
    if is_degree:
        elevation = np.deg2rad(elevation)
        azimuth = np.deg2rad(azimuth)
    x = radius * np.cos(elevation) * np.sin(azimuth)
    y = -radius * np.sin(elevation)
    z = radius * np.cos(elevation) * np.cos(azimuth)
    if target is None:
        target = np.zeros(3, dtype=np.float32)
    campos = np.array([x, y, z]) + target
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = look_at(campos, target, opengl)
    T[:3, 3] = campos
    return T


class OrbitCamera:
    """Orbit/zoom/pan camera state; pose in OpenGL c2w convention."""

    def __init__(self, W, H, r=2, fovy=60, near=0.01, far=100):
        self.W = W
        self.H = H
        self.radius = r
        self.fovy = np.deg2rad(fovy)
        self.near = near
        self.far = far
        self.center = np.array([0, 0, 0], dtype=np.float32)
        self.rot = R.from_matrix(np.array([[1.0, 0.0, 0.0],
                                           [0.0, 0.0, -1.0],
                                           [0.0, 1.0, 0.0]]))

    @property
    def fovx(self):
        return 2 * np.arctan(np.tan(self.fovy / 2) * self.W / self.H)

    @property
    def pose(self):
        """c2w (4,4)."""
        res = np.eye(4, dtype=np.float32)
        res[2, 3] = self.radius
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = self.rot.as_matrix()
        res = rot @ res
        res[:3, 3] -= self.center
        return res

    @property
    def campos(self):
        return self.pose[:3, 3]

    @property
    def view(self):
        return np.linalg.inv(self.pose)

    def orbit(self, dx, dy):
        side = self.rot.as_matrix()[:3, 0]
        up = self.rot.as_matrix()[:3, 1]
        rotvec_x = up * np.radians(-0.05 * dx)
        rotvec_y = side * np.radians(-0.05 * dy)
        self.rot = R.from_rotvec(rotvec_x) * R.from_rotvec(rotvec_y) * self.rot

    def scale(self, delta):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx, dy, dz=0, sensitivity=0.0001):
        self.center += sensitivity * self.rot.as_matrix()[:3, :3] @ np.array(
            [-dx, -dy, dz])


def pose_to_render_camera(c2w: np.ndarray, W: int, H: int, fovx: float,
                          fovy: float, znear: float = 0.01,
                          zfar: float = 100.0, device="cuda"):
    """NeRF-convention c2w pose -> the port's RenderCamera on `device`,
    with the GUI MiniCam rectification (gui.py:133-139: flip rows 1:3 of
    the w2c rotation and negate the translation)."""
    from .renderer import camera_from_world_view

    w2c = np.linalg.inv(np.asarray(c2w, np.float64))
    w2c[1:3, :3] *= -1
    w2c[:3, 3] *= -1
    wv = w2c.T.astype(np.float32)  # row-vector convention
    return camera_from_world_view(wv, fovx, fovy, H, W, znear, zfar, device)
