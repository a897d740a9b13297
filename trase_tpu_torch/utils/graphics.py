"""Camera/projection math (host-side numpy).

Behavioral contract: utils/graphics_utils.py in the reference
(getWorld2View2, getProjectionMatrix with the 3DGS z-sign convention,
fov<->focal). Matrices follow the reference's row-vector convention:
callers multiply ``p_hom @ M`` with M already transposed, exactly as the
reference stores ``world_view_transform = getWorld2View2(...).T``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


class BasicPointCloud(NamedTuple):
    points: np.ndarray  # (N, 3)
    colors: np.ndarray  # (N, 3) in [0,1]
    normals: np.ndarray  # (N, 3)


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate=np.array([0.0, 0.0, 0.0]), scale: float = 1.0
                  ) -> np.ndarray:
    """4x4 world->view matrix. R is the cam-to-world rotation (COLMAP
    convention: stored transposed), t the world->cam translation."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0

    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    return np.float32(np.linalg.inv(C2W))


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float
                      ) -> np.ndarray:
    """Perspective projection with z mapped to [0, 1] * w (3DGS convention:
    P[2,2] = zf/(zf-zn), P[2,3] = -zf*zn/(zf-zn), P[3,2] = 1)."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)

    top = tan_half_fovy * znear
    bottom = -top
    right = tan_half_fovx * znear
    left = -right

    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov_to_focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal_to_fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))
