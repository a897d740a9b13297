"""Gaussian-set editing ops: rescale / rotate / translate / remove.

Counterpart of trase_tpu/editing.py (reference
gaussian_renderer/__init__.py:158-249): rescale, rotate_by_euler_angles
in z-y-x order, rotate_by_matrix through a quaternion product, translation
and their composition, plus the GUI's removal and selection masks
(render with ``mask=~segmented``, gui.py:414-417). The rotation matrices
are built on the host in numpy, as trase_tpu builds them; the gaussians
stay on their own device.
"""
from __future__ import annotations

import numpy as np
import torch

from .utils.quaternion import normalize_quat, quaternion_multiply, rotmat_to_quat


def _rx(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float32)


def _ry(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)


def _rz(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)


def rescale(means3d, scales, scale_factor: float):
    return means3d * scale_factor, scales * scale_factor


def rotate_by_matrix(means3d: torch.Tensor, rotations: torch.Tensor,
                     rotation_matrix: np.ndarray):
    """Rotate positions and quaternions by a world-space rotation matrix.

    The reference's quat_multiply(q0=rotations, q1=q_rot)
    (gaussian_renderer/__init__.py:210-235) is the Hamilton product
    q_rot * rotation, in that order."""
    Rm = torch.as_tensor(np.asarray(rotation_matrix, np.float32),
                         device=means3d.device)
    means3d = means3d @ Rm.T
    q = torch.as_tensor(
        rotmat_to_quat(np.asarray(rotation_matrix)).astype(np.float32),
        device=rotations.device)
    rotations = quaternion_multiply(q.expand(rotations.shape), rotations)
    return means3d, normalize_quat(rotations)


def rotate_by_euler_angles(means3d, rotations, rotation_angles):
    """z-y-x order, radians; all-zero angles return the inputs as they are."""
    x, y, z = rotation_angles
    if x == 0.0 and y == 0.0 and z == 0.0:
        return means3d, rotations
    Rm = _rx(x) @ _ry(y) @ _rz(z)
    return rotate_by_matrix(means3d, rotations, Rm)


def translation(means3d: torch.Tensor, offsets) -> torch.Tensor:
    return means3d + torch.as_tensor(np.asarray(offsets, np.float32),
                                     device=means3d.device)


def transform_gaussians(means3d, rotations, scales, scale_factor,
                        offsets, rotation_angles):
    """rescale -> rotate (zyx euler) -> translate, like the reference's
    `transform` (gaussian_renderer/__init__.py:243-249)."""
    means3d, scales = rescale(means3d, scales, scale_factor)
    means3d, rotations = rotate_by_euler_angles(means3d, rotations,
                                                rotation_angles)
    means3d = translation(means3d, offsets)
    return means3d, rotations, scales


def selection_mask(cluster_ids: torch.Tensor, select_ids) -> torch.Tensor:
    """True for the gaussians whose cluster id is in select_ids."""
    ids = cluster_ids.reshape(-1)
    seg = torch.zeros_like(ids, dtype=torch.bool)
    for sid in select_ids:
        seg = seg | (ids == sid)
    return seg


def removal_mask(cluster_ids: torch.Tensor, remove_ids) -> torch.Tensor:
    """Keep-mask that drops gaussians whose cluster id is in remove_ids
    (GUI removal: render(mask=~segmented), gui.py:414-417)."""
    return ~selection_mask(cluster_ids, remove_ids)
