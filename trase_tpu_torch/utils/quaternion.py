"""Quaternion helpers in torch (rotation matrices, products, matrix ->
quaternion).

Counterpart of trase_tpu/utils/quaternion.py (reference
utils/general_utils.py:108-129 and gaussian_renderer/__init__.py:26-35,
158-249). Quaternions are (w, x, y, z). The densification split rotates
its samples with ``build_rotation``; the editing ops (editing.py) use
``normalize_quat``, ``quaternion_multiply`` and ``rotmat_to_quat``, the
last on the host in numpy, as trase_tpu runs it.
"""
from __future__ import annotations

import numpy as np
import torch


def normalize_quat(q: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + eps)


def build_rotation(r: torch.Tensor) -> torch.Tensor:
    """(N,4) wxyz quaternions (unnormalized) -> (N,3,3) rotation matrices."""
    q = r / torch.linalg.norm(r, dim=-1, keepdim=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(-1, 3, 3)


def quaternion_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions, broadcasting over leading dims."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> wxyz quaternion (numpy, host side): the
    eigenvector of the largest eigenvalue of the symmetric K matrix,
    sign chosen so that w >= 0."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = np.asarray(R).flatten()
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec = -qvec
    return qvec
