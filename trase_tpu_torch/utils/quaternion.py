"""Quaternion -> rotation matrix in torch.

Counterpart of ``build_rotation`` in trase_tpu/utils/quaternion.py
(reference utils/general_utils.py:108-129). Quaternions are (w, x, y, z).
The densification split rotates its samples with it; the editing
helpers (quaternion products, matrix -> quaternion) belong to the
editing slice.
"""
from __future__ import annotations

import torch


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
