"""SE(3)/SO(3) exponential map in torch.

Counterpart of trase_tpu/utils/rigid.py (reference utils/rigid_utils.py:
Modern Robotics formulas; exp_se3 consumes a screw axis + theta and
returns a batch of 4x4 homogeneous transforms). Serves the 6-DoF deform
head and ``renderer.apply_deformation``; the logarithm maps belong to
the editing slice.
"""
from __future__ import annotations

import torch


def skew(w: torch.Tensor) -> torch.Tensor:
    """(N,3) -> (N,3,3) cross-product matrices."""
    zeros = torch.zeros_like(w[:, 0])
    return torch.stack(
        [
            zeros, -w[:, 2], w[:, 1],
            w[:, 2], zeros, -w[:, 0],
            -w[:, 1], w[:, 0], zeros,
        ],
        dim=-1,
    ).reshape(-1, 3, 3)


def rp_to_se3(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(N,3,3) rotation + (N,3,1) translation -> (N,4,4)."""
    bottom = R.new_tensor([[[0.0, 0.0, 0.0, 1.0]]]).expand(R.shape[0], 1, 4)
    return torch.cat([torch.cat([R, p], dim=-1), bottom], dim=1)


def exp_so3(w: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula. w: (N,3) unit axes, theta: (N,1)."""
    W = skew(w)
    identity = torch.eye(3, dtype=w.dtype, device=w.device).expand(
        W.shape[0], 3, 3)
    W_sqr = torch.matmul(W, W)
    th = theta[..., None]  # (N,1,1)
    return identity + torch.sin(th) * W + (1.0 - torch.cos(th)) * W_sqr


def exp_se3(S: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Screw-axis exponential. S: (N,6) [w|v], theta: (N,1) -> (N,4,4)."""
    w, v = S[:, :3], S[:, 3:]
    W = skew(w)
    R = exp_so3(w, theta)
    identity = torch.eye(3, dtype=S.dtype, device=S.device).expand(
        W.shape[0], 3, 3)
    W_sqr = torch.matmul(W, W)
    th = theta.reshape(-1, 1, 1)
    G = th * identity + (1.0 - torch.cos(th)) * W + (th - torch.sin(th)) * W_sqr
    p = torch.matmul(G, v[..., None])
    return rp_to_se3(R, p)


def to_homogeneous(v: torch.Tensor) -> torch.Tensor:
    return torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)


def from_homogeneous(v: torch.Tensor) -> torch.Tensor:
    return v[..., :3] / v[..., -1:]
