"""Per-Gaussian projection stage of the rasterizer (plain torch).

Counterpart of trase_tpu/ops/projection.py:61,121 — the EWA-splatting
preprocessing contract of the reference's CUDA rasterizer: world->view
transform, frustum cull, 3D covariance from scale/rotation, perspective
Jacobian to 2D covariance with the +0.3 pixel low-pass, conic, screen
radius, exact-support extent and SH->RGB. The scalar-expanded formulas
and their evaluation order follow the JAX version, so both packages
round alike.

Scalar-by-tensor divisions are written with torch.div: `c / tensor` in
torch multiplies by the reciprocal, which rounds differently.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.sh import C0, C1, C2, C3

# Minimum contributing alpha: the extent cull below and every
# compositor's alpha threshold share it (reference forward.cu's 1/255).
ALPHA_EPS = 1.0 / 255.0

# The near plane: rows at view depth <= ZNEAR are culled. project_gaussians
# and the projection kernels (ops/project_cuda.py) both read it.
ZNEAR = 0.2


class CameraBuffers(NamedTuple):
    """Device-side camera parameters (0-d / small float32 tensors)."""

    world_view: torch.Tensor  # (4,4), row-vector convention (pre-transposed)
    full_proj: torch.Tensor  # (4,4), row-vector convention
    campos: torch.Tensor  # (3,)
    tanfovx: torch.Tensor  # 0-d
    tanfovy: torch.Tensor  # 0-d


class ProjectedGaussians(NamedTuple):
    mean2d: torch.Tensor  # (N,2) pixel coords
    depth: torch.Tensor  # (N,) view-space z
    conic: torch.Tensor  # (N,3) inverse 2D covariance (a,b,c)
    radius: torch.Tensor  # (N,) float screen radius, 0 => culled
    color: torch.Tensor  # (N,3) RGB from SH (or precomputed)
    opacity: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,) bool visibility
    # (N,2) half-extents (px) of the exact contributing support's AABB
    # (see trase_tpu ProjectedGaussians.extent); None => use `radius`.
    extent: torch.Tensor | None = None


def compute_cov3d(scales: torch.Tensor, rotations: torch.Tensor,
                  scale_modifier: float = 1.0) -> torch.Tensor:
    """(N,3) activated scales + (N,4) wxyz quats -> (N,6) packed symmetric
    covariance [xx, xy, xz, yy, yz, zz] = R diag(s^2) R^T."""
    q = rotations / torch.linalg.norm(rotations, dim=-1, keepdim=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    s0 = (scale_modifier * scales[:, 0]) ** 2
    s1 = (scale_modifier * scales[:, 1]) ** 2
    s2 = (scale_modifier * scales[:, 2]) ** 2
    xx = s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02
    xy = s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12
    xz = s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22
    yy = s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12
    yz = s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22
    zz = s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22
    return torch.stack([xx, xy, xz, yy, yz, zz], dim=1)


def sh_basis(deg: int, x, y, z) -> torch.Tensor:
    """Real SH basis values b_k(dir), k < (deg+1)^2: ((deg+1)^2, N)."""
    basis = [torch.full_like(x, C0)]
    if deg > 0:
        basis += [-C1 * y, C1 * z, -C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            basis += [
                C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
                C2[3] * xz, C2[4] * (xx - yy),
            ]
            if deg > 2:
                basis += [
                    C3[0] * y * (3 * xx - yy),
                    C3[1] * xy * z,
                    C3[2] * y * (4 * zz - xx - yy),
                    C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                    C3[4] * x * (4 * zz - xx - yy),
                    C3[5] * z * (xx - yy),
                    C3[6] * x * (xx - 3 * yy),
                ]
    return torch.stack(basis, dim=0)


def _cdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """c / t rounded as a true division (see the module docstring)."""
    return torch.div(torch.full_like(t, c), t)


def project_gaussians(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacities: torch.Tensor,
    cam: CameraBuffers,
    image_height: int,
    image_width: int,
    sh_coeffs: torch.Tensor | None = None,
    sh_degree: int = 0,
    colors_precomp: torch.Tensor | None = None,
    znear: float = ZNEAR,
) -> ProjectedGaussians:
    """EWA projection of N gaussians to screen space.

    means3d: (N,3); cov3d: packed (N,6) [xx,xy,xz,yy,yz,zz] or (N,3,3);
    opacities: (N,) or (N,1); sh_coeffs: (N, (deg+1)^2, 3) or None when
    colors_precomp is given.
    """
    N = means3d.shape[0]
    if cov3d.ndim == 3:
        cov3d = torch.stack(
            [cov3d[:, 0, 0], cov3d[:, 0, 1], cov3d[:, 0, 2],
             cov3d[:, 1, 1], cov3d[:, 1, 2], cov3d[:, 2, 2]], dim=1)
    opacities = opacities.reshape(N)

    mx, my_, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    WV = cam.world_view  # (4,4) row-vector convention: p' = p @ WV

    tx = mx * WV[0, 0] + my_ * WV[1, 0] + mz * WV[2, 0] + WV[3, 0]
    ty = mx * WV[0, 1] + my_ * WV[1, 1] + mz * WV[2, 1] + WV[3, 1]
    tz_raw = mx * WV[0, 2] + my_ * WV[1, 2] + mz * WV[2, 2] + WV[3, 2]
    # culled gaussians (tz <= znear) divide by a sanitized tz instead
    behind = tz_raw <= znear
    tz = torch.where(behind, torch.ones_like(tz_raw), tz_raw)

    FP = cam.full_proj
    hx = mx * FP[0, 0] + my_ * FP[1, 0] + mz * FP[2, 0] + FP[3, 0]
    hy = mx * FP[0, 1] + my_ * FP[1, 1] + mz * FP[2, 1] + FP[3, 1]
    hw = mx * FP[0, 3] + my_ * FP[1, 3] + mz * FP[2, 3] + FP[3, 3]
    p_w = 1.0 / (hw + 1e-7)
    # CUDA rasterizer: pix = ((ndc + 1) * S - 1) * 0.5
    px = ((hx * p_w + 1.0) * image_width - 1.0) * 0.5
    py = ((hy * p_w + 1.0) * image_height - 1.0) * 0.5

    limx = 1.3 * cam.tanfovx
    limy = 1.3 * cam.tanfovy
    txtz = torch.clamp(tx / tz, -limx, limx) * tz
    tytz = torch.clamp(ty / tz, -limy, limy) * tz
    focal_x = _cdiv(float(image_width), 2.0 * cam.tanfovx)
    focal_y = _cdiv(float(image_height), 2.0 * cam.tanfovy)

    inv_tz = 1.0 / tz
    j00 = focal_x * inv_tz
    j02 = -(focal_x * txtz) * inv_tz * inv_tz
    j11 = focal_y * inv_tz
    j12 = -(focal_y * tytz) * inv_tz * inv_tz
    t00 = j00 * WV[0, 0] + j02 * WV[0, 2]
    t01 = j00 * WV[1, 0] + j02 * WV[1, 2]
    t02 = j00 * WV[2, 0] + j02 * WV[2, 2]
    t10 = j11 * WV[0, 1] + j12 * WV[0, 2]
    t11 = j11 * WV[1, 1] + j12 * WV[1, 2]
    t12 = j11 * WV[2, 1] + j12 * WV[2, 2]

    cxx, cxy, cxz = cov3d[:, 0], cov3d[:, 1], cov3d[:, 2]
    cyy, cyz, czz = cov3d[:, 3], cov3d[:, 4], cov3d[:, 5]
    s0t0 = cxx * t00 + cxy * t01 + cxz * t02
    s1t0 = cxy * t00 + cyy * t01 + cyz * t02
    s2t0 = cxz * t00 + cyz * t01 + czz * t02
    s0t1 = cxx * t10 + cxy * t11 + cxz * t12
    s1t1 = cxy * t10 + cyy * t11 + cyz * t12
    s2t1 = cxz * t10 + cyz * t11 + czz * t12
    a = t00 * s0t0 + t01 * s1t0 + t02 * s2t0 + 0.3
    b = t00 * s0t1 + t01 * s1t1 + t02 * s2t1
    c = t10 * s0t1 + t11 * s1t1 + t12 * s2t1 + 0.3

    det = a * c - b * b
    det_inv = 1.0 / (det + 1e-12)
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], dim=1)

    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lambda1))

    valid = ~behind & (det > 0.0) & (opacities > 0.0)
    in_image = (
        (px + radius > 0)
        & (px - radius < image_width)
        & (py + radius > 0)
        & (py - radius < image_height)
    )
    valid = valid & in_image
    radius = torch.where(valid, radius, torch.zeros_like(radius))

    t_sup = 2.0 * (torch.log(torch.clamp(opacities, min=1e-38))
                   - float(np.log(ALPHA_EPS)))
    t_sup = torch.clamp(t_sup, min=0.0)
    pad = float(1.0 + 4.0 * np.float32(np.finfo(np.float32).eps))
    ex = torch.minimum(torch.sqrt(t_sup * torch.clamp(a, min=0.0)) * pad,
                       radius)
    ey = torch.minimum(torch.sqrt(t_sup * torch.clamp(c, min=0.0)) * pad,
                       radius)
    extent = torch.where(valid[:, None], torch.stack([ex, ey], dim=1),
                         torch.zeros_like(means3d[:, :2]))

    if colors_precomp is not None:
        color = colors_precomp
    else:
        dx = mx - cam.campos[0]
        dy = my_ - cam.campos[1]
        dz = mz - cam.campos[2]
        inv_n = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz + 1e-18)
        bas = sh_basis(sh_degree, dx * inv_n, dy * inv_n, dz * inv_n)
        # a checkpoint may store fewer coefficients than the active
        # degree implies; absent coefficients contribute zero
        k_used = min(bas.shape[0], sh_coeffs.shape[1])
        sh_t = sh_coeffs[:, :k_used, :].permute(1, 2, 0)  # (K, 3, N)
        chans = [torch.sum(bas[:k_used] * sh_t[:, ch, :], dim=0)
                 for ch in range(3)]
        color = torch.clamp(torch.stack(chans, dim=1) + 0.5, min=0.0)

    return ProjectedGaussians(
        mean2d=torch.stack([px, py], dim=1),
        depth=tz,
        conic=conic,
        radius=radius,
        color=color,
        opacity=opacities,
        valid=valid,
        extent=extent,
    )
