"""Renderer façade: deformation, projection, compositing of one view.

Counterpart of trase_tpu/renderer.py:64-235 (reference
gaussian_renderer/__init__.py:37-155): applies the deformation deltas
(additive, or 6-DoF homogeneous transforms), evaluates SH in the
projection stage, normalizes the 32-dim segmentation features, masks
gaussians by zeroing their opacity, and returns the reference's output
keys. The device is the tensors' own: CUDA tensors composite through the
CUDA kernel, CPU tensors through its plain version. Under autograd the
render is differentiable in the gaussian parameters, the deformation
deltas and ``mean2d_offset`` (the screen-space gradient carrier that
densification reads).

FEATURE-slice options (feature smoothing, the features-only path,
values-only gradients) and object composition raise NotImplementedError.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import resolve_device
from .models import gaussians as G
from .ops.projection import CameraBuffers, compute_cov3d, project_gaussians
from .ops.rasterize import RasterConfig
from .ops.rasterize_cuda import rasterize_tiled
from .utils import graphics
from .utils.rigid import from_homogeneous, to_homogeneous


class RenderCamera(NamedTuple):
    """Camera buffers on a device plus the image size (python ints)."""

    buffers: CameraBuffers
    image_height: int
    image_width: int


def make_render_camera(R: np.ndarray, T: np.ndarray, fovx: float,
                       fovy: float, image_height: int, image_width: int,
                       znear: float = 0.01, zfar: float = 100.0,
                       trans=np.array([0.0, 0.0, 0.0]), scale: float = 1.0,
                       device="cuda") -> RenderCamera:
    dev = resolve_device(device)
    wv = graphics.world_to_view(R, T, trans, scale).T
    proj = graphics.projection_matrix(znear, zfar, fovx, fovy).T
    full = wv @ proj
    campos = np.linalg.inv(wv)[3, :3]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    buffers = CameraBuffers(
        world_view=t(wv), full_proj=t(full), campos=t(campos),
        tanfovx=t(np.tan(fovx / 2)), tanfovy=t(np.tan(fovy / 2)),
    )
    return RenderCamera(buffers=buffers, image_height=image_height,
                        image_width=image_width)


def apply_deformation(params: G.GaussianParams, d_xyz, d_rotation, d_scaling,
                      is_6dof: bool = False):
    """Deformed (means3D, scales, rotations) with activations applied:
    deltas are added to the ACTIVATED values, scales = exp(raw) + d and
    rot = normalize(normalize(raw_rot) + d). In 6-DoF mode d_xyz is a
    batch of homogeneous transforms applied to the canonical means."""
    if is_6dof and getattr(d_xyz, "ndim", 0) == 3:
        means3d = from_homogeneous(
            torch.einsum("nij,nj->ni", d_xyz, to_homogeneous(params.xyz)))
    else:
        means3d = params.xyz + d_xyz
    scales = G.get_scaling(params) + d_scaling
    rots = G.get_rotation(params) + d_rotation
    rots = rots / (torch.linalg.norm(rots, dim=-1, keepdim=True) + 1e-12)
    return means3d, scales, rots


def render(
    camera: RenderCamera,
    params: G.GaussianParams,
    aux_alive: torch.Tensor,
    bg_color: torch.Tensor,
    d_xyz=0.0,
    d_rotation=0.0,
    d_scaling=0.0,
    *,
    is_6dof: bool = False,
    scaling_modifier: float = 1.0,
    sh_degree: int = 3,
    override_color: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
    norm_gaussian_features: bool = True,
    smooth_map=None,
    mean2d_offset=None,
    with_features: bool = True,
    with_color: bool = True,
    grad_values_only: bool = False,
    raster_cfg: RasterConfig = RasterConfig(),
):
    """Render one view. Returns the reference's output dict:
    render (3,H,W), depth (1,H,W), alpha (1,H,W), visibility_filter,
    radii, overflow, overflow_half and, with_features,
    render_gaussian_features (32,H,W) + its (H,W,32) view.

    `aux_alive`: (C,) bool alive-mask; `mask`: optional (C,) bool
    keep-mask (False = removed, reference `render(mask=...)`);
    `mean2d_offset`: (C, 2) zeros whose gradient is the densification
    signal (added to the projected means before binning).
    """
    if smooth_map is not None:
        raise NotImplementedError("feature smoothing belongs to the "
                                  "FEATURE slice of the port")
    if not with_color:
        raise NotImplementedError("with_color=False belongs to the "
                                  "FEATURE slice of the port")
    if grad_values_only:
        raise NotImplementedError("grad_values_only belongs to the "
                                  "FEATURE slice of the port")
    H, W = camera.image_height, camera.image_width

    means3d, scales, rots = apply_deformation(
        params, d_xyz, d_rotation, d_scaling, is_6dof)
    zero = torch.zeros((), dtype=means3d.dtype, device=means3d.device)
    opacity = torch.where(aux_alive, G.get_opacity(params)[:, 0], zero)
    if mask is not None:
        opacity = torch.where(mask, opacity, zero)

    cov3d = compute_cov3d(scales, rots, scaling_modifier)
    if override_color is not None:
        proj = project_gaussians(means3d, cov3d, opacity, camera.buffers,
                                 H, W, colors_precomp=override_color)
    else:
        proj = project_gaussians(means3d, cov3d, opacity, camera.buffers,
                                 H, W, sh_coeffs=G.get_features(params),
                                 sh_degree=sh_degree)
    if mean2d_offset is not None:
        proj = proj._replace(mean2d=proj.mean2d + mean2d_offset)

    extra = None
    if with_features:
        feats = params.gaussian_features
        if norm_gaussian_features:
            # safe norm: dead slots hold all-zero features
            feats = feats / torch.sqrt(
                torch.sum(feats * feats, dim=-1, keepdim=True) + 1e-12)
        extra = feats

    out = rasterize_tiled(proj, extra, bg_color, H, W, raster_cfg)
    result = {
        "visibility_filter": proj.radius > 0,
        "radii": proj.radius,
        "alpha": out["alpha"],
        "overflow": out["overflow"],
        "overflow_half": out["overflow_half"],
        "render": out["render"],
        "depth": out["depth"],
    }
    if with_features:
        result["render_gaussian_features"] = out["feats"]
        result["render_gaussian_features_hwc"] = out["feats_hwc"]
    return result
