"""Renderer façade: deformation, projection, compositing of one view.

Counterpart of trase_tpu/renderer.py:64-235 (reference
gaussian_renderer/__init__.py:37-155): applies the deformation deltas
(additive, or 6-DoF homogeneous transforms), evaluates SH in the
projection stage, normalizes the 32-dim segmentation features, masks
gaussians by zeroing their opacity, and returns the reference's output
keys. The device is the tensors' own: CUDA tensors composite through the
CUDA kernels, CPU tensors through their plain versions. Under autograd the
render is differentiable in the gaussian parameters, the deformation
deltas and ``mean2d_offset`` (the screen-space gradient carrier that
densification reads).

The FEATURE step's options: KNN feature smoothing (``smooth_map``), the
features-only path (``with_color=False``: no SH, no render / depth, and
the unsliced [acc | feats] image) and values-only gradients
(``grad_values_only``). ``render_composite`` (trase_tpu/renderer.py:238,
reference gaussian_renderer/__init__.py:251-331) composites a background
set with a deformed, edited dynamic set in one rasterization.
``render``'s stages are the spans ``trase.render.project``, ``.bin``
and ``.composite`` (utils/trace.py).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import resolve_device
from .models import gaussians as G
from .ops import project_cuda
from .ops.knn import smooth_features
from .ops.projection import CameraBuffers
from .ops.rasterize import RasterConfig
from .ops.rasterize_cuda import (composite_image, composite_inputs,
                                 image_outputs, rasterize_tiled)
from .utils import graphics, trace
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
    wv = graphics.world_to_view(R, T, trans, scale).T
    return camera_from_world_view(wv, fovx, fovy, image_height, image_width,
                                  znear, zfar, device)


def camera_from_world_view(wv: np.ndarray, fovx: float, fovy: float,
                           image_height: int, image_width: int,
                           znear: float = 0.01, zfar: float = 100.0,
                           device="cuda") -> RenderCamera:
    """RenderCamera from a (4, 4) float32 world-to-view matrix in the
    row-vector convention: the full projection and camera centre are
    computed in numpy, then the buffers go to `device`."""
    dev = resolve_device(device)
    proj = graphics.projection_matrix(znear, zfar, fovx, fovy).T
    full = wv @ proj
    campos = np.linalg.inv(wv)[3, :3]

    def t(x):  # row-major on the device, as the projection kernels read it
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=dev)

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


def project_view(camera: RenderCamera, params: G.GaussianParams,
                 aux_alive: torch.Tensor, d_xyz=0.0, d_rotation=0.0,
                 d_scaling=0.0, *, is_6dof: bool = False,
                 scaling_modifier: float = 1.0, sh_degree: int = 3,
                 override_color: torch.Tensor | None = None,
                 mask: torch.Tensor | None = None, mean2d_offset=None,
                 with_color: bool = True):
    """The projection stage of `render`: deformation, opacity masked by
    `aux_alive` (and `mask`), covariance, EWA projection with SH colour
    (a zero placeholder without colour), and `mean2d_offset` added to the
    projected means: the kernels of ops/project_cuda.py on CUDA tensors,
    their plain version on CPU tensors."""
    H, W = camera.image_height, camera.image_width
    means3d, scales, rots = apply_deformation(
        params, d_xyz, d_rotation, d_scaling, is_6dof)
    zero = torch.zeros((), dtype=means3d.dtype, device=means3d.device)
    opacity = torch.where(aux_alive, G.get_opacity(params)[:, 0], zero)
    if mask is not None:
        opacity = torch.where(mask, opacity, zero)

    colors = override_color
    if not with_color:
        # colour is never composited: a zero placeholder skips SH
        colors = torch.zeros((means3d.shape[0], 3), dtype=means3d.dtype,
                             device=means3d.device)
    return project_cuda.project(
        means3d, scales, rots, opacity, camera.buffers, H, W,
        scaling_modifier=scaling_modifier, sh_degree=sh_degree,
        features_dc=params.features_dc, features_rest=params.features_rest,
        colors_precomp=colors, mean2d_offset=mean2d_offset)


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
    smooth_perm: torch.Tensor | None = None,
    smooth_generator: torch.Generator | None = None,
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
    signal (added to the projected means before binning); `smooth_map`:
    the ops.knn.SmoothMap of (C, K) neighbour indices (the map with its
    transpose, which the gradient walks) to enable feature smoothing,
    over the neighbour slots `smooth_perm` or, without it, a permutation drawn
    from `smooth_generator` (see ops.knn.smooth_features).

    `with_color=False` (requires with_features) composites only the
    features and alpha and skips SH: no render / depth keys, and
    render_gaussian_features_acc_hwc, the unsliced (H, W, 1 + 32)
    [acc | feats] image. `grad_values_only=True` promises that only the
    gradients of the composited values are consumed (the FEATURE step
    after densification): geometry, opacity and mean2d_offset then get
    exact zeros from the compositor.
    """
    if not with_color and not with_features:
        raise ValueError("with_color=False requires with_features=True")
    H, W = camera.image_height, camera.image_width
    with trace.span("trase.render.project"):
        proj = project_view(camera, params, aux_alive, d_xyz, d_rotation,
                            d_scaling, is_6dof=is_6dof,
                            scaling_modifier=scaling_modifier,
                            sh_degree=sh_degree,
                            override_color=override_color, mask=mask,
                            mean2d_offset=mean2d_offset,
                            with_color=with_color)
        extra = None
        if with_features:
            feats = params.gaussian_features
            if smooth_map is not None:
                feats = smooth_features(feats, smooth_map, perm=smooth_perm,
                                        generator=smooth_generator)
            if norm_gaussian_features:
                # safe norm: dead slots hold all-zero features
                feats = feats / torch.sqrt(
                    torch.sum(feats * feats, dim=-1, keepdim=True) + 1e-12)
            extra = feats

    # rasterize_tiled, split into its binning and its compositing
    with trace.span("trase.render.bin"):
        ci = composite_inputs(proj, extra, H, W, raster_cfg, with_color)
    with trace.span("trase.render.composite"):
        hwc = composite_image(ci, H, W, grad_values_only)
        out = image_outputs(hwc, ci.overflow, bg_color, with_color,
                            extra is not None)
    return render_outputs(out, proj.radius, with_color, with_features)


def render_outputs(out: dict, radius: torch.Tensor, with_color: bool,
                   with_features: bool) -> dict:
    """render's output dict from rasterize_tiled's and the projected
    radii."""
    result = {
        "visibility_filter": radius > 0,
        "radii": radius,
        "alpha": out["alpha"],
        "overflow": out["overflow"],
        "overflow_half": out["overflow_half"],
    }
    if with_color:
        result["render"] = out["render"]
        result["depth"] = out["depth"]
    if with_features:
        result["render_gaussian_features"] = out["feats"]
        result["render_gaussian_features_hwc"] = out["feats_hwc"]
    if not with_color:
        result["render_gaussian_features_acc_hwc"] = out["feats_acc_hwc"]
    return result


def render_composite(
    camera: RenderCamera,
    bg_params: G.GaussianParams,
    bg_alive: torch.Tensor,
    dyn_params: G.GaussianParams,
    dyn_alive: torch.Tensor,
    d_xyz, d_rotation, d_scaling,
    bg_color: torch.Tensor,
    scales_bias: float = 1.0,
    motion_bias=(0.0, 0.0, 0.0),
    rotation_bias=(0.0, 0.0, 0.0),
    *,
    sh_degree: int = 3,
    mask: torch.Tensor | None = None,
    raster_cfg: RasterConfig = RasterConfig(),
):
    """Composite a static background gaussian set with a deformed, edited
    dynamic set in a single rasterization: the dynamic set is deformed,
    its dead (and `mask`-ed) gaussians get zero opacity, it is rescaled /
    rotated (z-y-x euler, radians) / translated by the edit biases and
    concatenated after the background set; one projection, one
    composite (rgb + depth). The two capacities may be any sizes.
    Returns {"render": (3, H, W)}."""
    from .editing import transform_gaussians

    H, W = camera.image_height, camera.image_width
    means_d, scales_d, rots_d = apply_deformation(
        dyn_params, d_xyz, d_rotation, d_scaling)
    zero = torch.zeros((), dtype=means_d.dtype, device=means_d.device)
    opa_d = torch.where(dyn_alive, G.get_opacity(dyn_params)[:, 0], zero)
    if mask is not None:
        opa_d = torch.where(mask, opa_d, zero)
    means_d, rots_d, scales_d = transform_gaussians(
        means_d, rots_d, scales_d, scales_bias, motion_bias, rotation_bias)

    opa_b = torch.where(bg_alive, G.get_opacity(bg_params)[:, 0], zero)
    means = torch.cat([bg_params.xyz, means_d], dim=0)
    scales = torch.cat([G.get_scaling(bg_params), scales_d], dim=0)
    rots = torch.cat([G.get_rotation(bg_params), rots_d], dim=0)
    opacity = torch.cat([opa_b, opa_d], dim=0)
    dc = torch.cat([bg_params.features_dc, dyn_params.features_dc], dim=0)
    rest = torch.cat([bg_params.features_rest, dyn_params.features_rest],
                     dim=0)

    proj = project_cuda.project(means, scales, rots, opacity, camera.buffers,
                                H, W, sh_degree=sh_degree, features_dc=dc,
                                features_rest=rest)
    out = rasterize_tiled(proj, None, bg_color, H, W, raster_cfg)
    return {"render": out["render"]}
