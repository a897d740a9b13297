"""The projection stage of a render on the card (``csrc/project.cu``): 3D
covariance, EWA projection and SH colour of every gaussian row in one
forward launch, and the gradients of the means, scales, rotations and SH
coefficients in one backward launch.

Replaces no Pallas kernel: trase_tpu leaves its ops/projection.py to XLA's
fusion. The plain version is ``project_plain`` (ops/projection.py:
``compute_cov3d`` and ``project_gaussians``, about 200 elementwise ops and as
many autograd nodes a render), the CPU path and the reference that the
forward equals bit for bit on the card in every output but the colour (the
coefficients summed in another order). ``project`` launches the kernels on
CUDA tensors and takes ``project_plain`` on CPU tensors; neither falls back
to the other. Under autograd the forward saves only its inputs, and the
backward recomputes each row.

Launches are counted in ``cuda_lib.LAYOUT_LAUNCHES`` under
``("project_fwd",)`` and ``("project_bwd",)``.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .projection import (ZNEAR, CameraBuffers, ProjectedGaussians,
                         compute_cov3d, project_gaussians)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int32, ctypes.c_float


class ProjectArgs(ctypes.Structure):
    """csrc/project.cu's ProjectArgs."""

    _fields_ = [(name, _P) for name in (
        "means", "scales", "rots", "opacity", "offset", "dc", "rest",
        "world_view", "full_proj", "campos", "tanfovx", "tanfovy",
        "mean2d", "depth", "conic", "radius", "valid", "extent", "color",
        "g_mean2d", "g_depth", "g_conic", "g_color",
        "d_means", "d_scales", "d_rots", "d_dc", "d_rest")] + [
        (name, _I) for name in (
            "gs_mean2d", "gs_depth", "gs_conic", "gs_color", "n", "n_rest",
            "n_basis", "height", "width")] + [
        ("scale_modifier", _F), ("znear", _F)]


# the C entry points: (arguments, their size in bytes, stream)
SIGNATURES = {"trase_project_fwd": [_P, ctypes.c_int64, _P],
              "trase_project_bwd": [_P, ctypes.c_int64, _P]}


def n_basis(sh_degree: int, n_stored: int) -> int:
    """SH coefficients a render uses: those of the active degree (sh_basis
    stops at 3), or fewer where fewer are stored."""
    return min((min(sh_degree, 3) + 1) ** 2, n_stored)


def project_plain(means3d, scales, rots, opacity, cam: CameraBuffers,
                  image_height: int, image_width: int, *,
                  scaling_modifier: float = 1.0, sh_degree: int = 0,
                  features_dc=None, features_rest=None, colors_precomp=None,
                  mean2d_offset=None) -> ProjectedGaussians:
    """The projection in plain PyTorch: compute_cov3d, project_gaussians
    with the SH coefficients [features_dc | features_rest] or
    `colors_precomp`, and `mean2d_offset` added to the screen means."""
    cov3d = compute_cov3d(scales, rots, scaling_modifier)
    if colors_precomp is not None:
        proj = project_gaussians(means3d, cov3d, opacity, cam, image_height,
                                 image_width, colors_precomp=colors_precomp)
    else:
        proj = project_gaussians(
            means3d, cov3d, opacity, cam, image_height, image_width,
            sh_coeffs=torch.cat([features_dc, features_rest], dim=1),
            sh_degree=sh_degree)
    if mean2d_offset is not None:
        proj = proj._replace(mean2d=proj.mean2d + mean2d_offset)
    return proj


def project(means3d, scales, rots, opacity, cam: CameraBuffers,
            image_height: int, image_width: int, *,
            scaling_modifier: float = 1.0, sh_degree: int = 0,
            features_dc=None, features_rest=None, colors_precomp=None,
            mean2d_offset=None) -> ProjectedGaussians:
    """means3d, scales (activated) (N, 3), rots (N, 4) unit wxyz, opacity
    (N,); the SH coefficients features_dc (N, 1, 3) and features_rest (N,
    R, 3), or colours (N, 3) in `colors_precomp`, returned as the colour;
    `mean2d_offset` (N, 2) or None. The kernels for CUDA tensors (one
    forward launch, and one backward launch when a gradient flows to the
    means, scales, rotations or SH coefficients), project_plain for CPU
    tensors."""
    fn = project_plain if means3d.device.type == "cpu" else project_kernels
    return fn(means3d, scales, rots, opacity, cam, image_height, image_width,
              scaling_modifier=scaling_modifier, sh_degree=sh_degree,
              features_dc=features_dc, features_rest=features_rest,
              colors_precomp=colors_precomp, mean2d_offset=mean2d_offset)


def project_kernels(means3d, scales, rots, opacity, cam: CameraBuffers,
                    image_height: int, image_width: int, *,
                    scaling_modifier: float = 1.0, sh_degree: int = 0,
                    features_dc=None, features_rest=None,
                    colors_precomp=None,
                    mean2d_offset=None) -> ProjectedGaussians:
    """project on the card: the forward kernel, under autograd with the
    backward kernel behind it."""
    n = means3d.shape[0]
    opacity = opacity.reshape(n)
    with_sh = colors_precomp is None
    ins = (means3d, scales, rots, opacity, features_dc if with_sh else None,
           features_rest if with_sh else None, mean2d_offset)
    _check(n, cam.world_view.device, *ins)
    cuda_lib.require_cuda("project_fwd", "project_plain", **cam._asdict())
    dims = (cam, image_height, image_width, float(scaling_modifier),
            n_basis(sh_degree, 1 + features_rest.shape[1]) if with_sh else 0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ins):
        out = _Project.apply(*ins, dims)
    else:
        out = _forward([t if t is None else t.contiguous() for t in ins],
                       dims)
    mean2d, depth, conic, radius, valid, extent = out[:6]
    return ProjectedGaussians(
        mean2d=mean2d, depth=depth, conic=conic, radius=radius,
        color=out[6] if with_sh else colors_precomp, opacity=opacity,
        valid=valid, extent=extent)


def _check(n, cam_device, means3d, scales, rots, opacity, dc, rest,
           offset):
    shapes = {"means3d": (means3d, (n, 3)), "scales": (scales, (n, 3)),
              "rots": (rots, (n, 4)), "opacity": (opacity, (n,)),
              "mean2d_offset": (offset, (n, 2))}
    if dc is not None:
        shapes["features_dc"] = (dc, (n, 1, 3))
        shapes["features_rest"] = (rest, (n, rest.shape[1], 3))
    if cam_device != means3d.device:
        raise ValueError(f"the camera is on {cam_device}, the rows on "
                         f"{means3d.device}")
    for name, (t, shape) in shapes.items():
        if t is None:
            continue
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != means3d.device):
            raise ValueError(f"{name}: the projection kernels take float32 "
                             f"{shape} on {means3d.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if n >= 2 ** 31 or (rest is not None and rest.numel() >= 2 ** 31):
        raise ValueError(f"{n} rows: over int32")


def _library():
    return cuda_lib.library("project", SIGNATURES)


def _args(ins, dims, **tensors) -> ProjectArgs:
    """The kernels' arguments: the inputs, the camera, the sizes and the
    named outputs, cotangents and gradients (a None pointer where absent)."""
    means3d, scales, rots, opacity, dc, rest, offset = ins
    cam, height, width, scale_modifier, nb = dims
    ptrs = dict(means=means3d, scales=scales, rots=rots, opacity=opacity,
                offset=offset, dc=dc, rest=rest,
                world_view=cam.world_view, full_proj=cam.full_proj,
                campos=cam.campos, tanfovx=cam.tanfovx,
                tanfovy=cam.tanfovy, **tensors)
    args = ProjectArgs(**{k: None if t is None else t.data_ptr()
                          for k, t in ptrs.items()})
    args.n, args.n_basis = means3d.shape[0], nb
    args.n_rest = 0 if rest is None else rest.shape[1]
    args.height, args.width = height, width
    args.scale_modifier, args.znear = scale_modifier, ZNEAR
    return args


def _launch(entry: str, args: ProjectArgs, device) -> None:
    cuda_lib.launch(getattr(_library(), f"trase_{entry}"), (entry,), device,
                    ctypes.addressof(args), ctypes.sizeof(args))


def _forward(ins, dims) -> tuple:
    """One forward launch: (mean2d, depth, conic, radius, valid, extent)
    and, with SH coefficients, the colour."""
    means3d, dc = ins[0], ins[4]
    n, dev = means3d.shape[0], means3d.device

    def f(*shape):
        return torch.empty((n, *shape), dtype=torch.float32, device=dev)

    out = dict(mean2d=f(2), depth=f(), conic=f(3), radius=f(),
               valid=torch.empty(n, dtype=torch.bool, device=dev),
               extent=f(2))
    if dc is not None:
        out["color"] = f(3)
    _launch("project_fwd", _args(ins, dims, **out), dev)
    return tuple(out.values())


def _rows(g, width: int):
    """A cotangent and its row stride: rows of consecutive floats are taken
    as they are, anything else copied."""
    if g is None:
        return None, 0
    if g.dtype != torch.float32:
        g = g.float()
    if width > 1 and g.stride(1) != 1:
        g = g.contiguous()
    return g, g.stride(0)


class _Project(torch.autograd.Function):
    """The kernels under autograd: radius, valid and extent carry no
    gradient; the screen means' gradient is the offset's, unchanged. The
    backward kernel runs when the means, scales, rotations or SH
    coefficients need a gradient (not for the offset's alone, as in the
    FEATURE step)."""

    @staticmethod
    def forward(ctx, means3d, scales, rots, opacity, dc, rest, offset, dims):
        ins = [t if t is None else t.contiguous()
               for t in (means3d, scales, rots, opacity, dc, rest, offset)]
        out = _forward(ins, dims)
        ctx.mark_non_differentiable(*out[3:6])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*ins[:6])
        ctx.dims, ctx.has_offset = dims, offset is not None
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_mean2d, g_depth, g_conic, _radius, _valid, _extent,
                 g_color=None):
        g_offset = g_mean2d if ctx.has_offset else None
        if not any(ctx.needs_input_grad[k] for k in (0, 1, 2, 4, 5)):
            # the offset's alone (opacity's flows around the kernels)
            return (None,) * 6 + (g_offset, None)
        ins = list(ctx.saved_tensors) + [None]
        means3d, scales, rots, _, dc, rest, _ = ins
        grads = dict(d_means=torch.empty_like(means3d),
                     d_scales=torch.empty_like(scales),
                     d_rots=torch.empty_like(rots))
        if dc is not None:
            grads.update(d_dc=torch.empty_like(dc),
                         d_rest=torch.empty_like(rest))
        cots, strides = {}, {}
        for name, g, width in (("mean2d", g_mean2d, 2), ("depth", g_depth, 1),
                               ("conic", g_conic, 3), ("color", g_color, 3)):
            cots[f"g_{name}"], strides[f"gs_{name}"] = _rows(g, width)
        args = _args(ins, ctx.dims, **grads, **cots)
        for name, stride in strides.items():
            setattr(args, name, stride)
        _launch("project_bwd", args, means3d.device)
        return (grads["d_means"], grads["d_scales"], grads["d_rots"], None,
                grads.get("d_dc"), grads.get("d_rest"), g_offset, None)
