"""Gaussian field state: fixed-capacity tensors with an alive-mask.

Counterpart of trase_tpu/models/gaussians.py:32-186. ``GaussianParams``
and ``GaussianAux`` match the JAX containers field by field, so state
crosses between the packages through ``params_from_numpy``. Dead slots
are parked with opacity logit -15 (sigmoid ~ 3e-7, below the 1/255
compositing cutoff) and tiny scales; the renderer also zeroes their
opacity. Densify / prune belong to the training slice.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..utils.general import inverse_sigmoid_np
from ..utils.sh import rgb_to_sh

FEATURE_DIM = 32
DEAD_OPACITY_LOGIT = -15.0


class GaussianParams(NamedTuple):
    """Raw (pre-activation) learnable parameters; leading dim = capacity."""

    xyz: torch.Tensor  # (C, 3)
    features_dc: torch.Tensor  # (C, 1, 3) SH DC band
    features_rest: torch.Tensor  # (C, R, 3), R = (deg+1)^2 - 1
    scaling: torch.Tensor  # (C, 3) log-scales
    rotation: torch.Tensor  # (C, 4) unnormalized wxyz quats
    opacity: torch.Tensor  # (C, 1) logits
    gaussian_features: torch.Tensor  # (C, 32) segmentation features
    cluster_id: torch.Tensor  # (C, 1) float cluster ids (finetuning mode)


class GaussianAux(NamedTuple):
    """Non-learnable per-slot state."""

    alive: torch.Tensor  # (C,) bool
    max_radii2d: torch.Tensor  # (C,)
    xyz_gradient_accum: torch.Tensor  # (C,)
    denom: torch.Tensor  # (C,)


# ------------------------------------------------------------ activations


def get_scaling(p: GaussianParams) -> torch.Tensor:
    return torch.exp(p.scaling)


def get_rotation(p: GaussianParams) -> torch.Tensor:
    return p.rotation / (
        torch.linalg.norm(p.rotation, dim=-1, keepdim=True) + 1e-12
    )


def get_opacity(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.opacity)


def get_features(p: GaussianParams) -> torch.Tensor:
    """(C, K, 3) full SH stack, DC first."""
    return torch.cat([p.features_dc, p.features_rest], dim=1)


# ---------------------------------------------------------------- init


def empty_params(capacity: int, sh_degree: int,
                 device="cuda") -> GaussianParams:
    dev = resolve_device(device)
    r = (sh_degree + 1) ** 2 - 1

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    rotation = full((capacity, 4), 0.0)
    rotation[:, 0] = 1.0
    return GaussianParams(
        xyz=full((capacity, 3), 0.0),
        features_dc=full((capacity, 1, 3), 0.0),
        features_rest=full((capacity, r, 3), 0.0),
        scaling=full((capacity, 3), -10.0),
        rotation=rotation,
        opacity=full((capacity, 1), DEAD_OPACITY_LOGIT),
        gaussian_features=full((capacity, FEATURE_DIM), 0.0),
        cluster_id=full((capacity, 1), -1.0),
    )


def empty_aux(capacity: int, device="cuda") -> GaussianAux:
    dev = resolve_device(device)
    zeros = torch.zeros(capacity, dtype=torch.float32, device=dev)
    return GaussianAux(
        alive=torch.zeros(capacity, dtype=torch.bool, device=dev),
        max_radii2d=zeros,
        xyz_gradient_accum=zeros.clone(),
        denom=zeros.clone(),
    )


def default_capacity(n: int) -> int:
    """Power-of-two capacity with room to double (as trase_tpu)."""
    return max(int(2 ** np.ceil(np.log2(max(n * 2, 1024)))), 1024)


def from_point_cloud(
    points: np.ndarray,
    colors: np.ndarray,
    sh_degree: int,
    capacity: int | None = None,
    dist2: np.ndarray | None = None,
    seed: int = 0,
    device="cuda",
) -> tuple[GaussianParams, GaussianAux]:
    """Initialise from a point cloud, mirroring create_from_pcd
    (scene/gaussian_model.py:223-251): SH DC from RGB, log-scales from
    sqrt(mean 3-NN squared distance), identity rotations, opacity 0.1,
    uniform-random 32-dim features mapped through the SH affine. The
    features come from numpy's generator at `seed`, as in trase_tpu, so
    both packages initialise identically."""
    dev = resolve_device(device)
    n = points.shape[0]
    if capacity is None:
        capacity = default_capacity(n)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} points")
    if dist2 is None:
        from ..ops.knn import mean_dist3_sq

        dist2 = mean_dist3_sq(torch.as_tensor(
            np.asarray(points, np.float32), device=dev)).cpu().numpy()
    dist2 = np.clip(dist2, 1e-7, None)
    scales = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1)

    rng = np.random.default_rng(seed)
    feats32 = rgb_to_sh(rng.uniform(size=(n, FEATURE_DIM)).astype(np.float32))

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    p = empty_params(capacity, sh_degree, dev)
    a = empty_aux(capacity, dev)
    p.xyz[:n] = t(points)
    p.features_dc[:n] = t(rgb_to_sh(np.asarray(colors, np.float32)))[:, None]
    p.scaling[:n] = t(scales)
    p.opacity[:n] = float(inverse_sigmoid_np(0.1))
    p.gaussian_features[:n] = t(feats32)
    a.alive[:n] = True
    return p, a


def params_from_numpy(params_np, aux_np,
                      device="cuda") -> tuple[GaussianParams, GaussianAux]:
    """Carry trase_tpu's GaussianParams / GaussianAux, given as numpy
    arrays (NamedTuples or dicts keyed by field name), into the port's
    containers on `device`. float fields become float32, `alive` bool."""
    dev = resolve_device(device)

    def fields(obj):
        return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)

    pf, af = fields(params_np), fields(aux_np)
    params = GaussianParams(**{
        k: torch.tensor(np.asarray(pf[k], np.float32), device=dev)
        for k in GaussianParams._fields})
    aux = GaussianAux(**{
        k: torch.tensor(np.asarray(af[k], bool if k == "alive"
                                   else np.float32), device=dev)
        for k in GaussianAux._fields})
    return params, aux
