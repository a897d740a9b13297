"""Gaussian field state: fixed-capacity tensors with an alive-mask.

Counterpart of trase_tpu/models/gaussians.py. ``GaussianParams``,
``GaussianAux`` and ``GaussianOptState`` match the JAX containers field
by field, so state crosses between the packages through
``params_from_numpy`` (and engine/trainer.py's state converters). Dead
slots are parked with opacity logit -15 (sigmoid ~ 3e-7, below the
1/255 compositing cutoff) and tiny scales; the renderer also zeroes
their opacity. Densification (clone / split / prune), the opacity reset
and capacity growth are masked row writes over the fixed capacity, as
in trase_tpu; they return new tensors and leave their inputs alone.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..engine.optim import AdamState, adam_init
from ..utils.general import inverse_sigmoid_np
from ..utils.quaternion import build_rotation
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


class GaussianOptState(NamedTuple):
    """Adam state per parameter field."""

    xyz: AdamState
    features_dc: AdamState
    features_rest: AdamState
    scaling: AdamState
    rotation: AdamState
    opacity: AdamState
    gaussian_features: AdamState


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


def init_opt_state(p: GaussianParams) -> GaussianOptState:
    return GaussianOptState(**{k: adam_init(getattr(p, k))
                               for k in GaussianOptState._fields})


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


# ------------------------------------------------------- densification


class DensifyConfig(NamedTuple):
    grad_threshold: float = 0.0002
    percent_dense: float = 0.01
    min_opacity: float = 0.005
    split_n: int = 2  # reference N=2


def add_densification_stats(aux: GaussianAux, viewspace_grad: torch.Tensor,
                            visibility: torch.Tensor, radii: torch.Tensor,
                            image_height: int,
                            image_width: int) -> GaussianAux:
    """Accumulate screen-gradient norms for the clone / split criterion.

    The pixel-space mean2d gradient is scaled to NDC units (x W/2, H/2),
    the units the reference's CUDA rasterizer reports and its default
    threshold 2e-4 is tuned for; the norm is a hypot, so a finite huge
    gradient cannot overflow into the accumulator."""
    scale = torch.tensor([image_width / 2.0, image_height / 2.0],
                         dtype=viewspace_grad.dtype,
                         device=viewspace_grad.device)
    g = viewspace_grad * scale
    norm = torch.hypot(g[..., 0], g[..., 1])
    return aux._replace(
        xyz_gradient_accum=torch.where(
            visibility, aux.xyz_gradient_accum + norm,
            aux.xyz_gradient_accum),
        denom=torch.where(visibility, aux.denom + 1.0, aux.denom),
        max_radii2d=torch.where(
            visibility, torch.maximum(aux.max_radii2d, radii),
            aux.max_radii2d),
    )


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Indices with mask True first, each group in index order (the
    stable argsort of ~mask, as trase_tpu's jnp.argsort)."""
    return torch.argsort((~mask).to(torch.int8), stable=True)


def _rows(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (ndim - 1))


def _write_rows(dst_tree, src_tree, src_idx, dst_idx, write_mask):
    """dst[dst_idx[i]] = src[src_idx[i]] where write_mask[i] (dst_idx
    distinct); a new tree, fields of any NamedTuple of tensors."""
    out = {}
    for name, d in dst_tree._asdict().items():
        s = getattr(src_tree, name)
        vals = torch.where(_rows(write_mask, d.ndim), s[src_idx], d[dst_idx])
        d = d.clone()
        d[dst_idx] = vals
        out[name] = d
    return type(dst_tree)(**out)


def _reset_opt_rows(opt: GaussianOptState, mask: torch.Tensor):
    """Zero the Adam moments of the rows where mask is True (the step
    counts are per tensor and stay)."""
    def z(x):
        return torch.where(_rows(mask, x.ndim), torch.zeros_like(x), x)

    return GaussianOptState(**{
        k: AdamState(mu=z(s.mu), nu=z(s.nu), step=s.step)
        for k, s in opt._asdict().items()})


def split_sample_shape(capacity: int, max_new: int,
                       cfg: DensifyConfig = DensifyConfig()):
    """Shape of the standard-normal samples densify_and_prune draws."""
    return (cfg.split_n, min(max_new, capacity), 3)


def densify_and_prune(params: GaussianParams, aux: GaussianAux,
                      opt: GaussianOptState, cfg: DensifyConfig,
                      scene_extent: float, max_screen_size: float,
                      max_new: int, generator: torch.Generator | None = None,
                      samples: torch.Tensor | None = None):
    """One densification round (reference scene/gaussian_model.py:
    563-635): clone small high-gradient gaussians, split large ones
    (child positions drawn from the parent gaussian), then prune
    transparent / oversized ones. At most `max_new` clones and `max_new`
    splits per call; excess candidates are dropped and counted.

    The split draws standard normals of split_sample_shape() from
    `generator`, or takes them as `samples` (so a test can inject the
    numbers trase_tpu drew). Returns (params, aux, opt, stats dict of
    0-d tensors).
    """
    c = params.xyz.shape[0]
    dev = params.xyz.device
    max_new = min(max_new, c)
    if samples is None:
        shape = split_sample_shape(c, max_new, cfg)
        gen_dev = generator.device if generator is not None else "cpu"
        samples = torch.randn(shape, generator=generator,
                              device=gen_dev).to(dev)
    grads = aux.xyz_gradient_accum / torch.clamp(aux.denom, min=1e-12)
    grads = torch.where(torch.isnan(grads), torch.zeros_like(grads), grads)
    max_scale = get_scaling(params).max(dim=1).values
    high_grad = (grads >= cfg.grad_threshold) & aux.alive
    small = max_scale <= cfg.percent_dense * scene_extent
    clone_sel = high_grad & small
    split_sel = high_grad & ~small
    n_clone = clone_sel.sum()
    n_split = split_sel.sum()
    free_count = (~aux.alive).sum()
    ranks = torch.arange(max_new, device=dev)

    # clone: every selection rank gets a distinct free slot; entries that
    # are not selected (or find no free slot) write back the old row
    sel_idx = _first_true(clone_sel)[:max_new]
    sel_ok = clone_sel[sel_idx] & (ranks < free_count)
    dst = _first_true(~aux.alive)[ranks]
    new_params = _write_rows(params, params, sel_idx, dst, sel_ok)
    alive2 = aux.alive.clone()
    alive2[dst] = torch.where(sel_ok, True, aux.alive[dst])
    written = torch.zeros(c, dtype=torch.bool, device=dev)
    written[dst] = sel_ok
    new_opt = _reset_opt_rows(opt, written)

    # split: child 0 takes the parent's slot, children 1.. free slots
    split_idx = _first_true(split_sel)[:max_new]
    n_free2 = (~alive2).sum()
    split_ok = split_sel[split_idx] & (
        (ranks + 1) * (cfg.split_n - 1) <= n_free2)
    parent = GaussianParams(*[x[split_idx] for x in new_params])
    R = build_rotation(parent.rotation)
    stds = torch.exp(parent.scaling)
    new_scale_raw = torch.log(stds / (0.8 * cfg.split_n))
    children = []
    for ci in range(cfg.split_n):
        child_xyz = torch.einsum("nij,nj->ni", R, samples[ci] * stds) \
            + parent.xyz
        children.append(parent._replace(xyz=child_xyz,
                                        scaling=new_scale_raw))
    new_params = _write_rows(new_params, children[0],
                             torch.arange(max_new, device=dev), split_idx,
                             split_ok)
    split_written = torch.zeros(c, dtype=torch.bool, device=dev)
    split_written[split_idx] = split_ok
    new_opt = _reset_opt_rows(new_opt, split_written)
    for ci in range(1, cfg.split_n):
        rank = ranks * (cfg.split_n - 1) + (ci - 1)
        dst_c = _first_true(~alive2)[torch.clamp(rank, max=c - 1)]
        new_params = _write_rows(new_params, children[ci],
                                 torch.arange(max_new, device=dev), dst_c,
                                 split_ok)
        alive2 = alive2.clone()
        alive2[dst_c] = torch.where(split_ok, True, alive2[dst_c])
        w = torch.zeros(c, dtype=torch.bool, device=dev)
        w[dst_c] = split_ok
        new_opt = _reset_opt_rows(new_opt, w)
        split_written = split_written | w

    # prune
    opacity = torch.sigmoid(new_params.opacity[:, 0])
    prune = opacity < cfg.min_opacity
    if max_screen_size > 0:  # size pruning only after an opacity reset
        big_vs = aux.max_radii2d > max_screen_size
        big_ws = torch.exp(new_params.scaling).max(dim=1).values \
            > 0.1 * scene_extent
        prune = prune | big_vs | big_ws
    prune = prune & ~written & ~split_written
    alive3 = alive2 & ~prune
    new_params = new_params._replace(opacity=torch.where(
        alive3[:, None], new_params.opacity,
        torch.full_like(new_params.opacity, DEAD_OPACITY_LOGIT)))
    zeros = torch.zeros_like(aux.max_radii2d)
    new_aux = GaussianAux(alive=alive3, max_radii2d=zeros,
                          xyz_gradient_accum=zeros.clone(),
                          denom=zeros.clone())
    stats = {
        "n_clone": torch.clamp(n_clone, max=max_new),
        "n_split": torch.clamp(n_split, max=max_new),
        "n_pruned": (prune & alive2).sum(),
        "n_alive": alive3.sum(),
        "dropped": torch.clamp(n_clone - max_new, min=0)
        + torch.clamp(n_split - max_new, min=0),
    }
    return new_params, new_aux, new_opt, stats


def reset_opacity(params: GaussianParams, aux: GaussianAux,
                  opt: GaussianOptState):
    """Clamp opacity to <= 0.01 and zero its Adam moments
    (scene/gaussian_model.py:378-381)."""
    target = torch.clamp(get_opacity(params), max=0.01)
    logit = torch.log(target / (1 - target))
    new_opacity = torch.where(aux.alive[:, None], logit, params.opacity)
    new_opt = opt._replace(opacity=AdamState(
        mu=torch.zeros_like(opt.opacity.mu),
        nu=torch.zeros_like(opt.opacity.nu), step=opt.opacity.step))
    return params._replace(opacity=new_opacity), new_opt


def grow_capacity(params: GaussianParams, aux: GaussianAux,
                  opt: GaussianOptState, new_capacity: int):
    """Grow every per-slot tensor to `new_capacity` rows; new slots are
    dead (the parked values of empty_params) with zero Adam moments."""
    c = params.xyz.shape[0]
    if new_capacity <= c:
        raise ValueError(f"new capacity {new_capacity} <= {c}")
    pad = new_capacity - c
    dev = params.xyz.device
    fresh = empty_params(pad, 0, dev)

    def grow(x, fill):
        return torch.cat([x, fill.to(x.dtype).expand(
            (pad,) + tuple(x.shape[1:]))], dim=0)

    def zero(x):
        return torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]),
                                         dtype=x.dtype, device=dev)], dim=0)

    new_params = GaussianParams(
        xyz=zero(params.xyz), features_dc=zero(params.features_dc),
        features_rest=zero(params.features_rest),
        scaling=grow(params.scaling, fresh.scaling[:1]),
        rotation=grow(params.rotation, fresh.rotation[:1]),
        opacity=grow(params.opacity, fresh.opacity[:1]),
        gaussian_features=zero(params.gaussian_features),
        cluster_id=grow(params.cluster_id, fresh.cluster_id[:1]))
    new_aux = GaussianAux(*[zero(x) for x in aux])
    new_opt = GaussianOptState(*[
        AdamState(mu=zero(s.mu), nu=zero(s.nu), step=s.step) for s in opt])
    return new_params, new_aux, new_opt
