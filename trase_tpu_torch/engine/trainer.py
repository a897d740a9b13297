"""The training steps of the port: GAUSSIAN, FEATURE and STYLE.

Counterpart of trase_tpu/engine/trainer.py (:63-137, :173-577,
:638-690, :693-781; reference train.py:209-296). GAUSSIAN: render the
view under autograd, loss = (1-λ) L1 + λ (1 - SSIM) (+ λ_reg |d_xyz| once the
deform net is on), Adam on the gaussian fields (rows of dead slots
frozen) and on the deform MLP, and the densification statistics from the
gradient of the screen-space offset. FEATURE: render the 32 features
alone (KNN-smoothed), resize them to the masks' resolution, contrastive
pixel-pair losses against the SAM masks + rfn (1 - |F|)^2, Adam on
``gaussian_features`` only, and the densification statistics while
densification lasts; after it the compositor's backward runs
values-only. STYLE (the style-transfer CLI's step): render the colour,
the NNFM loss of its VGG features against a style image's, Adam on the
SH colours of one object's gaussians. The compositor's gradient runs
through the hand-written CUDA backward (ops/rasterize_cuda.py) on the
card.

The state is a NamedTuple of tensors and the step is functional: it
returns a new state and leaves its input alone. The three steps share
their update tail (``_update``): Adam, the densification statistics and
the NaN guard, which commits the leaves the step wrote only where the
loss and the state's tensors are finite (on a device flag, no host
sync), so a non-finite step is one skipped step. On a card the tail is
two hand-written launches (ops/update_tail.py), elsewhere plain PyTorch
(``_update_plain``, a ``torch.where`` a leaf). The
deform net is a module whose weights live in the state as a list in
flax order (Dense_i kernel in nn.Linear's (out, in) layout, then
its bias); the step runs the module on them with
``torch.func.functional_call``. Its hidden stack runs in bf16, as
trase_tpu's does by default.

The GAUSSIAN and FEATURE steps also serve a world of ranks that each
hold a block of the gaussian rows (parallel/sharded.py): ``Ranks`` names
the render and the few reductions that differ there, and is one device
by default.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from ..losses.contrastive import (
    PixelSample,
    cosine_gram,
    negative_pixel_pair_loss,
    pixel_mask_correspondence_matrix,
    pixel_weights,
    positive_pixel_pair_loss,
    sample_pixels_and_masks,
)
from ..losses.image_losses import l1_loss, ssim
from ..models import gaussians as G
from ..models.deform import DeformNetwork
from ..ops import update_tail as UT
from ..ops.rasterize import RasterConfig
from ..renderer import RenderCamera, render
from ..utils import trace
from ..utils.image import bilinear_resize_mm
from ..utils.schedules import expon_lr_func, linear_noise_func
from .optim import AdamState, adam_init, adam_update, adam_update_list

# the fields the GAUSSIAN phase trains, with their LearningRates name
TRAINED = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
           "rotation")

GAUSSIAN = "GAUSSIAN"
FEATURE = "FEATURE"


class OptState:
    """The reference's OPT_STATE machine (train.py:51-73): starts in
    GAUSSIAN; switch() toggles the phase once more than `max_iterations`
    steps counted in the current block."""

    def __init__(self, max_iterations: int):
        self.state = GAUSSIAN
        self.iterations = 0
        self.max_iterations = max_iterations

    def step(self):
        self.iterations += 1

    def switch(self) -> bool:
        if self.iterations > self.max_iterations:
            self.state = FEATURE if self.state == GAUSSIAN else GAUSSIAN
            self.iterations = 0
            return True
        return False


class TrainState(NamedTuple):
    params: G.GaussianParams
    aux: G.GaussianAux
    opt: G.GaussianOptState
    deform: list  # deform tensors in flax order (see module docstring)
    deform_opt: list  # AdamState per deform tensor


class LearningRates(NamedTuple):
    """Per-field learning rates (python floats), scheduled on the host."""

    xyz: float
    features_dc: float
    features_rest: float
    opacity: float
    scaling: float
    rotation: float
    gaussian_features: float
    deform: float


def make_learning_rate_schedules(opt_args, spatial_lr_scale: float = 5.0):
    """xyz + deform exponential schedules (gaussian_model.py:290-293,
    deform_model.py:45-48); returns iteration -> LearningRates."""
    xyz_sched = expon_lr_func(
        lr_init=opt_args.position_lr_init * spatial_lr_scale,
        lr_final=opt_args.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt_args.position_lr_delay_mult,
        max_steps=opt_args.position_lr_max_steps)
    deform_sched = expon_lr_func(
        lr_init=opt_args.position_lr_init * spatial_lr_scale,
        lr_final=opt_args.position_lr_final,
        lr_delay_mult=opt_args.position_lr_delay_mult,
        max_steps=opt_args.deform_lr_max_steps)

    def at(iteration: int) -> LearningRates:
        return LearningRates(
            xyz=float(xyz_sched(iteration)),
            features_dc=float(opt_args.feature_lr),
            features_rest=float(opt_args.feature_lr / 20.0),
            opacity=float(opt_args.opacity_lr),
            scaling=float(opt_args.scaling_lr),
            rotation=float(opt_args.rotation_lr),
            gaussian_features=float(opt_args.feature_lr),
            deform=float(deform_sched(iteration)),
        )

    return at


def float_tensors(state: TrainState) -> list:
    """Every float tensor of the state (what the NaN guard checks)."""
    out = [x for x in state.params] + [x for x in state.aux
                                       if x.is_floating_point()]
    out += [t for s in state.opt for t in (s.mu, s.nu)]
    out += list(state.deform)
    out += [t for s in state.deform_opt for t in (s.mu, s.nu)]
    return out


def _all_finite(tensors) -> torch.Tensor:
    """0-d bool tensor: every element of every tensor is finite."""
    return torch.stack([torch.isfinite(x).all() for x in tensors]).all()


def _same(x):
    return x


# _update's calls by path: ("fused",) on CUDA tensors, ("plain",) else
UPDATE_TAIL: dict = trace.counter("update_tail")


def _update(state: TrainState, lrs: LearningRates, grads: dict, row_mask,
            loss: torch.Tensor, agree: Callable = _same, *,
            deform_grads=None, densify=None, guard_deform: bool = False):
    """The steps' shared tail -> (new state, finite). Adam on each field
    of `grads` (field name -> gradient) at its rate in `lrs`, the rows
    outside `row_mask` frozen, and, given `deform_grads`, on the deform
    tensors at lrs.deform; the densification statistics of `densify`,
    (g_off, visible, radii, H, W), over the visible alive rows. The NaN
    guard's flag `finite`: the loss and every gaussian table, float aux
    tensor and Adam moment of the new state are finite (with
    `guard_deform`, the deform tensors and their moments too), made the
    same on every rank by `agree`. Each leaf the step wrote is committed
    where it holds (on the device: no host sync); the others are the
    input's own. CUDA tensors take the hand-written tail
    (``_update_fused``), which equals ``_update_plain`` bit for bit;
    counted in the counter ``update_tail`` under ("fused",) or
    ("plain",)."""
    fused = loss.is_cuda
    trace.bump(UPDATE_TAIL, ("fused",) if fused else ("plain",))
    return (_update_fused if fused else _update_plain)(
        state, lrs, grads, row_mask, loss, agree, deform_grads=deform_grads,
        densify=densify, guard_deform=guard_deform)


def _update_plain(state: TrainState, lrs: LearningRates, grads: dict,
                  row_mask, loss: torch.Tensor, agree: Callable = _same, *,
                  deform_grads=None, densify=None,
                  guard_deform: bool = False):
    """_update in plain PyTorch: the CPU path, and the reference that
    the fused tail is held to on the card."""
    p, aux, opt = state.params, state.aux, state.opt
    fields, moments = {}, {}
    for name, g in grads.items():
        fields[name], moments[name] = adam_update(
            getattr(p, name), g, getattr(opt, name), getattr(lrs, name),
            row_mask=row_mask)
    new = state._replace(params=p._replace(**fields),
                         opt=opt._replace(**moments))
    if deform_grads is not None:
        deform, deform_opt = adam_update_list(
            state.deform, deform_grads, state.deform_opt, lrs.deform)
        new = new._replace(deform=deform, deform_opt=deform_opt)
    if densify is not None:
        g_off, visible, radii, h, w = densify
        new = new._replace(aux=G.add_densification_stats(
            aux, g_off, visible & aux.alive, radii, h, w))
    checked = float_tensors(new if guard_deform else new._replace(
        deform=[], deform_opt=[]))
    finite = agree(torch.isfinite(loss.detach()) & _all_finite(checked))

    def keep(n, o):
        if n is o:  # not written
            return o
        if isinstance(n, torch.Tensor):
            return torch.where(finite, n, o)
        parts = [keep(a, b) for a, b in zip(n, o)]
        return parts if isinstance(n, list) else type(n)(*parts)

    return keep(new, state), finite


def tail_segments(state: TrainState, lrs: LearningRates, grads: dict,
                  row_mask, loss: torch.Tensor, *, deform_grads=None,
                  densify=None, guard_deform: bool = False):
    """_update's work as the fused tail's segments -> (Adam segments,
    densify segment or None, the tensors only checked): the fields of
    `grads` (rows outside `row_mask` frozen) and, given `deform_grads`,
    the deform tensors; what the guard checks and the step does not
    write, and the loss."""
    p, aux, opt = state.params, state.aux, state.opt
    masked = row_mask is not None
    adam = [UT.AdamSegment(getattr(p, k), g.contiguous(), *getattr(opt, k),
                           getattr(lrs, k), masked) for k, g in grads.items()]
    if deform_grads is not None:
        adam += [UT.AdamSegment(t, g.contiguous(), *s, lrs.deform, False)
                 for t, g, s in zip(state.deform, deform_grads,
                                    state.deform_opt)]
    stats = None
    if densify is not None:
        g_off, visible, radii, h, w = densify
        stats = UT.DensifySegment(g_off.contiguous(), visible, aux.alive,
                                  radii, aux.xyz_gradient_accum, aux.denom,
                                  aux.max_radii2d, h, w)
    written = {id(x) for a in adam for x in (a.param, a.mu, a.nu)}
    if stats is not None:
        written |= {id(stats.accum), id(stats.denom), id(stats.max_radii2d)}
    guarded = float_tensors(state if guard_deform else state._replace(
        deform=[], deform_opt=[]))
    checks = [x for x in guarded if id(x) not in written] + [loss.detach()]
    return adam, stats, checks


def _update_fused(state: TrainState, lrs: LearningRates, grads: dict,
                  row_mask, loss: torch.Tensor, agree: Callable = _same, *,
                  deform_grads=None, densify=None,
                  guard_deform: bool = False):
    """_update on the card: tail_segments' segments through the fused
    tail (ops/update_tail.py), its flag agreed, then its commit."""
    adam, stats, checks = tail_segments(
        state, lrs, grads, row_mask, loss, deform_grads=deform_grads,
        densify=densify, guard_deform=guard_deform)
    tail = UT.update_tail(adam, stats, checks, row_mask)
    finite = agree(tail.finite)
    UT.update_commit(tail, finite)
    p, opt = state.params, state.opt
    n = len(grads)
    params = [x for x, *_ in tail.adam]
    moments = [AdamState(*s) for _, *s in tail.adam]
    new = state._replace(
        params=p._replace(**dict(zip(grads, params))),
        opt=opt._replace(**dict(zip(grads, moments))))
    if deform_grads is not None:
        new = new._replace(deform=params[n:], deform_opt=moments[n:])
    if stats is not None:
        accum, denom, max_radii2d = tail.densify
        new = new._replace(aux=state.aux._replace(
            xyz_gradient_accum=accum, denom=denom, max_radii2d=max_radii2d))
    return new, finite


def feature_gram(feats_acc: torch.Tensor, sample: PixelSample, hm: int,
                 wm: int) -> torch.Tensor:
    """C_F, the cosine gram of the rendered features at the sampled
    pixels: the (H, W, 1 + F) [acc | feats] image resized by products to
    the masks' resolution (hm, wm) where it differs, then indexed."""
    if feats_acc.shape[:2] != (hm, wm):
        feats_acc = bilinear_resize_mm(feats_acc, hm, wm)
    sampled = feats_acc.reshape(-1, feats_acc.shape[-1])[sample.pixel_idx]
    return cosine_gram(sampled[:, 1:])


class Ranks(NamedTuple):
    """What the GAUSSIAN and FEATURE steps do differently when the
    gaussian rows are split over a world of ranks. The defaults are one
    device holding every row; parallel/sharded.py: world_ranks gives a
    world's."""

    # renderer.render's signature and output keys; radii and
    # visibility_filter cover the rows this rank holds
    render: Callable = render
    # (feats_acc, sample, hm, wm) -> C_F
    feature_gram: Callable = feature_gram
    # the mean of a per-row tensor over every rank's rows
    mean: Callable = torch.mean
    # the replicated deform net's gradients, summed over the ranks
    sum_grads: Callable = _same
    # the NaN guard's flag, made the same on every rank
    agree: Callable = _same


def apply_deform(deform_net: DeformNetwork, deform: list, xyz, fid,
                 ast_noise, use_deform: bool, gaussian_features=None):
    """(d_xyz, d_rotation, d_scaling) for the step, the net run on the
    `deform` tensors with its hidden stack in bf16; zeros when the net is
    not on yet. The MLP's input is xyz.detach() (trase_tpu's
    stop_gradient): xyz gets no gradient through the deformation."""
    if not use_deform:
        return 0.0, 0.0, 0.0
    n = xyz.shape[0]
    dev = xyz.device
    t = (torch.zeros((n, 1), dtype=torch.float32, device=dev)
         + torch.tensor(np.float32(fid), device=dev)
         + torch.tensor(np.float32(ast_noise), device=dev))
    args = (xyz.detach(), t)
    if deform_net.feature_dim:
        args += (gaussian_features.reshape(n, -1).detach(),)
    return functional_call(
        deform_net, dict(zip(deform_net.flax_names(), deform)), args,
        {"dtype": torch.bfloat16})


def gaussian_phase_step(
    state: TrainState,
    camera: RenderCamera,
    gt_image: torch.Tensor,  # (3, H, W)
    fid: float,
    ast_noise: float,
    lrs: LearningRates,
    bg_color: torch.Tensor,
    *,
    deform_net: DeformNetwork,
    sh_degree: int,
    use_deform: bool,
    is_6dof: bool,
    lambda_dssim: float,
    lambda_reg_deform: float,
    raster_cfg: RasterConfig,
    ranks: Ranks = Ranks(),
):
    """One GAUSSIAN-phase step -> (new state, metrics). The metrics are
    0-d device tensors (loss, l1, finite, overflow, overflow_half): the
    step itself never waits for the device. `ranks`: the world the rows
    are split over (one device by default). Its host work is the span
    trase.step, in trase.step.deform, .render, .loss, .backward and .adam
    (the update, the densification statistics and the NaN guard)."""
    with trace.span("trase.step"):
        p, aux = state.params, state.aux
        dev = p.xyz.device
        leaves = {k: getattr(p, k).detach().requires_grad_(True)
                  for k in TRAINED}
        dparams = [t.detach().requires_grad_(use_deform)
                   for t in state.deform]
        off = torch.zeros((p.xyz.shape[0], 2), dtype=torch.float32,
                          device=dev, requires_grad=True)
        params = p._replace(**leaves)
        with trace.span("trase.step.deform"):
            d_xyz, d_rot, d_scale = apply_deform(
                deform_net, dparams, params.xyz, fid, ast_noise, use_deform,
                params.gaussian_features)
        with trace.span("trase.step.render"):
            out = ranks.render(camera, params, aux.alive, bg_color, d_xyz,
                               d_rot, d_scale, is_6dof=is_6dof,
                               sh_degree=sh_degree, mean2d_offset=off,
                               with_features=False, raster_cfg=raster_cfg)
        with trace.span("trase.step.loss"):
            image = out["render"]
            ll1 = l1_loss(image, gt_image)
            loss = (1.0 - lambda_dssim) * ll1 + lambda_dssim * (
                1.0 - ssim(image, gt_image))
            if use_deform and lambda_reg_deform > 0:
                loss = loss + lambda_reg_deform * ranks.mean(torch.abs(d_xyz))
        with trace.span("trase.step.backward"):
            inputs = (list(leaves.values()) + (dparams if use_deform else [])
                      + [off])
            grads = torch.autograd.grad(loss, inputs, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for x, g in zip(inputs, grads)]

        with trace.span("trase.step.adam"), torch.no_grad():
            new_state, finite = _update(
                state, lrs, dict(zip(TRAINED, grads)), aux.alive, loss,
                ranks.agree, guard_deform=True,
                deform_grads=(ranks.sum_grads(grads[len(TRAINED):-1])
                              if use_deform else None),
                densify=(grads[-1], out["visibility_filter"], out["radii"],
                         camera.image_height, camera.image_width))
        metrics = {"loss": loss.detach(), "l1": ll1.detach(),
                   "finite": finite, "overflow": out["overflow"],
                   "overflow_half": out["overflow_half"]}
        return new_state, metrics


def feature_phase_step(
    state: TrainState,
    camera: RenderCamera,
    sam_masks: torch.Tensor,  # (M, Hm, Wm) float32, zero-padded
    mask_valid: torch.Tensor,  # (M,) bool
    fid: float,
    lrs: LearningRates,
    bg_color: torch.Tensor,
    smooth_map,  # ops.knn.SmoothMap of the (C, K) neighbour map, or None
    *,
    deform_net: DeformNetwork,
    sh_degree: int,
    use_deform: bool,
    is_6dof: bool,
    contrastive_mode: str,
    rfn: float,
    positive_th: float,
    negative_th: float,
    num_sampled_pixels: int,
    num_sampled_masks: int,
    raster_cfg: RasterConfig,
    with_densify_stats: bool = True,
    generator: torch.Generator | None = None,
    sample: PixelSample | None = None,
    smooth_perm: torch.Tensor | None = None,
    ranks: Ranks = Ranks(),
):
    """One FEATURE step -> (new state, metrics): contrastive losses on
    the rendered features, Adam on `gaussian_features` alone
    (train.py:244-296; trase_tpu's _feature_phase_body). The pixel /
    mask sample and the smoothing permutation come from `generator`
    unless given (`sample`, `smooth_perm`); `smooth_map` None turns
    smoothing off. with_densify_stats=False (iteration >=
    densify_until_iter) differentiates the features alone, so the
    compositor's backward runs values-only and the densification
    statistics stay as they were. The metrics (loss, finite, rfn,
    pos_sim, neg_sim, overflow, overflow_half) are 0-d device tensors.
    `ranks`: the world the rows are split over (one device by default);
    in a world, `smooth_map` holds this rank's rows of the neighbour map
    and `generator` must draw the same numbers on every rank. Its host
    work is the span trase.step, in trase.step.loss (the pixel sample,
    the gram and the losses), .deform, .render, .backward and .adam."""
    with trace.span("trase.step"):
        p, aux = state.params, state.aux
        dev = p.xyz.device
        with trace.span("trase.step.loss"):
            if sample is None:
                sample = sample_pixels_and_masks(
                    generator, sam_masks, mask_valid, num_sampled_pixels,
                    num_sampled_masks)
            C = pixel_mask_correspondence_matrix(sam_masks, sample)
            weights = pixel_weights(sam_masks, sample)
        with trace.span("trase.step.deform"), torch.no_grad():
            d_xyz, d_rot, d_scale = apply_deform(
                deform_net, state.deform, p.xyz, fid, 0.0, use_deform,
                p.gaussian_features)

        feat = p.gaussian_features.detach().requires_grad_(True)
        off = torch.zeros((p.xyz.shape[0], 2), dtype=torch.float32,
                          device=dev, requires_grad=with_densify_stats)
        with trace.span("trase.step.render"):
            out = ranks.render(
                camera, p._replace(gaussian_features=feat), aux.alive,
                bg_color, d_xyz, d_rot, d_scale, is_6dof=is_6dof,
                sh_degree=sh_degree, mean2d_offset=off, with_features=True,
                with_color=False, grad_values_only=not with_densify_stats,
                norm_gaussian_features=True, smooth_map=smooth_map,
                smooth_perm=smooth_perm, smooth_generator=generator,
                raster_cfg=raster_cfg)
        with trace.span("trase.step.loss"):
            # (H, W, 1 + F) [acc | feats], unsliced: |feats|^2 per pixel
            # is the row's sum of squares less acc^2
            featsA = out["render_gaussian_features_acc_hwc"]
            sq = (torch.sum(featsA * featsA, dim=-1)
                  - featsA[..., 0] * featsA[..., 0])
            rf_norm = torch.sqrt(torch.clamp(sq, min=0.0) + 1e-12).mean()
            rfn_reg = (1.0 - rf_norm) ** 2
            C_F = ranks.feature_gram(featsA, sample, *sam_masks.shape[1:])
            pos = positive_pixel_pair_loss[contrastive_mode](
                C, C_F, sample, positive_th=positive_th, weights=weights)
            neg = negative_pixel_pair_loss[contrastive_mode](
                C, C_F, sample, negative_th=negative_th, weights=weights)
            loss = pos + neg + rfn * rfn_reg

        with trace.span("trase.step.backward"):
            inputs = [feat, off] if with_densify_stats else [feat]
            grads = torch.autograd.grad(loss, inputs)
        with trace.span("trase.step.adam"), torch.no_grad():
            pair = sample.pixel_valid[:, None] & sample.pixel_valid[None, :]
            zero = torch.zeros((), device=dev)

            def mean_sim(sel):
                return torch.where(sel, C_F, zero).sum() / torch.clamp(
                    sel.sum(), min=1)

            pos_sim = mean_sim(pair & (C == 1))
            neg_sim = mean_sim(pair & (C == 0))
            new_state, finite = _update(
                state, lrs, {"gaussian_features": grads[0]}, aux.alive, loss,
                ranks.agree,
                densify=(grads[1], out["visibility_filter"], out["radii"],
                         camera.image_height, camera.image_width)
                if with_densify_stats else None)
        metrics = {"loss": loss.detach(), "finite": finite,
                   "rfn": rf_norm.detach(), "pos_sim": pos_sim,
                   "neg_sim": neg_sim, "overflow": out["overflow"],
                   "overflow_half": out["overflow_half"]}
        return new_state, metrics


def clip_unit(x: torch.Tensor) -> torch.Tensor:
    """x clipped to [0, 1] with jnp.clip's gradient: half the cotangent
    at a bound, where torch.clamp passes all of it (maximum and minimum
    split a tie's gradient evenly, as JAX's do)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def style_phase_step(
    state: TrainState,
    camera: RenderCamera,
    ref_vgg_feats: torch.Tensor,  # (C, N_ref) flattened style features
    style_mask: torch.Tensor,  # (capacity,) bool: gaussians that may change
    fid: float,
    lrs: LearningRates,
    bg_color: torch.Tensor,
    *,
    deform_net: DeformNetwork,
    vgg_ext,
    sh_degree: int,
    use_deform: bool,
    is_6dof: bool,
    fx_key: str,
    raster_cfg: RasterConfig,
):
    """One NNFM style-transfer step -> (new state, metrics)
    (trase_tpu trainer.py:693-781; reference train_style_transfer_nnfm.py
    :180-290): render the colour, VGG features of the render, the NNFM
    loss against the style features; Adam on features_dc and
    features_rest alone, on the rows of `style_mask` that are alive
    (set_background_zero_grad), and the densification statistics. The
    deform net runs detached (bf16 stack) and is not updated. The
    metrics (loss, finite) are 0-d device tensors. Its host work is the
    span trase.step, in trase.step.deform, .render (with the clip),
    .vgg (the extractor's forward on the render), .loss (the NNFM),
    .backward and .adam (the update, the densification statistics and
    the NaN guard)."""
    from ..losses.style import loss_nnfm_style

    with trace.span("trase.step"):
        p, aux = state.params, state.aux
        with trace.span("trase.step.deform"), torch.no_grad():
            d_xyz, d_rot, d_scale = apply_deform(
                deform_net, state.deform, p.xyz, fid, 0.0, use_deform,
                p.gaussian_features)
        f_dc = p.features_dc.detach().requires_grad_(True)
        f_rest = p.features_rest.detach().requires_grad_(True)
        off = torch.zeros((p.xyz.shape[0], 2), dtype=torch.float32,
                          device=p.xyz.device, requires_grad=True)
        with trace.span("trase.step.render"):
            out = render(camera, p._replace(features_dc=f_dc,
                                            features_rest=f_rest),
                         aux.alive, bg_color, d_xyz, d_rot, d_scale,
                         is_6dof=is_6dof, sh_degree=sh_degree,
                         mean2d_offset=off, with_features=False,
                         raster_cfg=raster_cfg)
            image = clip_unit(out["render"])
        with trace.span("trase.step.vgg"):
            # the reference normalizes outside the extractor and inside
            # it: its features are of a twice-normalized image
            # (models/vgg.py normalize)
            feats = vgg_ext(vgg_ext.normalize(image))[fx_key][0]  # (C, h, w)
        with trace.span("trase.step.loss"):
            loss = loss_nnfm_style(feats.reshape(feats.shape[0], -1),
                                   ref_vgg_feats)
        with trace.span("trase.step.backward"):
            g_dc, g_rest, goff = torch.autograd.grad(loss, [f_dc, f_rest,
                                                            off])

        with trace.span("trase.step.adam"), torch.no_grad():
            new_state, finite = _update(
                state, lrs, {"features_dc": g_dc, "features_rest": g_rest},
                aux.alive & style_mask, loss,
                densify=(goff, out["visibility_filter"], out["radii"],
                         camera.image_height, camera.image_width))
        return new_state, {"loss": loss.detach(), "finite": finite}


def densify_step(state: TrainState, scene_extent: float,
                 max_screen_size: float, *, cfg: G.DensifyConfig,
                 max_new: int, generator: torch.Generator | None = None,
                 samples: torch.Tensor | None = None):
    p, aux, opt, stats = G.densify_and_prune(
        state.params, state.aux, state.opt, cfg, scene_extent,
        max_screen_size, max_new, generator=generator, samples=samples)
    return state._replace(params=p, aux=aux, opt=opt), stats


def reset_opacity_step(state: TrainState) -> TrainState:
    p, opt = G.reset_opacity(state.params, state.aux, state.opt)
    return state._replace(params=p, opt=opt)


def init_train_state(params: G.GaussianParams, aux: G.GaussianAux,
                     deform: list) -> TrainState:
    """Fresh Adam state for `params` and the deform tensors (float32
    from the first step on)."""
    deform = [t.detach().clone() for t in deform]
    return TrainState(params=params, aux=aux, opt=G.init_opt_state(params),
                      deform=deform,
                      deform_opt=[adam_init(t) for t in deform])


def deform_tensors(deform_net: DeformNetwork) -> list:
    """The net's current weights in the state's flax order."""
    named = dict(deform_net.named_parameters())
    return [named[n].detach().clone() for n in deform_net.flax_names()]


def make_ast_noise_fn(num_frames: int, is_blender: bool):
    """AST time-jitter amplitude (train.py:154,198): scalar
    N(0,1) * (1/num_frames) * linear_decay(iteration)."""
    smooth_term = linear_noise_func(lr_init=0.1, lr_final=1e-15,
                                    lr_delay_mult=0.01, max_steps=20000)
    time_interval = 1.0 / max(num_frames, 1)

    def fn(np_rng: np.random.Generator, iteration: int) -> float:
        if is_blender:
            return 0.0
        return float(np_rng.standard_normal() * time_interval
                     * smooth_term(iteration))

    return fn


# ------------------------------------------------- state across packages


def _fields(obj) -> dict:
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def _state_tree(state: TrainState, leaf) -> dict:
    def adam(s, transpose=False):
        f = (lambda x: leaf(x).T) if transpose else leaf
        return {"mu": f(s.mu), "nu": f(s.nu), "step": leaf(s.step)}

    dvars, dopt = {}, {}
    for i in range(len(state.deform) // 2):
        w, b = state.deform[2 * i], state.deform[2 * i + 1]
        sw, sb = state.deform_opt[2 * i], state.deform_opt[2 * i + 1]
        dvars[f"Dense_{i}"] = {"kernel": leaf(w).T, "bias": leaf(b)}
        dopt[f"Dense_{i}"] = {"kernel": adam(sw, True), "bias": adam(sb)}
    return {
        "params": {k: leaf(v) for k, v in state.params._asdict().items()},
        "aux": {k: leaf(v) for k, v in state.aux._asdict().items()},
        "opt": {k: adam(v) for k, v in state.opt._asdict().items()},
        "deform_vars": {"params": dvars},
        "deform_opt": {"params": dopt},
    }


def train_state_to_numpy(state: TrainState) -> dict:
    """The state as numpy in trase_tpu's TrainState layout: params, aux,
    opt ({field: {mu, nu, step}}), deform_vars ({"params": {"Dense_i":
    {"kernel" (in, out), "bias"}}}) and deform_opt (the same tree with
    {mu, nu, step} leaves)."""
    return _state_tree(state, lambda x: x.detach().cpu().numpy())


def tree_schema(tree) -> list:
    """Keyed schema of a nested-dict tree: (path, dtype name) per leaf,
    the path in jax's keystr notation (['params']['xyz']). Shapes are
    left out: capacity may grow between a save and a load."""
    out = []

    def walk(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}[{k!r}]", v)
        else:
            out.append((prefix, str(x.dtype).replace("torch.", "")
                        if hasattr(x, "dtype") else type(x).__name__))

    walk("", tree)
    return out


def state_schema(state: TrainState) -> list:
    """tree_schema of train_state_to_numpy(state), without the copy."""
    return tree_schema(_state_tree(state, lambda x: x))


def train_state_from_numpy(tree, device="cuda") -> TrainState:
    """A TrainState on `device` from trase_tpu's TrainState as numpy
    (jax.tree_util.tree_map(np.asarray, state)) or from
    train_state_to_numpy's dict."""
    tree = _fields(tree)
    params, aux = G.params_from_numpy(tree["params"], tree["aux"], device)

    def t(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dtype, device=params.xyz.device)

    def adam(s, transpose=False):
        s = _fields(s)
        f = (lambda x: t(np.asarray(x).T)) if transpose else t
        return AdamState(mu=f(s["mu"]), nu=f(s["nu"]),
                         step=t(s["step"], torch.int32))

    opt = G.GaussianOptState(**{k: adam(v)
                                for k, v in _fields(tree["opt"]).items()})
    dvars = _fields(tree["deform_vars"])["params"]
    dopt = _fields(tree["deform_opt"])["params"]
    deform, deform_opt = [], []
    for i in range(len(dvars)):
        layer, lopt = dvars[f"Dense_{i}"], dopt[f"Dense_{i}"]
        deform += [t(np.asarray(layer["kernel"]).T), t(layer["bias"])]
        deform_opt += [adam(lopt["kernel"], True), adam(lopt["bias"])]
    return TrainState(params, aux, opt, deform, deform_opt)
