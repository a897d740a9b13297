"""Multi-device training: gaussian-parallel projection, tile-row-parallel
compositing.

Counterpart of trase_tpu/parallel/sharded.py (:55-796). The gaussian rows
are split in blocks over the world's ranks (rank r holds rows
[r C/n, (r+1) C/n) of the global slot arrays, after ``interleave_rows``);
the deform net is replicated. Each rank deforms and projects its rows and
all-gathers the small projected representation, bins the whole image
replicated (so every rank sorts the pairs identically), composites its
slab of tile rows with the compositor's slab mode
(``ops/rasterize_cuda.py: composite_slab``), and all-gathers the slabs
into the image. The loss is computed on that image, identically on every
rank. The backward runs the compositor kernels over the rank's slab only;
the collectives' backwards (parallel/world.py) sum the ranks' partial
gradients of the gathered rows, so every rank gets its rows' true
single-device gradient, and the deform net's gradient is all-reduced.
The steps are engine/trainer.py's gaussian_phase_step and
feature_phase_step, given the world's render and reductions
(``world_ranks``).

trase_tpu's shard_map differs there: its all-gather of the slabs
transposes into a psum_scatter, which multiplies every gradient by the
mesh size. Adam does not see the factor, the densification statistics
do (ROADMAP.md, Queue 3). The port's statistics are the single device's.

Densify runs per rank on its own rows into its own free slots (the
counterpart of fold_in(rng, my) is a per-rank generator, or injected
split samples), with the counts summed over the world. The opacity reset
is row-local: each rank runs engine/trainer.py's reset_opacity_step on
its block (trase_tpu's make_sharded_reset_opacity, :554-581, exists only
to keep the sharding in place under jit). Only trase_tpu's
Pallas backend has a counterpart: its dense backend (_composite_my_tiles)
is not ported (ROADMAP.md, not to port).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..engine import trainer as T
from ..engine.optim import AdamState
from ..losses.contrastive import (cosine_gram,
                                  features_correspondence_matrix_hwc)
from ..models import gaussians as G
from ..ops import rasterize_cuda as RC
from ..ops.knn import smooth_rows, smooth_slots
from ..ops.projection import ProjectedGaussians
from ..ops.rasterize import RasterConfig
from ..renderer import project_view, render_outputs
from ..utils.image import bilinear_sample_flat
from .world import (World, all_reduce, all_reduce_list, gather_rows,
                    gather_slab, gather_to_root, own_block,
                    scatter_from_root, sum_replicated)

# ------------------------------------------------------------ the state


def _map_rows(state: T.TrainState, fn) -> T.TrainState:
    """`fn` applied to every per-slot tensor of the state (params, aux and
    the gaussian Adam moments); the step counts and the deform net stay."""
    def adam(s):
        return AdamState(fn(s.mu), fn(s.nu), s.step)

    return state._replace(
        params=G.GaussianParams(*[fn(x) for x in state.params]),
        aux=G.GaussianAux(*[fn(x) for x in state.aux]),
        opt=G.GaussianOptState(*[adam(s) for s in state.opt]))


def interleave_rows(state: T.TrainState, n_shards: int) -> T.TrainState:
    """Round-robin permute the slot rows so alive and free slots spread
    evenly over the ranks' blocks (trase_tpu sharded.py:55-83): fresh,
    grown and imported states pack their alive rows at the front, and the
    per-rank densify allocates from the rank's own free slots. Slot order
    carries no meaning, so this changes no result."""
    c = state.params.xyz.shape[0]
    if c % n_shards:
        raise ValueError(f"capacity {c} not divisible by {n_shards}")
    perm = torch.from_numpy(
        np.arange(c).reshape(c // n_shards, n_shards).T.reshape(-1)).to(
        state.params.xyz.device)
    return _map_rows(state, lambda x: x[perm])


def shard_train_state(state: T.TrainState, world: World) -> T.TrainState:
    """This rank's block of a global state (trase_tpu's shard_train_state,
    :85-107): rows [r C/n, (r+1) C/n), copied, on the world's device; the
    step counts and the deform net replicated."""
    c = state.params.xyz.shape[0]
    if c % world.size:
        raise ValueError(f"capacity {c} not divisible by {world.size}")
    local = _map_rows(state, lambda x: own_block(x, world).to(
        world.device, copy=True).contiguous())
    return _replicated_to(local, world.device)


def unshard_train_state(state: T.TrainState, world: World):
    """The global state in the single-device layout on rank 0's host
    (shard_train_state's inverse), None on the other ranks. Every rank
    takes part; the rows travel one block at a time (gather_to_root)."""
    with torch.no_grad():
        glob = _map_rows(state, lambda x: gather_to_root(x, world))
    if world.rank:
        return None
    return _replicated_to(glob, torch.device("cpu"))


def scatter_train_state(glob, like: T.TrainState, capacity: int,
                        world: World) -> T.TrainState:
    """This rank's block of a global state of `capacity` rows that rank 0
    alone holds (`glob`, on its host; the other ranks pass None):
    shard_train_state's result without a copy of the global state on
    every rank. `like` (this rank's current block) gives the others the
    row tensors' dtypes and trailing shapes, and every rank keeps its own
    replicated parts (the deform net, the step counts)."""
    if capacity % world.size:
        raise ValueError(f"capacity {capacity} not divisible by "
                         f"{world.size}")
    rows = capacity // world.size
    src = like if glob is None else glob
    with torch.no_grad():
        flat = [scatter_from_root(None if glob is None else g, rows, x, world)
                for g, x in zip(_row_tensors(src), _row_tensors(like))]
    it = iter(flat)
    return _map_rows(like, lambda _: next(it))


def _row_tensors(state: T.TrainState) -> list:
    """The per-slot tensors of the state, in _map_rows' order."""
    return (list(state.params) + list(state.aux)
            + [t for s in state.opt for t in (s.mu, s.nu)])


def _replicated_to(state: T.TrainState, dev) -> T.TrainState:
    """The state with its replicated parts (the gaussian Adam step counts,
    the deform net and its Adam state) on `dev`."""
    def adam(s):
        return AdamState(s.mu, s.nu, s.step.to(dev))

    return state._replace(
        opt=G.GaussianOptState(*[adam(s) for s in state.opt]),
        deform=[t.to(dev) for t in state.deform],
        deform_opt=[AdamState(s.mu.to(dev), s.nu.to(dev), s.step.to(dev))
                    for s in state.deform_opt])


# ------------------------------------------------------ render pieces


def _gathered_projection(world: World, camera, params, alive, d_xyz, d_rot,
                         d_scale, *, sh_degree: int, mean2d_offset=None,
                         is_6dof: bool = False, with_color: bool = True):
    """Project this rank's rows, then all-gather the projection so every
    rank can bin and composite any tile (trase_tpu :110-132). The fields
    travel as one float32 table in one collective. Returns (the gathered
    ProjectedGaussians, this rank's radii)."""
    proj = project_view(camera, params, alive, d_xyz, d_rot, d_scale,
                        is_6dof=is_6dof, sh_degree=sh_degree,
                        mean2d_offset=mean2d_offset, with_color=with_color)
    # radius and extent only bin (no gradient flows through them: a zero
    # cotangent through their square roots would be 0 * inf)
    cols = [proj.mean2d, proj.depth[:, None], proj.conic,
            proj.radius.detach()[:, None], proj.color, proj.opacity[:, None],
            proj.valid.to(torch.float32)[:, None]]
    if proj.extent is not None:
        cols.append(proj.extent.detach())
    full = gather_rows(torch.cat(cols, dim=1), world)
    widths = [c.shape[1] for c in cols]
    parts = list(torch.split(full, widths, dim=1))
    gathered = ProjectedGaussians(
        mean2d=parts[0], depth=parts[1][:, 0], conic=parts[2],
        radius=parts[3][:, 0], color=parts[4], opacity=parts[5][:, 0],
        valid=parts[6][:, 0] > 0.5,
        extent=parts[7] if proj.extent is not None else None)
    return gathered, proj.radius


def _composite_my_rows(world: World, proj, extra, bg_color, H: int, W: int,
                       cfg: RasterConfig, with_color: bool = True,
                       grad_values_only: bool = False) -> dict:
    """This rank's slab of tile rows through the compositor's slab mode,
    the slabs all-gathered into the image and cropped to it
    (_composite_my_rows_pallas, trase_tpu :204-254); rasterize_tiled's
    output dict."""
    slab = RC.composite_slab(proj, extra, H, W, cfg, world.rank, world.size,
                             with_color, grad_values_only)
    hwc = gather_slab(slab.hwc, world)[:H]
    return RC.image_outputs(hwc, slab.overflow, bg_color, with_color,
                            extra is not None)


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    # safe norm: dead slots hold all-zero features
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)


def world_render(world: World):
    """renderer.render over a world: the same signature (less
    scaling_modifier, override_color and mask, which no step passes) and
    output keys, with `radii` and `visibility_filter` this rank's rows.
    Feature smoothing runs on the rows: each rank normalizes its features,
    the normalized table is all-gathered, each rank averages its rows'
    neighbours (`smooth_map` holds this rank's rows of the neighbour map,
    in global slot indices) and normalizes again, and the rows are
    gathered for compositing. (trase_tpu's sharded FEATURE step leaves out
    that second normalization: ROADMAP.md, Queue 3.)"""
    def fn(camera, params, aux_alive, bg_color, d_xyz=0.0, d_rotation=0.0,
           d_scaling=0.0, *, is_6dof=False, sh_degree=3,
           norm_gaussian_features=True, smooth_map=None, smooth_perm=None,
           smooth_generator=None, mean2d_offset=None, with_features=True,
           with_color=True, grad_values_only=False,
           raster_cfg=RasterConfig()):
        proj, radii = _gathered_projection(
            world, camera, params, aux_alive, d_xyz, d_rotation, d_scaling,
            sh_degree=sh_degree, mean2d_offset=mean2d_offset,
            is_6dof=is_6dof, with_color=with_color)
        extra = None
        if with_features:
            rows = params.gaussian_features
            if smooth_map is not None:
                slots = smooth_slots(smooth_map.shape[1], smooth_perm,
                                     smooth_generator)
                rows = smooth_rows(gather_rows(_unit_rows(rows), world),
                                   smooth_map, slots)
            if norm_gaussian_features:
                rows = _unit_rows(rows)
            extra = gather_rows(rows, world)
        out = _composite_my_rows(world, proj, extra, bg_color,
                                 camera.image_height, camera.image_width,
                                 raster_cfg, with_color, grad_values_only)
        return render_outputs(out, radii, with_color, with_features)

    return fn


def sharded_render_fn(world: World, sh_degree: int,
                      raster_cfg: RasterConfig = RasterConfig()):
    """Multi-rank render of the canonical gaussians (no deformation):
    fn(camera, params, alive, bg_color) -> (3, H, W) on every rank
    (trase_tpu :257-292)."""
    render = world_render(world)

    def fn(camera, params, alive, bg_color):
        return render(camera, params, alive, bg_color, sh_degree=sh_degree,
                      with_features=False, raster_cfg=raster_cfg)["render"]

    return fn


def sharded_eval_render_fn(world: World, deform_net, sh_degree: int, *,
                           is_6dof: bool = False,
                           raster_cfg: RasterConfig = RasterConfig()):
    """Multi-rank eval render with the deform net at `fid` (its hidden
    stack in bf16, no AST noise), the mesh trainer's render_view
    (trase_tpu :295-341): fn(camera, params, alive, deform, fid, bg_color)
    -> (3, H, W) on every rank."""
    render = world_render(world)

    @torch.no_grad()
    def fn(camera, params, alive, deform, fid, bg_color):
        d = T.apply_deform(deform_net, deform, params.xyz, fid, 0.0, True,
                           params.gaussian_features)
        return render(camera, params, alive, bg_color, *d,
                      sh_degree=sh_degree, is_6dof=is_6dof,
                      with_features=False, raster_cfg=raster_cfg)["render"]

    return fn


def _sampled_gram(feats_acc, sample, hm: int, wm: int) -> torch.Tensor:
    """C_F as trase_tpu's sharded FEATURE step reads it (:699-714): the
    sampled pixels' four taps gathered (utils/image.py:
    bilinear_sample_flat) where the masks' resolution differs from the
    render's, without resizing the whole image."""
    feats = feats_acc[..., 1:]
    if feats.shape[:2] != (hm, wm):
        return cosine_gram(bilinear_sample_flat(feats, sample.pixel_idx, hm,
                                                wm))
    return features_correspondence_matrix_hwc(feats, sample)


def world_ranks(world: World) -> T.Ranks:
    """The steps' Ranks for a world (engine/trainer.py): the world's
    render; the reg term's mean over every rank's rows through an
    all-reduce whose backward is the identity; the deform net's gradients
    all-reduced (each rank holds its rows' share); the NaN guard's flag
    all-reduced by MIN, so that no rank commits a step another skips and
    the replicated deform net stays replicated."""
    def mean(x):
        return sum_replicated(x.sum(), world) / (x.numel() * world.size)

    def agree(finite):
        return all_reduce(finite.to(torch.int32), world,
                          dist.ReduceOp.MIN) > 0

    return T.Ranks(render=world_render(world), feature_gram=_sampled_gram,
                   mean=mean, sum_grads=lambda g: all_reduce_list(g, world),
                   agree=agree)


# ------------------------------------------------------------ the steps


def make_sharded_gaussian_step(world: World, deform_net, **kw):
    """Multi-rank GAUSSIAN step (trase_tpu :344-501): engine/trainer.py's
    gaussian_phase_step over the world, with its keywords and contract:
    step(state, camera, gt_image, fid, ast_noise, lrs, bg_color) ->
    (new local state, metrics replicated on every rank)."""
    return functools.partial(T.gaussian_phase_step, deform_net=deform_net,
                             ranks=world_ranks(world), **kw)


def make_sharded_feature_step(world: World, deform_net, **kw):
    """Multi-rank FEATURE step (trase_tpu :584-796): engine/trainer.py's
    feature_phase_step over the world, with its keywords and contract:
    step(state, camera, sam_masks, mask_valid, fid, lrs, bg_color,
    smooth_map, *, with_densify_stats, generator, sample, smooth_perm) ->
    (new local state, metrics replicated). `smooth_map` holds this rank's
    rows of the neighbour map in global slot indices; `generator` must
    draw the same numbers on every rank (it does when seeded alike), so
    the pixel sample and the smoothing slots are the same everywhere."""
    return functools.partial(T.feature_phase_step, deform_net=deform_net,
                             ranks=world_ranks(world), **kw)


def make_sharded_densify(world: World, *, cfg: G.DensifyConfig,
                         max_new_per_shard: int):
    """Multi-rank densify / clone / split / prune (trase_tpu :504-551):
    fn(state, scene_extent, max_screen_size, generator=None, samples=None)
    -> (new local state, stats summed over the ranks). Each rank densifies
    its own rows into its own free slots, drawing its split samples from
    its own generator (seed it per rank) unless they are given."""
    def fn(state, scene_extent, max_screen_size, generator=None,
           samples=None):
        new, stats = T.densify_step(
            state, scene_extent, max_screen_size, cfg=cfg,
            max_new=max_new_per_shard, generator=generator, samples=samples)
        names = list(stats)
        summed = all_reduce(torch.stack([stats[k].to(torch.int64)
                                         for k in names]), world)
        return new, dict(zip(names, summed.unbind()))

    return fn
