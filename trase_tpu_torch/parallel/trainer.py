"""The training loop over a world of ranks: ``Trainer`` with every device
step sharded.

Counterpart of trase_tpu/parallel/trainer.py (:46-254). Every rank runs
the same host loop (the phase machine, the seeded camera order, the
densify schedule, the pair-budget controller) on its own copy of the
scene, and loads its own masks and GT images; the device steps are
parallel/sharded.py's. What a step returns is the same on every rank
(the loss, the NaN guard's flag, the overflow counts, the densify
counts), so the ranks take the same decisions without talking about
them. Rank 0 alone prints, writes TensorBoard, and saves checkpoints and
snapshots, from the global state gathered onto its host in the
single-device layout: a checkpoint of a mesh run loads in a
single-device run, and a single-device one in a mesh run.

No card holds the global state: it is built (from a scene on the host)
or loaded on the host, and each rank copies only its block to its card;
saves gather it onto rank 0's host one block at a time, and capacity
growth grows it there and sends each rank its block.

The capacity is rounded up to a multiple of the world size at
construction and after a load; growth doubles it, which keeps the
multiple.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..engine.loop import MAX_NEW_PER_DENSIFY, Trainer
from ..models import gaussians as G
from ..ops.knn import knn, transpose_smooth_map
from .sharded import (
    interleave_rows,
    make_sharded_densify,
    make_sharded_feature_step,
    make_sharded_gaussian_step,
    scatter_train_state,
    shard_train_state,
    sharded_eval_render_fn,
    unshard_train_state,
)
from .world import World, all_gather, all_reduce

# rank r's split samples come from seed + 1 + r * this: rank 0 draws the
# single-device trainer's numbers
DENSIFY_SEED_STRIDE = 1_000_003


class ShardedTrainer(Trainer):
    """``Trainer`` over a world of ranks (parallel/world.py: init_world).
    Give it a scene on the host (``Scene(..., device="cpu")``): the global
    state is built there, and each rank keeps its block on its device.

    interleave_slots: round-robin permute the slot rows so alive and free
    slots spread over the ranks (the per-rank densify allocates from the
    rank's own free slots); off only for row-aligned parity tests.
    max_new_per_densify: the world's clone and split budget per densify,
    max_new_per_shard = ceil(max_new_per_densify / ranks) on each rank
    (trase_tpu/parallel/trainer.py:60-81)."""

    def __init__(self, dataset_args, opt_args, pipe_args, scene,
                 world: World, raster_cfg=None,
                 max_new_per_densify: int = MAX_NEW_PER_DENSIFY,
                 seed: int = 0, interleave_slots: bool = True):
        self.world = world
        super().__init__(dataset_args, opt_args, pipe_args, scene,
                         raster_cfg=raster_cfg,
                         max_new_per_densify=max_new_per_densify, seed=seed,
                         device=world.device)
        self.n_shards = world.size
        self.interleave_slots = interleave_slots
        self.max_new_per_shard = -(-self.max_new // self.n_shards)
        self.densify_gen = torch.Generator().manual_seed(
            seed + 1 + DENSIFY_SEED_STRIDE * world.rank)
        self._interleave_load = interleave_slots
        self.state = self._distribute(self.state)
        self._n_alive_cache = self._num_alive()

    # --------------------------------------------------------- the state

    def _make_logger(self):
        return super()._make_logger() if self.world.rank == 0 else None

    def _num_alive(self) -> int:
        return int(all_reduce(self.state.aux.alive.sum(), self.world))

    def _capacity(self) -> int:
        return self.state.params.xyz.shape[0] * self.n_shards

    def _global_device(self):
        return torch.device("cpu")

    def _distribute(self, state):
        """A global state (on this rank's host) -> this rank's block:
        capacity rounded up to a multiple of the world, rows interleaved
        when _interleave_load says so, then sharded."""
        capacity = state.params.xyz.shape[0]
        if capacity % self.n_shards:
            p, a, o = G.grow_capacity(
                state.params, state.aux, state.opt,
                -(-capacity // self.n_shards) * self.n_shards)
            state = state._replace(params=p, aux=a, opt=o)
        if self._interleave_load:
            state = interleave_rows(state, self.n_shards)
        self._interleave_load = False
        return shard_train_state(state, self.world)

    def global_state(self):
        """The state in the single-device layout on rank 0's host (every
        rank takes part; the others get None)."""
        return unshard_train_state(self.state, self.world)

    def _on_rank0_with_global(self, fn):
        """fn() on rank 0 with self.state the global state on its host,
        the other ranks waiting at a barrier until it is done."""
        glob = self.global_state()
        if self.world.rank == 0:
            local, self.state = self.state, glob
            try:
                fn()
            finally:
                self.state = local
        dist.barrier(group=self.world.group)

    # ------------------------------------------------------------ steps

    def _gaussian_step(self, cam, iteration):
        use_deform = iteration >= self.opt.warm_up
        ast = self.ast_noise_fn(self.np_rng, iteration)
        step = make_sharded_gaussian_step(
            self.world, self.deform_net, sh_degree=self.active_sh_degree,
            use_deform=use_deform, is_6dof=self.args.is_6dof,
            lambda_dssim=self.opt.lambda_dssim,
            lambda_reg_deform=self.opt.lambda_reg_deform,
            raster_cfg=self.raster_cfg)
        self.state, metrics = step(
            self.state, cam.to_render_camera(self.device),
            self._gt_image(cam), cam.fid, ast, self.lr_at(iteration),
            self.bg_color)
        self.step_calls += 1
        self.skipped = self.skipped + (~metrics["finite"]).to(torch.int32)
        return metrics

    def _feature_step(self, cam, iteration):
        entry = self._masks_for(cam)
        if entry is None:
            return None
        opt = self.opt
        step = make_sharded_feature_step(
            self.world, self.deform_net, sh_degree=self.active_sh_degree,
            use_deform=iteration >= opt.warm_up, is_6dof=self.args.is_6dof,
            contrastive_mode=opt.contrastive_mode, rfn=opt.rfn,
            positive_th=opt.hard_positive_th,
            negative_th=opt.hard_negative_th,
            num_sampled_pixels=opt.num_sampled_pixels,
            num_sampled_masks=opt.num_sampled_masks,
            raster_cfg=self.raster_cfg)
        smooth = self._get_smooth_map() if opt.smooth_K != 1 else None
        self.state, metrics = step(
            self.state, cam.to_render_camera(self.device), *entry, cam.fid,
            self.lr_at(iteration), self.bg_color, smooth,
            with_densify_stats=iteration < opt.densify_until_iter,
            generator=self.feature_gen)
        self.feature_calls += 1
        self.skipped = self.skipped + (~metrics["finite"]).to(torch.int32)
        return metrics

    def _get_smooth_map(self):
        """This rank's rows of the neighbour map: the KNN of its xyz among
        the gathered xyz, in global slot indices (the global map's block,
        up to the order of equal distances), with its transpose into the
        gathered rows (a SmoothMap)."""
        if self._smooth_dirty or self._smooth_map is None:
            with torch.no_grad():
                xyz = self.state.params.xyz
                every = all_gather(xyz, self.world)
                self._smooth_map = transpose_smooth_map(
                    knn(xyz, every, max(int(self.opt.smooth_K), 1))[1],
                    every.shape[0])
            self._smooth_dirty = False
        return self._smooth_map

    def _densify(self, iteration):
        size_threshold = (20.0 if iteration > self.opt.opacity_reset_interval
                          else 0.0)
        cfg = G.DensifyConfig(grad_threshold=self.opt.densify_grad_threshold,
                              percent_dense=self.opt.percent_dense,
                              min_opacity=0.005)
        capacity = self._capacity()
        budget = self.max_new_per_shard * self.n_shards
        if self._num_alive() + 2 * budget > capacity:
            # grown on rank 0's host; growth appends dead rows at the end:
            # interleave them so every rank gets free slots
            glob = self.global_state()
            if glob is not None:
                p, a, o = G.grow_capacity(glob.params, glob.aux, glob.opt,
                                          capacity * 2)
                glob = glob._replace(params=p, aux=a, opt=o)
                if self.interleave_slots:
                    glob = interleave_rows(glob, self.n_shards)
            self.state = scatter_train_state(glob, self.state, capacity * 2,
                                             self.world)
            print(f"[densify] capacity {capacity} -> {capacity * 2}")
        densify = make_sharded_densify(
            self.world, cfg=cfg, max_new_per_shard=self.max_new_per_shard)
        self.state, stats = densify(
            self.state, float(self.scene.cameras_extent), size_threshold,
            generator=self.densify_gen)
        self._n_alive_cache = int(stats["n_alive"])
        self._smooth_dirty = True
        return stats

    # ------------------------------------------------------------- eval

    @torch.no_grad()
    def render_view(self, cam) -> torch.Tensor:
        fn = sharded_eval_render_fn(
            self.world, self.deform_net, self.active_sh_degree,
            is_6dof=self.args.is_6dof, raster_cfg=self.raster_cfg)
        return fn(cam.to_render_camera(self.device), self.state.params,
                  self.state.aux.alive, self.state.deform, cam.fid,
                  self.bg_color)

    # ------------------------------------------------------- save / load

    def save_snapshot(self, iteration: int):
        self._on_rank0_with_global(lambda: super(
            ShardedTrainer, self).save_snapshot(iteration))

    def save_ckpt(self, iteration: int):
        self._on_rank0_with_global(lambda: super(
            ShardedTrainer, self).save_ckpt(iteration))

    def load_ckpt(self, path: str) -> int:
        it = super().load_ckpt(path)
        if self.world.rank:
            # the checkpoint holds rank 0's split generator: the other
            # ranks derive theirs from it and their rank
            seed = int(torch.randint(2 ** 62, (1,),
                                     generator=self.densify_gen))
            self.densify_gen.manual_seed(seed + self.world.rank)
        return it

    def load_reference_ckpt(self, path: str) -> int:
        # imported captures pack the alive rows first: interleave them
        self._interleave_load = self.interleave_slots
        return super().load_reference_ckpt(path)

    def _postload(self):
        self.state = self._distribute(self.state)
        super()._postload()
