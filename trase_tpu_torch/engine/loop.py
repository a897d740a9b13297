"""Host-side training loop of the port: the GAUSSIAN phase.

Counterpart of trase_tpu/engine/loop.py (:56-160, :297-315, :356-440,
:443-612, :805; reference train.py:76-398) for runs shorter than
``warm_up_3d_features``: the Deformable-3DGS stage that every TRASE run
starts with. It keeps the SH-degree ramp, camera sampling from
``np.random.default_rng(seed)`` (in trase_tpu's draw order), the deform
warm-up, densify / opacity-reset timing, capacity growth, the
pair-budget controller and the snapshot layout render.py reads
(point_cloud/iteration_N/point_cloud.ply, deform/iteration_N/deform.pkl).

A run that would reach ``warm_up_3d_features`` with SAM masks present
needs the FEATURE step and is refused. Left out: the metrics pipeline
and the watchdog (they existed for a remote device), tensorboard,
``evaluate`` and training checkpoints. The step's metrics stay on the
device; the host reads them every 10 iterations (progress line, skipped
steps) and every 100 (pair budget).
"""
from __future__ import annotations

import os
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import gaussians as G
from ..models.deform import flax_variables, init_deform, make_deform_network
from ..models.gaussians_io import save_checkpoint
from ..ops.rasterize import RasterConfig
from . import trainer as T

# densify_and_prune's static budget of clones and of splits per call, and
# the device GT cache's size, as trase_tpu's loop sets them
MAX_NEW_PER_DENSIFY = 8192
GT_CACHE_SIZE = 128


def _load_gt(path: str, bg: np.ndarray) -> np.ndarray:
    """(3, H, W) float32 image from disk, alpha composited over `bg`."""
    from PIL import Image

    with Image.open(path) as im:
        rgba = np.asarray(im.convert("RGBA"), np.float32) / 255.0
    a = rgba[..., 3:4]
    rgb = rgba[..., :3] * a + bg[None, None, :] * (1.0 - a)
    return np.ascontiguousarray(rgb.transpose(2, 0, 1), np.float32)


class Trainer:
    def __init__(self, dataset_args, opt_args, pipe_args, scene,
                 raster_cfg: Optional[RasterConfig] = None, seed: int = 0,
                 device="cuda"):
        self.args = dataset_args
        self.opt = opt_args
        self.pipe = pipe_args
        self.scene = scene
        self.device = resolve_device(device)
        self.raster_cfg = raster_cfg or RasterConfig()
        self.max_new = MAX_NEW_PER_DENSIFY

        self.deform_net = make_deform_network(
            getattr(opt_args, "deform_type", "DeformNetwork"),
            is_blender=dataset_args.is_blender,
            is_6dof=dataset_args.is_6dof, device=self.device)
        init_deform(self.deform_net, torch.Generator().manual_seed(seed))
        self.np_rng = np.random.default_rng(seed)
        # the split's standard normals (densify_and_prune)
        self.densify_gen = torch.Generator().manual_seed(seed + 1)

        self.state = T.init_train_state(
            scene.gaussian_params, scene.gaussian_aux,
            T.deform_tensors(self.deform_net))
        self.lr_at = T.make_learning_rate_schedules(
            opt_args, scene.spatial_lr_scale)
        bg = [1.0, 1.0, 1.0] if dataset_args.white_background else [0, 0, 0]
        self.bg_color = torch.tensor(bg, dtype=torch.float32,
                                     device=self.device)
        self.active_sh_degree = 0
        self.max_sh_degree = dataset_args.sh_degree
        cams = scene.get_train_cameras()
        self.num_frames = len(cams)
        self.ast_noise_fn = T.make_ast_noise_fn(self.num_frames,
                                                dataset_args.is_blender)

        # device GT cache, LRU, keyed on the image's path (names repeat
        # across splits) and size
        self._gt_cache: OrderedDict = OrderedDict()
        self._next_cam = None

        self._overflow_strikes = 0
        self._initial_pairs_per_gaussian = \
            self.raster_cfg.pairs_per_gaussian
        self._deescalate_clean = 0
        self._n_alive_cache = int(self.state.aux.alive.sum())
        self.skipped = torch.zeros((), dtype=torch.int32, device=self.device)
        self.ema_loss = 0.0
        self.step_calls = 0

    # ------------------------------------------------------------ data

    def _gt_image(self, cam) -> torch.Tensor:
        key = (cam.image_path or cam.image_name, cam.image_width,
               cam.image_height)
        if key in self._gt_cache:
            self._gt_cache.move_to_end(key)
            return self._gt_cache[key]
        img = cam.image
        if img is None:
            img = _load_gt(cam.image_path, self.bg_color.cpu().numpy())
        self._gt_cache[key] = torch.as_tensor(
            np.asarray(img, np.float32), device=self.device)
        while len(self._gt_cache) > GT_CACHE_SIZE:
            self._gt_cache.popitem(last=False)
        return self._gt_cache[key]

    # ------------------------------------------------------------ steps

    def _gaussian_step(self, cam, iteration):
        use_deform = iteration >= self.opt.warm_up
        ast = self.ast_noise_fn(self.np_rng, iteration)
        self.state, metrics = T.gaussian_phase_step(
            self.state, cam.to_render_camera(self.device),
            self._gt_image(cam), cam.fid, ast, self.lr_at(iteration),
            self.bg_color, deform_net=self.deform_net,
            sh_degree=self.active_sh_degree, use_deform=use_deform,
            is_6dof=self.args.is_6dof, lambda_dssim=self.opt.lambda_dssim,
            lambda_reg_deform=self.opt.lambda_reg_deform,
            raster_cfg=self.raster_cfg)
        self.step_calls += 1
        self.skipped = self.skipped + (~metrics["finite"]).to(torch.int32)
        return metrics

    def _densify(self, iteration):
        size_threshold = (20.0 if iteration > self.opt.opacity_reset_interval
                          else 0.0)
        cfg = G.DensifyConfig(grad_threshold=self.opt.densify_grad_threshold,
                              percent_dense=self.opt.percent_dense,
                              min_opacity=0.005)
        n_alive = int(self.state.aux.alive.sum())
        capacity = self.state.params.xyz.shape[0]
        if n_alive + self.max_new + self.max_new > capacity:
            p, a, o = G.grow_capacity(self.state.params, self.state.aux,
                                      self.state.opt, capacity * 2)
            self.state = self.state._replace(params=p, aux=a, opt=o)
            print(f"[densify] capacity {capacity} -> {capacity * 2}")
        self.state, stats = T.densify_step(
            self.state, float(self.scene.cameras_extent), size_threshold,
            cfg=cfg, max_new=self.max_new, generator=self.densify_gen)
        self._n_alive_cache = int(stats["n_alive"])
        return stats

    def _reset_opacity(self):
        self.state = T.reset_opacity_step(self.state)

    def _handle_overflow(self, iteration: int, dropped: float,
                         dropped_half: float = -1.0):
        """Pair-budget truncation guard (trase_tpu's): complain when the
        dropped share of the K-pair budget passes the warning threshold,
        double K after two consecutive strikes (up to the cap), and halve
        it back toward the configured K after 10 clean checks at K//2."""
        total = max(float(self._n_alive_cache)
                    * self.raster_cfg.pairs_per_gaussian, 1.0)
        frac = dropped / total
        k = self.raster_cfg.pairs_per_gaussian
        if frac <= self.opt.overflow_warn_frac:
            self._overflow_strikes = 0
            if dropped_half == 0.0 and k > self._initial_pairs_per_gaussian:
                self._deescalate_clean += 1
                if self._deescalate_clean >= 10:
                    self.raster_cfg = self.raster_cfg._replace(
                        pairs_per_gaussian=k // 2)
                    self._deescalate_clean = 0
                    print(f"[ITER {iteration}] pair budget de-escalated: "
                          f"K={k} -> {k // 2} (no drops at K//2 for 10 "
                          "consecutive checks)")
            else:
                self._deescalate_clean = 0
            return
        self._deescalate_clean = 0
        print(f"[ITER {iteration}] WARNING: pair budget overflow "
              f"{dropped:.0f} dropped pairs ({frac:.1%} of budget) — raise "
              f"--pairs_per_gaussian (K={k})")
        self._overflow_strikes += 1
        if self._overflow_strikes >= 2 and \
                k * 2 <= self.opt.max_pairs_per_gaussian:
            self.raster_cfg = self.raster_cfg._replace(
                pairs_per_gaussian=k * 2)
            self._overflow_strikes = 0
            print(f"[ITER {iteration}] pair budget auto-escalated: "
                  f"K={k} -> {k * 2}")

    # ------------------------------------------------------------ train

    def train(self, first_iter: int = 0, saving_iterations=(),
              progress: bool = True, on_iteration=None):
        opt = self.opt
        train_cams = self.scene.get_train_cameras()
        has_masks = any(c.masks is not None or c.mask_path
                        for c in train_cams)
        if has_masks and opt.iterations >= opt.warm_up_3d_features:
            raise NotImplementedError(
                f"--iterations {opt.iterations} reaches warm_up_3d_features "
                f"({opt.warm_up_3d_features}) with SAM masks present: the "
                "FEATURE step belongs to the FEATURE slice of the port. "
                "Train fewer iterations, or raise --warm_up_3d_features.")
        iter_bar = None
        if progress:
            try:
                from tqdm import tqdm

                iter_bar = tqdm(range(first_iter, opt.iterations),
                                desc="Training progress")
            except ImportError:
                pass

        viewpoint_stack = []
        t_start = time.time()
        for iteration in range(first_iter + 1, opt.iterations + 1):
            if iteration % 1000 == 0 and \
                    self.active_sh_degree < self.max_sh_degree:
                self.active_sh_degree += 1

            if not viewpoint_stack:
                viewpoint_stack = list(train_cams)
            if self._next_cam is not None:
                cam = self._next_cam
            else:
                cam = viewpoint_stack.pop(
                    int(self.np_rng.integers(0, len(viewpoint_stack))))
            # trase_tpu pre-draws the next view here (to prefetch its
            # masks); drawing it at the same point keeps the same views
            if viewpoint_stack:
                self._next_cam = viewpoint_stack.pop(
                    int(self.np_rng.integers(0, len(viewpoint_stack))))
            else:
                self._next_cam = None

            metrics = self._gaussian_step(cam, iteration)
            if iteration % 100 == 0:
                over = metrics["overflow"], metrics["overflow_half"]
                self._handle_overflow(iteration, *[float(x) for x in over])
            if iteration % 10 == 0:
                loss, skipped = float(metrics["loss"]), int(self.skipped)
                self.ema_loss = 0.4 * loss + 0.6 * self.ema_loss
                if iter_bar:
                    iter_bar.set_postfix({"Loss": f"{self.ema_loss:.3f}",
                                          "Points": self._n_alive_cache,
                                          "Skipped": skipped})
                    iter_bar.update(10)

            if iteration in saving_iterations:
                self.save_snapshot(iteration)

            # densification (train.py:361-373)
            if iteration < opt.densify_until_iter:
                if iteration > opt.densify_from_iter and \
                        iteration % opt.densification_interval == 0:
                    self._densify(iteration)
                if iteration % opt.opacity_reset_interval == 0 or (
                        self.args.white_background
                        and iteration == opt.densify_from_iter):
                    self._reset_opacity()

            if on_iteration is not None:
                on_iteration(self, iteration, metrics)

        if iter_bar:
            iter_bar.close()
        dt = time.time() - t_start
        n_iters = opt.iterations - first_iter
        skipped = int(self.skipped)
        if skipped:
            print(f"[train] {skipped} non-finite steps skipped")
        if n_iters > 0:
            print(f"[timing] {n_iters} iters in {dt:.1f}s = "
                  f"{n_iters / dt:.2f} it/s")

    # ------------------------------------------------------------- save

    def deform_variables(self) -> dict:
        """The state's deform weights in trase_tpu's flax layout."""
        with torch.no_grad():
            names = self.deform_net.flax_names()
            named = dict(self.deform_net.named_parameters())
            for name, t in zip(names, self.state.deform):
                named[name].copy_(t)
        return flax_variables(self.deform_net)

    def save_snapshot(self, iteration: int):
        """point_cloud/iteration_N/point_cloud.ply and
        deform/iteration_N/deform.pkl, as trase_tpu writes them. The
        features are written unsmoothed: the KNN feature smoothing comes
        with the FEATURE slice (this phase does not train them)."""
        print(f"\n[ITER {iteration}] Saving Gaussians")
        self.scene.save(iteration, self.state.params, self.state.aux.alive)
        deform_dir = os.path.join(self.args.model_path, "deform",
                                  f"iteration_{iteration}")
        save_checkpoint(os.path.join(deform_dir, "deform.pkl"),
                        {"vars": self.deform_variables(),
                         "type": getattr(self.opt, "deform_type",
                                         "DeformNetwork")})
