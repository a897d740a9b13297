"""Host-side training loop of the port: both phases.

Counterpart of trase_tpu/engine/loop.py (:56-160, :197-384, :443-612,
:805-815; reference train.py:76-398). It keeps the SH-degree ramp,
camera sampling from ``np.random.default_rng(seed)`` (in trase_tpu's
draw order), the deform warm-up, densify / opacity-reset timing,
capacity growth, the pair-budget controller and the snapshot layout
render.py reads (point_cloud/iteration_N/point_cloud.ply with the
KNN-smoothed features, deform/iteration_N/deform.pkl).

From ``warm_up_3d_features`` on, when the dataset has SAM masks, the
OPT_STATE machine alternates GAUSSIAN and FEATURE blocks every
``iterative_opt_interval`` counted steps (steps the NaN guard skipped do
not count). The FEATURE step reads the camera's masks, padded to one
(M_max, H, W) stack per dataset and cached on the device (LRU, keyed on
the image path), and the feature-smoothing KNN map, rebuilt where
trase_tpu's loop rebuilds it: at each switch into FEATURE and after each
densify. A camera without masks inside a FEATURE block takes a GAUSSIAN
step and leaves the map as it is. The FEATURE step carries the
densification statistics while ``iteration < densify_until_iter`` and
runs values-only after.

At each of ``testing_iterations`` it evaluates as trase_tpu's loop does
(:570-580, :729-801): the L1 and PSNR of five fixed test and train views,
rendered without features through the bf16 deform stack, and the best
test PSNR at the end.

Run state (trase_tpu loop.py:35-55, :823-918): TensorBoard scalars under
trase_tpu's tags when the ``tensorboard`` package is installed, and
training checkpoints. ``save_ckpt`` writes ``chkpnt<N>.pkl``, a pickle of
numpy dicts that names no class of the port: the state in
``train_state_to_numpy``'s layout, its keyed schema, the iteration, the
SH degree, the phase machine and, beyond trase_tpu's fields, what the
port draws from and counts: the states of ``np_rng``, ``densify_gen``
and ``feature_gen`` (trase_tpu derives each step's randoms from the
iteration, the port from stateful generators), the skipped-step
counters and the view stack. A resume on the same device then continues
the run's draws. ``load_ckpt`` reads the port's own checkpoints,
trase_tpu's (its NamedTuples unpickled as stand-ins,
``models/gaussians_io.py``) and the reference's ``chkpnt<N>.pth``
(``tools/import_torch.py``; no deform weights, as in trase_tpu).

Host IO (trase_tpu loop.py:183-190, :221-262, :526-535): GT images
convert through the native RGBA -> float32 path (``native.py``); masks
read from disk (``--load_mask_on_the_fly``) decode on a background
thread (``MaskPrefetcher``): the loop pre-draws the next view before each
step, as trase_tpu's does, and submits its decode, and a step whose
stack is not cached takes it from the prefetcher (decoding inline what
was never submitted). The prefetcher closes when ``train`` returns.
A native bit-packed mask file (``save_mask_file``'s .npz, what
``extract_masks`` writes) decodes only to its bits, page-locked where
CUDA is present; a miss copies them up without waiting for the queued
work and the 0/1s become the cached float32 stack on the device
(ops/mask_unpack.py: the CUDA kernel on a card, its plain version on the
CPU), the same values bit for bit. In-memory ``cam.masks`` and .pt and
.npy files keep the host path: the float32 stack is padded on the host
and copied up as it is. The counter ``mask_fetch`` counts each miss's
path and the bytes it uploaded:
``("bits" | "float32", "miss" | "bytes")``.

``train(stall_timeout_s=T)`` arms trase_tpu's stall watchdog
(loop.py:443-476): a daemon thread, ``stall-watchdog``, that ends the
process with exit code 86 when no iteration has completed for T seconds
(a hung kernel or a hung collective blocks the host inside a native call,
where no Python signal handler or deadline check runs). Each completed
iteration refreshes its heartbeat, the thread ends with ``train``, and
T = 0 starts none.

Tracing (utils/trace.py): each iteration is the span ``trase.iteration``
(up to the ``on_iteration`` call) and holds ``trase.loop.fetch`` (the GT
image or mask stack: ``trase.loop.fetch.wait`` for the prefetcher or an
inline read, ``trase.loop.fetch.upload`` for the host-to-device copy),
the step's ``trase.step``, ``trase.loop.read_metrics`` and
``trase.loop.densify``; the counter ``cache`` counts the GT and mask
caches' hits and misses. ``train_style`` (the style CLI's loop: NNFM
fine-tuning of one object's colours) names its iterations the same way,
each holding the style step's ``trase.step`` and, every 10th, the loss
EMA's read ``trase.loop.read_metrics``.

Left out: the metrics pipeline (it existed for a remote device). The
step's metrics stay on the device; the host reads them every 10
iterations (progress line, skipped steps, TensorBoard's loss scalars and
iteration time), every 100 (pair budget), and at a block's end (phase
switch).
"""
from __future__ import annotations

import os
import re
import sys
import threading
import time
import types
import warnings
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.masks import (MaskPrefetcher, PackedMasks, decode_mask_file,
                          load_stack, mask_file_shape, pad_masks)
from ..models import gaussians as G
from ..models.deform import flax_variables, init_deform, make_deform_network
from ..models.gaussians_io import load_checkpoint, save_checkpoint
from ..native import rgba_to_rgb_f32
from ..ops.knn import (build_feature_smooth_map, smooth_features,
                       transpose_smooth_map)
from ..ops.mask_unpack import unpack_masks
from ..ops.rasterize import RasterConfig
from ..renderer import render
from ..utils import trace
from ..utils.image import psnr
from . import trainer as T

# densify_and_prune's default budget of clones and of splits per call, the
# device GT cache's size, and the mask cache's floor and cap (the cache
# holds the whole train set up to the cap), as trase_tpu's loop sets them
MAX_NEW_PER_DENSIFY = 8192
GT_CACHE_SIZE = 128
MASK_CACHE_SIZE, MASK_CACHE_CAP = 8, 128
# the stall watchdog's exit code (trase_tpu's: apart from timeout(1)'s 124)
STALL_EXIT_CODE = 86
# hits and misses of the device caches: ("gt" | "masks", "hit" | "miss")
CACHE_COUNTS = trace.counter("cache")
# the mask cache's misses by the path their stack took, and the bytes each
# path uploaded: ("bits" | "float32", "miss" | "bytes")
MASK_FETCH = trace.counter("mask_fetch")


def _load_gt(path: str, bg: np.ndarray) -> np.ndarray:
    """(3, H, W) float32 image from disk, alpha composited over `bg`."""
    from PIL import Image

    with Image.open(path) as im:
        rgba = np.asarray(im.convert("RGBA"))
    return rgba_to_rgb_f32(rgba, bg)


class TensorBoardLogger:
    """TensorBoard scalars through torch.utils.tensorboard when the
    tensorboard package is installed (trase_tpu loop.py:35-53). It writes
    with tensorboard's TensorFlow-free file writer, selected for the
    process by registering tensorboard's no-TensorFlow switch module
    (tensorboard.compat.notf): tensorboard otherwise imports TensorFlow,
    where installed, to write the same files."""

    def __init__(self, model_path: str):
        self.writer = None
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(model_path)
        except ImportError:
            print("Tensorboard not available: not logging progress")

    def scalar(self, tag, value, step):
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), step)

    def close(self):
        if self.writer is not None:
            self.writer.close()


def _keyed(path: str) -> str:
    """A jax keystr path (.params.xyz, .opt.xyz.mu) in the dict notation
    of engine/trainer.py: tree_schema (['params']['xyz'])."""
    return re.sub(r"\.([A-Za-z_]\w*)", r"['\1']", path)


class Trainer:
    def __init__(self, dataset_args, opt_args, pipe_args, scene,
                 raster_cfg: Optional[RasterConfig] = None,
                 max_new_per_densify: int = MAX_NEW_PER_DENSIFY,
                 seed: int = 0, device="cuda"):
        self.args = dataset_args
        self.opt = opt_args
        self.pipe = pipe_args
        self.scene = scene
        self.device = resolve_device(device)
        self.raster_cfg = raster_cfg or RasterConfig()
        self.max_new = max_new_per_densify

        self.deform_net = make_deform_network(
            getattr(opt_args, "deform_type", "DeformNetwork"),
            is_blender=dataset_args.is_blender,
            is_6dof=dataset_args.is_6dof, device=self.device)
        init_deform(self.deform_net, torch.Generator().manual_seed(seed))
        self.np_rng = np.random.default_rng(seed)
        # the split's standard normals (densify_and_prune)
        self.densify_gen = torch.Generator().manual_seed(seed + 1)
        # the FEATURE step's pixel / mask samples and smoothing slots
        self.feature_gen = torch.Generator(device=self.device).manual_seed(
            seed + 2)
        self.opt_state = T.OptState(opt_args.iterative_opt_interval)

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
        # padded mask stacks on the device, LRU, keyed as the GT cache
        self._mask_cache: OrderedDict = OrderedDict()
        self.mask_cache_size = MASK_CACHE_SIZE
        self._m_max = 1
        self._prefetcher = None
        self._prefetched: dict = {}  # mask paths submitted, not yet taken
        self._smooth_map = None
        self._smooth_dirty = True

        self._overflow_strikes = 0
        self._initial_pairs_per_gaussian = \
            self.raster_cfg.pairs_per_gaussian
        self._deescalate_clean = 0
        self._n_alive_cache = int(self.state.aux.alive.sum())
        self.skipped = torch.zeros((), dtype=torch.int32, device=self.device)
        self._skipped_seen = 0  # skipped steps the phase counter left out
        self.ema_loss = 0.0
        self.best_psnr = 0.0
        self.best_iteration = 0
        self.step_calls = 0
        self.feature_calls = 0
        self._viewpoint_stack = []
        self._phase_restored = False  # load_ckpt restored the phase machine
        self._log_t = None
        self.tb = self._make_logger()

    def _make_logger(self):
        """TensorBoard's logger under the model path, when there is one."""
        path = self.args.model_path
        return TensorBoardLogger(path) if path else None

    def _num_alive(self) -> int:
        """The number of live gaussians."""
        return int(self.state.aux.alive.sum())

    def _global_device(self):
        """Where a loaded state lands (ShardedTrainer: the host, before
        each rank takes its block)."""
        return self.device

    # ------------------------------------------------------------ data

    def _gt_image(self, cam) -> torch.Tensor:
        key = (cam.image_path or cam.image_name, cam.image_width,
               cam.image_height)
        if key in self._gt_cache:
            trace.bump(CACHE_COUNTS, ("gt", "hit"))
            self._gt_cache.move_to_end(key)
            return self._gt_cache[key]
        trace.bump(CACHE_COUNTS, ("gt", "miss"))
        img = cam.image
        if img is None:
            with trace.span("trase.loop.fetch.wait"):
                img = _load_gt(cam.image_path, self.bg_color.cpu().numpy())
        with trace.span("trase.loop.fetch.upload"):
            self._gt_cache[key] = torch.as_tensor(
                np.asarray(img, np.float32), device=self.device)
        while len(self._gt_cache) > GT_CACHE_SIZE:
            self._gt_cache.popitem(last=False)
        return self._gt_cache[key]

    def _prepare_mask_meta(self, cams):
        """M_max across the dataset, from shape metadata where the file
        has it; the mask cache is sized to the train set (capped), so
        each stack uploads once."""
        self.mask_cache_size = max(self.mask_cache_size,
                                   min(len(cams), MASK_CACHE_CAP))
        m_max = 0
        for cam in cams:
            shape = None
            if cam.masks is not None:
                shape = cam.masks.shape
            elif cam.mask_path:
                shape = mask_file_shape(cam.mask_path)
                if shape is None:
                    m = decode_mask_file(cam.mask_path)
                    shape = None if m is None else m.shape
            if shape is not None:
                m_max = max(m_max, shape[0])
        self._m_max = max(m_max, 1)
        if any(cam.mask_path and cam.masks is None for cam in cams):
            self._prefetcher = MaskPrefetcher(self._m_max)

    def _submit_mask_prefetch(self, cam):
        """Start the background decode of a coming camera's masks."""
        key = cam.image_path or cam.image_name
        if (self._prefetcher is not None and cam.masks is None
                and cam.mask_path and key not in self._mask_cache
                and cam.mask_path not in self._prefetched):
            self._prefetched[cam.mask_path] = True
            self._prefetcher.submit(cam.mask_path)

    def _close_prefetcher(self):
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None
        self._prefetched.clear()

    def _masks_for(self, cam):
        """(masks (M_max, H, W) float32, valid (M_max,) bool) on the
        device, or None when the camera has no masks."""
        key = cam.image_path or cam.image_name
        if key in self._mask_cache:
            trace.bump(CACHE_COUNTS, ("masks", "hit"))
            self._mask_cache.move_to_end(key)
            return self._mask_cache[key]
        got = None
        with trace.span("trase.loop.fetch.wait"):
            if cam.masks is not None:
                got = pad_masks(np.asarray(cam.masks), self._m_max)
            elif cam.mask_path:
                # drain the prefetcher up to this camera's file (the
                # stacks decoded ahead of it are dropped, as in trase_tpu's
                # loop)
                while cam.mask_path in self._prefetched:
                    path, out = self._prefetcher.get()
                    del self._prefetched[path]
                    if path == cam.mask_path:
                        got = out
                if got is None:
                    with trace.span("trase.masks.decode"):
                        got = load_stack(cam.mask_path, self._m_max)
        if got is None:
            return None
        trace.bump(CACHE_COUNTS, ("masks", "miss"))
        with trace.span("trase.loop.fetch.upload"):
            entry = self._upload_masks(got)
        self._mask_cache[key] = entry
        while len(self._mask_cache) > self.mask_cache_size:
            self._mask_cache.popitem(last=False)
        return entry

    def _upload_masks(self, got):
        """(masks, valid) on the device from a decoded stack. Packed bits
        (page-locked on a card) go up asynchronously, and the unpack runs
        behind the copy on the same stream; no call here waits for the
        device. A float32 stack is copied up as it is."""
        dev = self.device
        if isinstance(got, PackedMasks):
            n, h, w = got.shape
            masks = unpack_masks(got.bits.to(dev, non_blocking=True), n, h,
                                 w, self._m_max)
            valid = torch.arange(self._m_max, device=dev) < n
            kind, nbytes = "bits", got.bits.nbytes
        else:
            masks = torch.as_tensor(got.masks, device=dev)
            valid = torch.as_tensor(got.valid, device=dev)
            kind, nbytes = "float32", got.masks.nbytes + got.valid.nbytes
        trace.bump(MASK_FETCH, (kind, "miss"))
        trace.bump(MASK_FETCH, (kind, "bytes"), nbytes)
        return masks, valid

    def _get_smooth_map(self):
        """The FEATURE steps' SmoothMap: the KNN map of the current xyz and
        its transpose, rebuilt where the map was marked stale."""
        if self._smooth_dirty or self._smooth_map is None:
            with torch.no_grad():
                self._smooth_map = transpose_smooth_map(
                    build_feature_smooth_map(
                        self.state.params.xyz,
                        max(int(self.opt.smooth_K), 1)))
            self._smooth_dirty = False
        return self._smooth_map

    # ------------------------------------------------------------ steps

    def _gaussian_step(self, cam, iteration):
        use_deform = iteration >= self.opt.warm_up
        ast = self.ast_noise_fn(self.np_rng, iteration)
        with trace.span("trase.loop.fetch"):
            gt = self._gt_image(cam)
        self.state, metrics = T.gaussian_phase_step(
            self.state, cam.to_render_camera(self.device),
            gt, cam.fid, ast, self.lr_at(iteration),
            self.bg_color, deform_net=self.deform_net,
            sh_degree=self.active_sh_degree, use_deform=use_deform,
            is_6dof=self.args.is_6dof, lambda_dssim=self.opt.lambda_dssim,
            lambda_reg_deform=self.opt.lambda_reg_deform,
            raster_cfg=self.raster_cfg)
        self.step_calls += 1
        self.skipped = self.skipped + (~metrics["finite"]).to(torch.int32)
        return metrics

    def _feature_step(self, cam, iteration):
        """One FEATURE step, or None when the camera has no masks."""
        with trace.span("trase.loop.fetch"):
            entry = self._masks_for(cam)
        if entry is None:
            return None
        opt = self.opt
        smooth = self._get_smooth_map() if opt.smooth_K != 1 else None
        self.state, metrics = T.feature_phase_step(
            self.state, cam.to_render_camera(self.device), *entry, cam.fid,
            self.lr_at(iteration), self.bg_color, smooth,
            deform_net=self.deform_net, sh_degree=self.active_sh_degree,
            use_deform=iteration >= opt.warm_up, is_6dof=self.args.is_6dof,
            contrastive_mode=opt.contrastive_mode, rfn=opt.rfn,
            positive_th=opt.hard_positive_th,
            negative_th=opt.hard_negative_th,
            num_sampled_pixels=opt.num_sampled_pixels,
            num_sampled_masks=opt.num_sampled_masks,
            raster_cfg=self.raster_cfg,
            # the reference gates add_densification_stats on iteration <
            # densify_until_iter (train.py:362-366); past it the step
            # differentiates the features alone (values-only backward)
            with_densify_stats=iteration < opt.densify_until_iter,
            generator=self.feature_gen)
        self.feature_calls += 1
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
        self._smooth_dirty = True
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
        if self.tb:
            self.tb.scalar("overflow/dropped_pairs", dropped, iteration)
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

    def train(self, first_iter: int = 0, testing_iterations=(),
              saving_iterations=(), checkpoint_iterations=(),
              progress: bool = True, on_iteration=None,
              stall_timeout_s: float = 0.0):
        """Iterations first_iter + 1 .. opt.iterations; the mask
        prefetcher, when one was started, is closed however this ends.
        stall_timeout_s > 0 arms the stall watchdog (module docstring)
        for the duration of the call."""
        done = self._start_watchdog(stall_timeout_s)
        try:
            self._train(first_iter, testing_iterations, saving_iterations,
                        checkpoint_iterations, progress, on_iteration)
        finally:
            done.set()
            self._close_prefetcher()
            trace.set_iteration(None)

    def _start_watchdog(self, stall_timeout_s: float) -> threading.Event:
        """Start the stall watchdog when stall_timeout_s > 0; setting the
        returned event stops it."""
        self._heartbeat = time.monotonic()
        done = threading.Event()
        if stall_timeout_s > 0:
            def watch():
                while not done.wait(min(stall_timeout_s / 4, 60.0)):
                    dt = time.monotonic() - self._heartbeat
                    if dt > stall_timeout_s:
                        print(f"\n[watchdog] no iteration completed in "
                              f"{dt:.0f}s (> {stall_timeout_s:.0f}s): the "
                              "device or a collective is presumed hung; "
                              f"exiting with code {STALL_EXIT_CODE}. The "
                              "snapshots and curve written so far stay on "
                              "disk.", flush=True)
                        os._exit(STALL_EXIT_CODE)

            threading.Thread(target=watch, daemon=True,
                             name="stall-watchdog").start()
        return done

    def _train(self, first_iter, testing_iterations, saving_iterations,
               checkpoint_iterations, progress, on_iteration):
        opt = self.opt
        train_cams = self.scene.get_train_cameras()
        has_masks = any(c.masks is not None or c.mask_path
                        for c in train_cams)
        if has_masks:
            self._prepare_mask_meta(train_cams)
        # a run started past the feature warm-up opens in FEATURE, unless
        # a checkpoint restored the phase machine (trase_tpu forces FEATURE
        # there too: ROADMAP.md, Queue 3, reference faults)
        if first_iter >= opt.iterative_opt_interval and \
                first_iter >= opt.warm_up_3d_features and \
                not self._phase_restored:
            self.opt_state.state = T.FEATURE
        iter_bar = None
        if progress:
            try:
                from tqdm import tqdm

                iter_bar = tqdm(range(first_iter, opt.iterations),
                                desc="Training progress")
            except ImportError:
                pass

        stack = self._viewpoint_stack
        t_start = self._log_t = time.time()
        for iteration in range(first_iter + 1, opt.iterations + 1):
            trace.set_iteration(iteration)
            with trace.span("trase.iteration"):
                if iteration % 1000 == 0 and \
                        self.active_sh_degree < self.max_sh_degree:
                    self.active_sh_degree += 1

                ops = self.opt_state
                if iteration >= opt.warm_up_3d_features and has_masks:
                    if ops.iterations > ops.max_iterations:
                        # steps the NaN guard skipped do not count: take
                        # them off before deciding (trase_tpu's
                        # retro-correction)
                        skipped = int(self.skipped)
                        self.opt_state.iterations = max(
                            0, self.opt_state.iterations
                            - (skipped - self._skipped_seen))
                        self._skipped_seen = skipped
                    if self.opt_state.switch():
                        stack[:] = train_cams
                        if self.opt_state.state == T.FEATURE:
                            self._smooth_dirty = True

                if not stack:
                    stack[:] = train_cams
                if self._next_cam is not None:
                    cam = self._next_cam
                else:
                    cam = stack.pop(int(self.np_rng.integers(0, len(stack))))
                # trase_tpu pre-draws the next view here (to prefetch its
                # masks); drawing it at the same point keeps the same views
                if stack:
                    self._next_cam = stack.pop(
                        int(self.np_rng.integers(0, len(stack))))
                    if has_masks:
                        self._submit_mask_prefetch(self._next_cam)
                else:
                    self._next_cam = None

                metrics = None
                if self.opt_state.state == T.FEATURE and has_masks:
                    metrics = self._feature_step(cam, iteration)
                if metrics is None:
                    metrics = self._gaussian_step(cam, iteration)
                self.opt_state.step()
                if iteration % 10 == 0:
                    # the reads of the step's metrics wait for the device
                    with trace.span("trase.loop.read_metrics"):
                        self._read_metrics(iteration, metrics, iter_bar)

                if iteration in testing_iterations:
                    cur = self.evaluate(iteration)
                    if cur > self.best_psnr:
                        self.best_psnr = cur
                        self.best_iteration = iteration

                if iteration in saving_iterations:
                    self.save_snapshot(iteration)

                # densification (train.py:361-373)
                if iteration < opt.densify_until_iter:
                    if iteration > opt.densify_from_iter and \
                            iteration % opt.densification_interval == 0:
                        with trace.span("trase.loop.densify"):
                            self._densify(iteration)
                    if iteration % opt.opacity_reset_interval == 0 or (
                            self.args.white_background
                            and iteration == opt.densify_from_iter):
                        self._reset_opacity()

                if iteration in checkpoint_iterations:
                    self.save_ckpt(iteration)

            if on_iteration is not None:
                on_iteration(self, iteration, metrics)
            self._heartbeat = time.monotonic()

        if iter_bar:
            iter_bar.close()
        if self.tb and self.tb.writer is not None:
            self.tb.writer.flush()
        dt = time.time() - t_start
        n_iters = opt.iterations - first_iter
        skipped = int(self.skipped)
        if skipped:
            print(f"[train] {skipped} non-finite steps skipped")
        print(f"Best PSNR = {self.best_psnr} in Iteration "
              f"{self.best_iteration}")
        if n_iters > 0:
            print(f"[timing] {n_iters} iters in {dt:.1f}s = "
                  f"{n_iters / dt:.2f} it/s")

    def train_style(self, vgg, ref_feats: torch.Tensor,
                    style_mask: torch.Tensor, first_iter: int,
                    last_iter: int, saving_iterations=(),
                    progress: bool = True, on_iteration=None):
        """NNFM style fine-tuning, iterations first_iter + 1 .. last_iter
        (the style CLI's loop): each draws a view from ``np_rng`` popping
        the view stack (refilled from the train cameras when empty) and
        takes one ``style_phase_step`` against ``ref_feats`` (the style
        image's features at the layer ``vgg`` was built for), changing
        the colours of the rows of ``style_mask`` alone; a step the NaN
        guard skipped counts in ``skipped``. The loss EMA
        stays on the device and is read every 10 iterations (the span
        ``trase.loop.read_metrics``) into ``ema_loss``, and once more at
        the end; snapshots at ``saving_iterations``;
        ``on_iteration(trainer, iteration, metrics)`` after each. Each
        iteration is the span ``trase.iteration``."""
        cams = self.scene.get_train_cameras()
        stack = self._viewpoint_stack
        fx_key = vgg.layer_names[0]
        ema = torch.full((), float(self.ema_loss), device=self.device)
        bar = None
        if progress:
            try:
                from tqdm import tqdm

                bar = tqdm(range(first_iter, last_iter), desc="Style transfer")
            except ImportError:
                pass
        try:
            for iteration in range(first_iter + 1, last_iter + 1):
                trace.set_iteration(iteration)
                with trace.span("trase.iteration"):
                    if not stack:
                        stack[:] = cams
                    cam = stack.pop(int(self.np_rng.integers(0, len(stack))))
                    self.state, metrics = T.style_phase_step(
                        self.state, cam.to_render_camera(self.device),
                        ref_feats, style_mask, cam.fid,
                        self.lr_at(iteration), self.bg_color,
                        deform_net=self.deform_net, vgg_ext=vgg,
                        sh_degree=self.active_sh_degree, use_deform=True,
                        is_6dof=self.args.is_6dof, fx_key=fx_key,
                        raster_cfg=self.raster_cfg)
                    self.skipped = self.skipped + (
                        ~metrics["finite"]).to(torch.int32)
                    ema = torch.where(metrics["finite"],
                                      0.4 * metrics["loss"] + 0.6 * ema, ema)
                    if iteration % 10 == 0:
                        with trace.span("trase.loop.read_metrics"):
                            self.ema_loss = float(ema)
                        if bar is not None:
                            bar.set_postfix({"Loss": f"{self.ema_loss:.3f}"})
                            bar.update(10)
                    if iteration in saving_iterations:
                        self.save_snapshot(iteration)
                if on_iteration is not None:
                    on_iteration(self, iteration, metrics)
            self.ema_loss = float(ema)
        finally:
            if bar is not None:
                bar.close()
            trace.set_iteration(None)

    def _read_metrics(self, iteration: int, metrics: dict, iter_bar):
        """Every 10th iteration: the loss and the skipped steps (progress
        bar, TensorBoard) and, every 100th, the pair budget's check."""
        if iteration % 100 == 0:
            over = metrics["overflow"], metrics["overflow_half"]
            self._handle_overflow(iteration, *[float(x) for x in over])
        loss, skipped = float(metrics["loss"]), int(self.skipped)
        self.ema_loss = 0.4 * loss + 0.6 * self.ema_loss
        if self.tb:
            self._log_scalars(iteration, metrics, loss)
        if iter_bar:
            iter_bar.set_postfix({"Loss": f"{self.ema_loss:.3f}",
                                  "State": self.opt_state.state,
                                  "Points": self._n_alive_cache,
                                  "Skipped": skipped})
            iter_bar.update(10)

    def _log_scalars(self, iteration: int, metrics: dict, loss: float):
        """TensorBoard's per-step scalars (trase_tpu loop.py:683-690), at
        the iterations where the loop reads the step's metrics anyway
        (every 10th): the losses of that step, and the wall time per
        iteration since the last log."""
        if "l1" in metrics:
            self.tb.scalar("train_loss_patches/l1_loss",
                           float(metrics["l1"]), iteration)
        self.tb.scalar("train_loss_patches/total_loss", loss, iteration)
        now = time.time()
        self.tb.scalar("iter_time", (now - self._log_t) * 100.0, iteration)
        self._log_t = now

    # ------------------------------------------------------------- eval

    def evaluate(self, iteration: int) -> float:
        """Fixed-index test / train PSNR report (trase_tpu loop.py:729-764,
        reference train.py:421-495): views 5, 10, ... 25 (mod the split's
        size) of each split, clipped to [0, 1]; prints each split's mean
        L1 and PSNR and returns the test split's mean PSNR (0 without test
        views)."""
        test_psnr = 0.0
        configs = (("test", self.scene.get_test_cameras()),
                   ("train", self.scene.get_train_cameras()))
        for name, cams in configs:
            if not cams:
                continue
            psnrs, l1s = [], []
            for cam in (cams[i % len(cams)] for i in range(5, 30, 5)):
                img = torch.clamp(self.render_view(cam), 0.0, 1.0)
                gt = torch.clamp(self._gt_image(cam), 0.0, 1.0)
                psnrs.append(float(psnr(img[None], gt[None]).mean()))
                l1s.append(float(torch.abs(img - gt).mean()))
            mean_psnr = float(np.mean(psnrs))
            print(f"\n[ITER {iteration}] Evaluating {name}: "
                  f"L1 {np.mean(l1s):.6f} PSNR {mean_psnr:.3f}")
            if self.tb:
                self.tb.scalar(f"{name}/loss_viewpoint - l1_loss",
                               float(np.mean(l1s)), iteration)
                self.tb.scalar(f"{name}/loss_viewpoint - psnr", mean_psnr,
                               iteration)
            if name == "test":
                test_psnr = mean_psnr
        n_alive = self._num_alive()
        if self.tb:
            self.tb.scalar("total_points", n_alive, iteration)
        return test_psnr

    @torch.no_grad()
    def render_view(self, cam) -> torch.Tensor:
        """(3, H, W) eval render of one camera (trase_tpu loop.py:766-801):
        the deform net always on, its hidden stack in bf16, no AST noise,
        no features."""
        p = self.state.params
        d = T.apply_deform(self.deform_net, self.state.deform, p.xyz,
                           cam.fid, 0.0, True, p.gaussian_features)
        return render(cam.to_render_camera(self.device), p,
                      self.state.aux.alive, self.bg_color, *d,
                      is_6dof=self.args.is_6dof,
                      sh_degree=self.active_sh_degree, with_features=False,
                      raster_cfg=self.raster_cfg)["render"]

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
        deform/iteration_N/deform.pkl, as trase_tpu writes them: the
        features KNN-smoothed over every neighbour slot (no dropout) when
        smooth_K != 1. The neighbours are those of the saved xyz: a map
        of its own, where trase_tpu reuses the FEATURE steps' map."""
        print(f"\n[ITER {iteration}] Saving Gaussians")
        smoothed = None
        if self.opt.smooth_K != 1:
            # on the device, also where the state is on the host
            p = self.state.params
            with torch.no_grad():
                smoothed = smooth_features(
                    p.gaussian_features.to(self.device),
                    transpose_smooth_map(build_feature_smooth_map(
                        p.xyz.to(self.device),
                        max(int(self.opt.smooth_K), 1))))
        self.scene.save(iteration, self.state.params, self.state.aux.alive,
                        smoothed_features=smoothed)
        deform_dir = os.path.join(self.args.model_path, "deform",
                                  f"iteration_{iteration}")
        save_checkpoint(os.path.join(deform_dir, "deform.pkl"),
                        {"vars": self.deform_variables(),
                         "type": getattr(self.opt, "deform_type",
                                         "DeformNetwork")})


    # ------------------------------------------------------- checkpoints

    def save_ckpt(self, iteration: int):
        """<model_path>/chkpnt<iteration>.pkl: the run's state (module
        docstring), written to a temporary file and renamed."""
        print(f"\n[ITER {iteration}] Saving Checkpoint")
        save_checkpoint(
            os.path.join(self.args.model_path, f"chkpnt{iteration}.pkl"),
            {
                "state": T.train_state_to_numpy(self.state),
                "schema": T.state_schema(self.state),
                "iteration": iteration,
                "active_sh_degree": self.active_sh_degree,
                "opt_state": (self.opt_state.state,
                              self.opt_state.iterations),
                "generators": {
                    "np_rng": self.np_rng.bit_generator.state,
                    "densify_gen": self.densify_gen.get_state().numpy(),
                    "feature_gen": self.feature_gen.get_state().numpy(),
                    "feature_gen_device": self.feature_gen.device.type,
                },
                "skipped": (int(self.skipped), self._skipped_seen),
                "viewpoint_stack": [c.image_name
                                    for c in self._viewpoint_stack],
                "next_cam": None if self._next_cam is None
                else self._next_cam.image_name,
            })

    def load_ckpt(self, path: str) -> int:
        """Restore a checkpoint; returns its iteration. ``.pth`` is the
        reference's (load_reference_ckpt); a ``.pkl`` is the port's or
        trase_tpu's (its state a TrainState stand-in). The saved keyed
        schema is checked by name against this trainer's state: a field
        missing, unexpected or of another dtype raises ValueError, never a
        positional restore. trase_tpu's checkpoints leave the generators
        and the view stack as they are."""
        if path.endswith(".pth"):
            return self.load_reference_ckpt(path)
        payload = load_checkpoint(path)
        state = payload["state"]
        from_trase_tpu = hasattr(state, "_fields")
        tmpl_schema = T.state_schema(self.state)
        saved_schema = payload.get("schema")
        if saved_schema is not None:
            saved_schema = [(_keyed(p) if from_trase_tpu else p, d)
                            for p, d in saved_schema]
            saved, tmpl = dict(saved_schema), dict(tmpl_schema)
            if saved != tmpl:
                missing = [p for p in tmpl if p not in saved]
                extra = [p for p in saved if p not in tmpl]
                dtype_diff = [(p, saved[p], tmpl[p]) for p in tmpl
                              if p in saved and saved[p] != tmpl[p]]
                raise ValueError(
                    f"checkpoint schema mismatch loading {path}: missing "
                    f"fields {missing or 'none'}, unexpected fields "
                    f"{extra or 'none'}, dtype changes "
                    f"{dtype_diff or 'none'}. The checkpoint was written "
                    "by a different TrainState layout; refusing to load "
                    "it.")
        else:
            warnings.warn(f"{path} carries no keyed schema; its fields are "
                          "restored by name unchecked")
        self.state = T.train_state_from_numpy(state, self._global_device())
        self.active_sh_degree = int(payload["active_sh_degree"])
        self.opt_state.state, self.opt_state.iterations = \
            payload["opt_state"]
        self._phase_restored = True
        gens = payload.get("generators")
        if gens is not None:
            self.np_rng.bit_generator.state = gens["np_rng"]
            self.densify_gen.set_state(torch.from_numpy(gens["densify_gen"]))
            if gens["feature_gen_device"] == self.feature_gen.device.type:
                self.feature_gen.set_state(
                    torch.from_numpy(gens["feature_gen"]))
            else:
                warnings.warn(
                    f"{path}: feature_gen was a {gens['feature_gen_device']}"
                    f" generator, this run's is on "
                    f"{self.feature_gen.device.type}: its stream starts "
                    "afresh")
        if "skipped" in payload:
            skipped, self._skipped_seen = payload["skipped"]
            self.skipped = torch.tensor(skipped, dtype=torch.int32,
                                        device=self.device)
        if "viewpoint_stack" in payload:
            by_name = {c.image_name: c
                       for c in self.scene.get_train_cameras()}
            self._viewpoint_stack = [by_name[n]
                                     for n in payload["viewpoint_stack"]]
            self._next_cam = by_name.get(payload["next_cam"])
        self._postload()
        return int(payload["iteration"])

    def load_reference_ckpt(self, path: str) -> int:
        """Resume from a reference ``chkpnt<N>.pth`` (train.py:396, the
        gaussians.capture() tuple). It holds no deform weights (the
        reference's restore omits them too): the deform net keeps its
        state; bring a snapshot's weights through
        tools/import_torch.py: import_deform_pth."""
        from ..tools.import_torch import import_chkpnt_pth

        params, aux, opt, meta = import_chkpnt_pth(
            path, device=self._global_device())
        self.state = self.state._replace(params=params, aux=aux, opt=opt)
        self.active_sh_degree = int(meta["active_sh_degree"])
        self._postload()
        return meta["iteration"]

    def _postload(self):
        """After a load: the smoothing map and the alive count are the
        loaded state's."""
        self._smooth_dirty = True
        self._n_alive_cache = self._num_alive()
