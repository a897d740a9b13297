#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (trase_tpu_torch) on one card.

    python3 chip_smoke.py            # from the repository root

Drives the port's serving and training paths on the card and prints one
JSON line per phase:

1. device       the card's name and power limit (nvidia-smi), torch's view;
2. build        nvcc builds csrc/*.cu for sm_90a, one process per source,
                all started together; build seconds and ptxas lines;
   fwd-sass     cuobjdump of the forward's library: its SASS saved beside
                it (<library>.sass, named in the row); per instantiation its
                registers and spill bytes (a spill fails), and the SASS
                instructions of its compositing loop per evaluated and
                per contributing pair-pixel, and its MUFU instructions;
   bwd-res      the backward library's registers, stack, spill and shared
                bytes for each of its 10 composite_bwd instantiations and
                the two reduces (a spill fails);
3. compare      the CUDA compositor against its plain PyTorch version
                (composite_plain) on the same inputs, bit for bit, for 4
                values (rgb+depth), 36 (+32 features) and 36 with
                bf16-packed features, and for the FEATURE step's 32
                features alone, unpacked and packed, with and without
                residual outputs, at a small random scene and at the full
                scene of phase 4; plus the small scene's render against
                the all-pairs oracle; at the full scene the kernel's median
                and range of 5 interleaved rounds of 20 queued launches,
                its host-paced time, the bound, and the issue floor (the
                loop's SASS instructions over 4 warp-instructions per SM
                per clock) and MUFU floor (16 per SM per clock) of this
                scene's evaluated and contributing pair-pixels;
   compare-bwd  the forward's residual outputs, the backward kernel
                (composite_bwd) and the reduce kernel (reduce_pair_grads)
                against their plain versions on the same inputs and
                cotangent, with errors per column group, and the log T the
                reverse walk reconstructs at each tile's first pair against
                log 1 = 0, for every layout in both modes, full and
                values-only (geometry exactly 0, values bit for bit the
                full mode's), at both scenes: 4 values (rgb + depth), 32
                features alone and 36 (colour beside the features, a
                42-word gradient row), these two unpacked and packed;
                each kernel launched twice (bit-identical); at the full
                scene the median and range of 5 rounds of 20 launches each
                (device time, queued behind a sleep kernel; the reduce and
                index_add_ interleaved, also paced by the host), the
                bounds, and the backward's shuffle floor from its 8-pair
                sub-batches (beside that of a warp-wide all-reduce per
                word, from the (pair, warp) steps with a counted lane);
   deform-mlp   the fused deform MLP kernel (deform_mlp) against its plain
                version and the float32 module at 300 rows and at the
                bench scene's 131072, relaunched bit for bit; its
                registers and spill bytes (cuobjdump; a spill fails); at
                131072 the median and range of 5 interleaved queued rounds
                of the kernel, the cuBLAS bf16 chain, the chain's bare
                products and, with --mlp-parent, an earlier source of the
                kernel built beside it; the host-paced time, the plain
                version's and the module's, the bound, and the weights'
                packing uncached (pack_ms) and cached (pack_cached_ms);
4. render       the bench scene of bench.py (100k gaussians in a 131072
                capacity, SH degree 3, 32-dim features, DeformNetwork
                8x256, 1008x1344, K=6, seeded): deform_step ->
                renderer.render with and without features, warm-up then
                timed frames; checks the outputs and that the compositor
                kernel ran once per render; then the same frame with
                deform_step(fused=True): one deform_mlp launch per frame,
                its time and its image against the float32-deform frame,
                and its time when the weights are repacked every frame
                (frame_ms_fused_repack, the cache dropped before each);
                then frames under autograd through rasterize_tiled for
                each backward instantiation no training step launches
                (36 values packed and unpacked, full and values-only; 4
                values values-only), counted: the packed full frame's
                gradients in every projected input against the plain
                versions' on the card within BWD_TOL, each values-only
                frame's geometry exactly 0 and its value gradients bit for
                bit its full frame's;
5. cli          writes a small Blender-format dataset and a model
                directory with the port's own writers and runs
                trase_tpu_torch.render;
   segment-cli  on phase 5's dataset and a copy of its model directory
                with a feature field grouped by position: the cluster CLI
                (k-means on the card; HDBSCAN where sklearn is installed),
                the render CLI with --segment_ids and --text_prompt_mask,
                and the metrics CLI against a benchmark folder written from
                the dataset's masks; PNG counts, launches per view, finite
                metrics;
   kmeans       kmeans_cluster on the bench scene's 100k x 32 features,
                k = 64, 50 iterations, on the card;
6. train-step   the same scene through engine.trainer.gaussian_phase_step
                (bf16 deform stack on, lambda_dssim 0.2, gt zeros): warm-up
                then timed steps; checks finiteness, a falling loss and
                one launch of each kernel per step; the per-stage split;
   feature-step the same scene through engine.trainer.feature_phase_step
                (bf16 deform stack, 32 features KNN-smoothed over K=16
                slots with dropout 0.5, soft mode, 4096 pixels, 8 seeded
                masks at 504x672), both arms (densify stats / values-only):
                warm-up then timed steps; checks finiteness, which fields
                changed and one launch of each kernel per step in the
                features-only instantiation (and of the smoothing's
                backward); the smoothing map's build and transpose time
                and the per-stage split; then the smoothing's backward
                (csrc/smooth_rows_bwd.cu) at the n3v benchmark's map,
                262144 rows x 16 slots, 8 drawn, 32 features, 62144 dead
                rows tied at the origin: equal to its plain version and
                to itself on a second call, within 1e-5 of a float64 sum
                (autograd's index backward's error beside it), its queued
                ms for each hub chunk length in SMOOTH_BWD_CHUNKS beside
                index_add_ and autograd's gather-mean backward, the bytes
                bound, the transpose's ms and the in-degree histogram;
7. train-cli    trase_tpu_torch.train on phase 5's dataset (with masks),
                with densify and opacity reset inside the run, crossing
                warm_up_3d_features into FEATURE blocks in both arms, then
                trase_tpu_torch.render on its snapshot;
   synthetic    data/synthetic.py's write_synthetic_dataset at 256x256,
                the fast GT (the compositor kernel, two launches a view)
                against the oracle GT: PNGs within two 8-bit levels, masks
                differing on at most 0.5 % of pixels, the same JSON and
                points3d.ply; then the fast GT at 1008x1008, seconds per
                view and launches;
   resume       on a dataset the writer wrote (8 train, 2 test views at
                256x256, n_times rig, masks): the train CLI to 2M with
                --checkpoint_iterations M, past warm_up_3d_features; a run
                with --start_checkpoint chkpntM.pkl to 2M, with
                --profile_iters over 3 of its iterations. The loaded state,
                Adam moments, phase machine and generator states equal the
                saved bit for bit; the resumed run's compositor launches
                match iterations M+1..2M; its final test PSNR lies within
                a stated band of the uninterrupted run's; the trace names
                the three compositor kernels; save_ckpt and load_ckpt
                seconds and the checkpoint's MB;
   viewer       trase_tpu_torch.viewer.HeadlessViewer on the bench scene
                at 1344x1008 (its feature field grouped by octant, k-means
                k 64 on the card, the orbit camera on the cloud): each of
                the seven modes, warm-up then timed frames (last_frame_ms,
                FPS, compositor launches a frame: one in every mode); the
                Render frame's kernel output against composite_plain bit
                for bit; orbit / scale / pan move the frame; click_select,
                the removal frame, save_object -> load_object ->
                render_composite_frame (scaled, rotated, moved: one launch,
                its kernel output bit for bit, its ms); the trajectory
                overlay (cv2 or the numpy fallback); then the click
                workflow on the segment-cli phase's 2000-gaussian model
                directory on the card and on the CPU: the same cluster id
                and selection mask, frames within TOL_RENDER;
   viewer-web   viewer_web.ViewerServer over that viewer on 127.0.0.1:
                ms per GET /frame.jpg; after orbit, mode, click, removal
                and clear, the served JPEG equals a JPEG of render_frame
                at the same state; the trajectory toggles; the server
                shuts down;
   mask-io      native.py builds native/trase_io.cpp (it must); 8 cameras'
                masks, 32 each, in the native .npz format at 504x672 and
                1008x1344: ms per stack of load_padded_masks through the
                numpy path and the native path (bit-identical) and of
                load_stack's decode to page-locked bits;
                rgba_to_rgb_f32 against the PIL + numpy load at
                1008x1344; the mask unpack kernel (csrc/mask_unpack.cu)
                at the n3v benchmark's stack, 64 masks of 1200x1600 into
                M_max 64, equal to its plain version on the same bits on
                the card, its queued ms beside the plain version's, the
                bound and the bits' upload from page-locked memory;
                FEATURE steps of the train CLI with the masks read from
                disk and a mask cache of one stack, with the prefetcher
                and inline: ms per step waited on the prefetcher against
                the inline decode's (load_stack: since the bits path, a
                decode that stops at the page-locked bits, no longer the
                float32 stack), each arm's mask_fetch counts (every miss
                "bits", one unpack launch each);
   style        engine.trainer.style_phase_step on the bench scene: VGG16
                (seeded fallback) conv4_1 against a seeded 1008x1344 style
                image of flat tiles and texture, one octant of the cloud
                styled, bf16 deform stack: warm-up then timed steps (host
                clock and CUDA events), the split (deform, render forward,
                VGG forward, NNFM, backward: compositor and VGG, Adam +
                stats + guard), peak memory, a falling loss; one launch per
                step of the 4-value forward with residuals, its backward and
                the 10-word reduce; only the styled rows' colours, their
                Adam state and the densify statistics change; then one step
                on phase 3's small scene through the kernels against the
                same step through their plain versions on the card; the
                VGG's forward and input gradient alone with cuDNN's
                heuristic algorithms and with cudnn.benchmark on;
   style-cli    trase_tpu_torch.train_style_transfer_nnfm on a copy of the
                segment-cli model directory (its k-means clusters as
                clusters.pt), the largest cluster styled for 20 iterations,
                then the render CLI on the snapshot: s per iteration, one
                launch of each compositor kernel per iteration, only the
                object's colours moved;
   lpips        the metrics CLI with --vgg_weights (a seeded VGG16 .npz in
                trase_tpu's format) and seeded heads on the segment-cli
                outputs, on the card and with --device cpu (equal within
                LPIPS_TOL); ms per make_lpips call on a 1008x1344 pair;
   losses-3d    losses/losses_3d.py's four losses on the bench scene's
                131072 rows: ms and finiteness; card against CPU on a
                4096-row subset with the draws injected;
   mesh-slabs   the compositor kernels' slab mode (the multi-device
                steps') at the bench scene, its 63 tile rows padded to 64
                and split in 4 slabs, for the GAUSSIAN layout (4 values)
                and the FEATURE layout (32 packed, features alone), with
                residuals: each slab's forward bit for bit against the
                plain slab, the slabs concatenated bit for bit against the
                whole image; each slab's backward within BWD_TOL of its
                plain version and its pair rows bit for bit against the
                whole image's, its reduce bit for bit against the plain
                version and against the whole image's reduce kernel run
                over the slab's range; the slabs' payload gradients
                summed against the whole image's within SLAB_SUM_TOL;
                each slab's kernel ms beside the whole image's, the whole
                image's reduce kernel over the slab's range and
                index_add_ over the slab's pairs (queued medians), the
                bounds, slab 0's plain ms;
   mesh         the multi-device path on the one card: a world of one over
                NCCL in this process, the sharded GAUSSIAN and FEATURE
                (smoothing on) steps at the bench scene, counted (one
                launch of each slab kernel a step, exactly), against the
                single-device steps from the same state (loss equal,
                params and moments within MESH_STEP_TOL), step ms from
                CUDA events beside the single steps', the device's idle
                share, the peak device memory of each step; then
                trase_tpu_torch.train --mesh 1 as torchrun starts it
                (WORLD_SIZE=1, a TCP store on localhost) on phase 5's
                dataset through both phases, counted (every compositor
                launch in slab mode, one of each kernel a step, exactly),
                its peak device memory beside the same flags' on one
                device, its checkpoint loaded in a single-device run bit
                for bit; the same CLI spawning its rank (a subprocess);
                --mesh 2, which must exit non-zero at once naming the
                device count;
   convert      the interop tools: synthetic Neu3D videos (4 cameras at
                64x96, cv2) -> trase_tpu_torch.neu3d2blender
                --random_points; label maps -> trase_tpu_torch.
                extract_masks --from_dir into the scene's masks/, read
                back by data/masks.py; trase_tpu_torch.train on the card
                through both phases on that scene (60 iterations,
                counted) to a finite test PSNR; the render CLI with
                --text_prompt beside --text_prompt_mask (Grounded-SAM
                absent: the warning, and text-prompt objects byte for
                byte a run with the mask alone's); seconds for each;
   scale        the production-scale validation tool (python -m
                trase_tpu_torch.tools.validate_scale, in this process) at
                1008 px on the multi-view rig (2 cameras x 6 timestamps,
                1 held-out camera x 6), 300 iterations with FEATURE from
                150 (the 32 features unpacked, the tool's default), one
                milestone at 150: two curve lines with a finite test PSNR,
                the alive count above its start, both snapshots on disk,
                each line unscored exactly when scikit-learn is absent;
                seconds, it/s and PSNR, counted;
8. profile      torch.profiler over a few frames of phase 4 (float32 and
                fused deform), of the viewer's Render mode, and a few steps
                of phase 6, of each FEATURE arm and of the style step:
                device busy time by kernel and the idle share;
9. kernels      one object per kernel: launches, error against the plain
                version, times and the bound, with one variant per
                instantiation a path launches; the mask unpack's launches
                are the mask-io phase's training runs'.

    python3 chip_smoke.py --mlp-parent OLD.cu   # also times OLD.cu, an
                                                # earlier deform_mlp.cu

The last two lines are the nvidia-smi name/power-limit line and
{"ok": true, "device": {...}}. Any failed check raises: the script then
exits non-zero without that line. Without a CUDA device, or without the
package beside it, it exits non-zero at once.
"""
from __future__ import annotations

import ctypes
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the H100's published peaks and the least time of counted work, as the
# benchmark computes them
from port_bench.counts.bounds import (BF16_FLOPS_PER_S, F32_FLOPS_PER_S,
                                      HBM_BYTES_PER_S, bound, mlp_bound)

# forward kernel vs plain: the same expressions in the same order, built
# with -fmad=false: image, log T and stop index bit for bit
FWD_TOL = 0.0
# backward kernel vs plain: same per-pixel terms, 256-pixel sums in
# another order: max abs difference over each column group's largest
# magnitude. The reduce kernel sums in the plain version's order: exact.
BWD_TOL = 1e-4
LOGT_FIRST_TOL = 1e-3  # |T reconstructed at a tile's first pair - 1|
# the backward's shuffle floor, a model beside its time: one warp-wide
# shuffle per SM per clock (CUDA C Programming Guide, arithmetic throughput
# table, cc 9.0), 132 SMs at the H100 SXM's 1.98 GHz boost clock; the
# kernel's pairs per staged batch and per product sub-batch, warps per tile
SMS, SM_CLOCK_HZ = 132, 1.98e9
BWD_BATCH, BWD_SUB, BWD_WARPS = 64, 8, 8
# repeated kernel timing: rounds, launches per round; a sleep kernel of
# ~20 ms at 1.98 GHz holds the stream while the host enqueues a round
TIMING_REPS, TIMING_ITERS, SLEEP_CYCLES = 5, 20, 40_000_000
# the fused deform MLP: bf16 operands with float32 sums in another order
# than the plain version's, so activations near a bf16 rounding boundary
# round the other way: max abs difference over each head's largest
# magnitude; both against the float32 module within the budget of
# tests/test_rasterize_pallas.py::test_fused_deform_matches_flax
MLP_TOL, MLP_MODULE_TOL = 1e-2, 2e-2
MLP_HEADS = ("d_xyz", "d_rot", "d_scale")
# the C interface of the first, wmma design of deform_mlp.cu, for
# --mlp-parent: emb, n, in_dim, kin, w0, ws_in, w_hidden, bias, wh, bh,
# d_xyz, d_rot, d_scale, stream
PARENT_MLP_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 10)
WARMUP, FRAMES = 3, 10
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
CLI_ITERATIONS = 300
# the bench scene of bench.py:110-130
N_GAUSSIANS, CAPACITY, HEIGHT, WIDTH = 100_000, 131072, 1008, 1344
# the FEATURE step of bench.py:176-191: 8 masks at half resolution, 4096
# sampled pixels, soft mode; smoothing on, as training runs it
FEATURE_MASKS, FEATURE_PIXELS, SMOOTH_K = 8, 4096, 16
# the smoothing's backward at the n3v benchmark's map: its capacity, dead
# slots tied at the origin and features; live rows in SMOOTH_BWD_BLOBS
# seeded blobs away from the origin; the hub chunk lengths timed
SMOOTH_BWD_ROWS, SMOOTH_BWD_DEAD, SMOOTH_BWD_FEATURES = 262144, 62144, 32
SMOOTH_BWD_BLOBS, SMOOTH_BWD_CHUNKS = 48, (64, 128, 256, 512, 1024)
# the train CLI's FEATURE schedule: GAUSSIAN 1-149, FEATURE 150-199
# (densify stats), GAUSSIAN 200-249, FEATURE 250-299 (stats to 259, then
# values-only), GAUSSIAN 300
CLI_FEATURE_FROM, CLI_INTERVAL, CLI_DENSIFY_UNTIL = 150, 49, 260
# the forward's instantiations in its mangled names: composite_fwd_kernel
# <n_val, n_packed, with_color, residuals>
FWD_KERNEL_RE = re.compile(
    r"composite_fwd_kernelILi(\d+)ELi(\d+)ELb([01])ELb([01])E")
# and the backward's: composite_bwd_kernel<n_val, n_packed, with_color,
# values_only>
BWD_KERNEL_RE = re.compile(
    r"composite_bwd_kernelILi(\d+)ELi(\d+)ELb([01])ELb([01])E")
KERNELS = {
    "composite_fwd": ("trase_tpu_torch/csrc/composite_fwd.cu",
                      "trase_tpu/ops/rasterize_pallas.py:590"),
    "composite_bwd": ("trase_tpu_torch/csrc/composite_bwd.cu",
                      "trase_tpu/ops/rasterize_pallas.py:817"),
    "reduce_pair_grads": ("trase_tpu_torch/csrc/composite_bwd.cu",
                          "trase_tpu/ops/rasterize_pallas.py:1195"),
    "deform_mlp": ("trase_tpu_torch/csrc/deform_mlp.cu",
                   "trase_tpu/ops/mlp_pallas.py:41"),
    "mask_unpack": ("trase_tpu_torch/csrc/mask_unpack.cu", "none"),
    "smooth_rows_bwd": ("trase_tpu_torch/csrc/smooth_rows_bwd.cu", "none"),
}
# k-means at scale: the bench scene's features, the cluster CLI's k
KMEANS_K, KMEANS_ITERS = 64, 50
# the segment CLI's k-means on phase 5's 2000 gaussians, grouped in 4
SEGMENT_K = 8
# the synthetic writer: fast GT against the oracle GT, then (train, test)
# views at 1008x1008. Masks: tests/test_torch_synthetic.py's 0.5 %. PNGs:
# 2 levels, not that test's 1 (32x32, where they are equal): at 256x256 a
# few pixels per view lie just outside a gaussian's exact-support rect
# with alpha just above 1/255, which the tiled compositor culls and the
# oracle composites (the culling behind tests/test_rasterize_pallas.py's
# 2e-3 oracle bound; tests/test_torch_synthetic.py checks 2 at 256x256)
SYN_PNG_LEVELS, SYN_MASK_SHARE = 2, 0.005
SYN_SIZE, SYN_BIG_SIZE, SYN_BIG_VIEWS = 256, 1008, (4, 1)
# resume: a checkpoint at M of a 2M run at RESUME_SIZE; GAUSSIAN 1-29, then
# FEATURE and GAUSSIAN blocks of 15 from 30 (FEATURE 60-74: the checkpoint
# falls in one); the trace over iterations 91-93 of the resumed run. The
# band of its final test PSNR against the uninterrupted run's: the card's
# smoothing-gather backward (index_put with accumulate, atomics) sums the
# FEATURE steps' feature gradients in no fixed order, and through the
# densify statistics a difference can reach the gaussians' colours.
RESUME_M, RESUME_FEATURE_FROM, RESUME_PROFILE_FROM = 60, 30, 90
RESUME_SIZE = 256
RESUME_PSNR_BAND = 0.5
GEOM_GROUPS = {"mean2d": (0, 2), "conic": (2, 5), "log_op": (5, 6)}
# the viewer on the bench scene: the orbit camera's target (the cloud's
# centre) and distance, k-means clusters, frames per mode; the card-vs-CPU
# click workflow at 128x128, frames within tests/test_torch_render.py's
# TOL["render"] (the same weights, sums associated differently)
VIEWER_TARGET, VIEWER_RADIUS, VIEWER_K = (0.0, 0.0, 4.0), 7.0, 64
VIEWER_WARMUP, VIEWER_FRAMES, VIEWER_CPU_SIZE = 2, 5, 128
TOL_RENDER = 2e-4
# the style step at full width: VGG16 (seeded fallback) conv4_1 against a
# seeded 1008x1344 style image, one octant of the cloud styled; timed
# steps after TRAIN_WARMUP. Kernels against plain on phase 3's small
# scene: the colours' Adam moments within STYLE_TOL of their scale (the
# backward's 256-pixel sums, BWD_TOL per column group, then Adam's
# division by sqrt(nu)). The style CLI's iterations on the segment-cli
# model. LPIPS card against --device cpu; the 3D losses card against CPU
# on a subset (tests/test_torch_losses_3d.py's tolerances).
STYLE_KEY, STYLE_OCTANT, STYLE_STEPS, STYLE_TOL = "conv4_1", 7, 10, 1e-3
STYLE_CLI_ITERATIONS = 20
LPIPS_TOL = 1e-4
LOSS3D_SUBSET, LOSS3D_TOL, RIGID_TOL = 4096, 1e-5, 1e-4
# the multi-device path on one card: the bench scene's 63 tile rows
# padded to 64 and split in 4 slabs of 16 rows; the slabs' payload
# gradients summed against the whole image's (the same pair rows, the
# K-row sums associated per slab: f32 sum order); a world of one's steps
# against the single-device steps (tests/test_torch_parallel.py's CPU
# tolerance for params and moments); the --mesh 1 CLI's iterations
MESH_SLABS, SLAB_SUM_TOL, MESH_STEP_TOL = 4, 1e-5, 1e-5
MESH_CLI_ITERATIONS = 60
# the launch keys of one sharded GAUSSIAN step and one FEATURE step
MESH_SLAB_KEYS = ("composite_fwd/4/0/1/1/slab", "composite_bwd/4/0/1/0/slab",
                  "reduce_pair_grads/10/slab", "composite_fwd/32/16/0/1/slab",
                  "composite_bwd/32/16/0/0/slab",
                  "reduce_pair_grads/38/slab", "smooth_rows_bwd")
# the interop tools: synthetic Neu3D videos (tests/test_converters.py's
# size), label-map objects per image, the converted scene's train run
CONVERT_SIZE, CONVERT_CAMS, CONVERT_FRAMES = (64, 96), 4, 4
CONVERT_LABELS, CONVERT_ITERATIONS = 4, 60
# the validation tool's short schedule at full size (its scale is the
# tool's default scene, 5 blobs x 2400 points, cut to 300 iterations)
SCALE_ITERATIONS, SCALE_MILESTONE = 300, 150
SCALE_ARGS = ["--image_size", "1008", "--n_train", "12", "--n_test", "6",
              "--n_times", "6", "--iterations", str(SCALE_ITERATIONS),
              "--feature_warmup_frac", "0.5",
              "--milestones", str(SCALE_MILESTONE),
              "--target_alive", "0", "--densify_until_frac", "0.5"]
SCALE_START_ALIVE = 5 * 2400
# host IO: cameras' SAM-style mask stacks (native .npz) at the bench
# FEATURE step's size and at full size; the loop's FEATURE run
MASK_CAMS, MASK_N, MASK_SIZES = 8, 32, ((504, 672), (1008, 1344))
# host IO's training run: GAUSSIAN 1..F+1, then one FEATURE block of
# F+1 steps (the phase machine switches once a block passes F steps)
MASK_LOOP_SIZE, MASK_LOOP_FEATURE = 256, 16
# the mask unpack at the n3v-1600x1200 benchmark configuration's stack:
# (masks, height, width) and the loop's M_max
MASK_UNPACK_SHAPE, MASK_UNPACK_M_MAX = (64, 1200, 1600), 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_call(fn):
    """(fn(), its device time in ms) of one call (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def queued_ms(fn, iters: int) -> float:
    """Device time per call of fn() over `iters` back-to-back calls (CUDA
    events): a sleep kernel holds the stream while the host enqueues the
    calls, so the host's time per call cannot pace the device, as it
    does in cuda_ms for a kernel shorter than its wrapper's host time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def repeated_ms(fns: dict, timer=queued_ms) -> dict:
    """{name: {"median", "min", "max", "rounds"}} ms per call over
    TIMING_REPS rounds; each round times every fn in turn (interleaved),
    TIMING_ITERS calls each."""
    times = {k: [] for k in fns}
    for _ in range(TIMING_REPS):
        for k, fn in fns.items():
            times[k].append(timer(fn, TIMING_ITERS))
    return {k: {"median": float(np.median(v)), "min": min(v), "max": max(v),
                "rounds": v} for k, v in times.items()}


def cuda_tool(name: str) -> str:
    """A CUDA toolkit binary beside the nvcc that builds the kernels."""
    from trase_tpu_torch.ops import cuda_lib as CL

    return os.path.join(os.path.dirname(CL.nvcc()), name)


def fwd_sass(lib: str, save: bool = True) -> dict:
    """The forward library through cuobjdump: with `save`, its SASS
    written beside it (<library>.sass), and per instantiation key (n_val,
    n_packed, with_color, residuals) its registers, stack and local
    (spill) bytes and its SASS counts (sass_counts)."""
    def run(*a):
        return subprocess.run([cuda_tool("cuobjdump"), *a, lib],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout

    sass = run("-sass")
    if save:
        with open(os.path.splitext(lib)[0] + ".sass", "w") as f:
            f.write(sass)
    out = {}
    for fn, use in res_usage(lib).items():
        m = FWD_KERNEL_RE.search(fn)
        if m:
            out[fwd_key(m)] = {k: use[k] for k in ("registers", "stack",
                                                    "local")}
    for name, body in sass_functions(sass).items():
        if name in out:
            out[name].update(sass_counts(body))
    return out


def res_usage(lib: str) -> dict:
    """{function: {registers, stack, local, shared}} of a library's
    kernels from cuobjdump -res-usage (local bytes are spills)."""
    out, name = {}, None
    for line in subprocess.run(
            [cuda_tool("cuobjdump"), "-res-usage", lib], capture_output=True,
            text=True, timeout=300, check=True).stdout.splitlines():
        if "Function" in line:
            name = line.split("Function", 1)[1].strip(" :")
        elif name and "REG:" in line:
            use = dict(kv.split(":", 1) for kv in line.split()
                       if ":" in kv)
            out[name] = {"registers": int(use["REG"]),
                         "stack": int(use["STACK"]),
                         "local": int(use["LOCAL"]),
                         "shared": int(use["SHARED"])}
    return out


def bwd_res_usage(lib: str) -> dict:
    """Registers, stack, local (spill) and shared bytes of every kernel of
    the backward library: composite_bwd_kernel by its instantiation
    (n_val/n_packed/with_color/values_only) and the two reduces."""
    out = {}
    for fn, use in res_usage(lib).items():
        m = BWD_KERNEL_RE.search(fn)
        if m:
            out["composite_bwd/" + "/".join(m.groups())] = use
        elif "reduce_pair_grads_kernel" in fn:
            out["reduce_pair_grads"] = use
        elif "reduce_slab_pairs_kernel" in fn:
            out["reduce_slab_pairs"] = use
    return out


def start_nvcc(name: str, source: str):
    """nvcc on a kernel source from outside the package (an earlier
    commit's, or a variant), started now into BUILD_DIR/variants/;
    finish_nvcc waits for it."""
    from trase_tpu_torch.ops import cuda_lib as CL

    out_dir = os.path.join(CL.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(source)
    so = os.path.join(out_dir, f"{name}.so")
    return subprocess.Popen([CL.nvcc(), *CL.NVCC_FLAGS, "-o", so, cu],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), so


def finish_nvcc(build, signatures: dict):
    """(ctypes library with the entry points of `signatures` typed, as
    cuda_lib.load types them, path, ptxas lines) of a start_nvcc build, or
    (None, path, lines) if nvcc failed."""
    from trase_tpu_torch.ops import cuda_lib as CL

    proc, so = build
    log, _ = proc.communicate()
    lines = [ln.strip() for ln in log.splitlines()
             if any(w in ln for w in ("registers", "spill", "error", "wgmma",
                                       "setmaxnreg"))]
    if proc.returncode:
        return None, so, lines
    return CL.load(so, signatures), so, lines


def parent_mlp(lib, fw, emb):
    """The first deform_mlp design's launch (PARENT_MLP_ARGTYPES) on
    packed weights (pack_fused_weights): its outputs; not counted."""
    n = emb.shape[0]
    outs = [torch.empty((n, c), dtype=torch.float32, device=emb.device)
            for c in (3, 4, 3)]
    rc = lib.trase_deform_mlp(
        emb.data_ptr(), n, fw.in_dim, fw.w0.shape[1], fw.w0.data_ptr(),
        fw.ws_in.data_ptr(), fw.w_hidden.data_ptr(), fw.bias.data_ptr(),
        fw.wh.data_ptr(), fw.bh.data_ptr(), *[o.data_ptr() for o in outs],
        torch.cuda.current_stream(emb.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent deform_mlp launch failed: {rc}")
    return tuple(outs)


SASS_INS_RE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;")


def sass_counts(body: list) -> dict:
    """Instructions and MUFU instructions by op in one function's SASS,
    and those of its compositing loop (compositing_loop)."""
    ins = [(int(m.group(1), 16), m.group(2))
           for m in map(SASS_INS_RE.search, body) if m]
    mufu = {}
    for _, i in ins:
        m = re.search(r"MUFU\.(\w+)", i)
        if m:
            mufu[m.group(1)] = mufu.get(m.group(1), 0) + 1
    return {"sass_instructions": len(ins), "mufu": mufu,
            **compositing_loop(ins)}


def compositing_loop(ins: list) -> dict:
    """SASS instructions of one walk through the compositing loop, per
    pixel a thread carries: the innermost loop that holds MUFU.EX2, two of
    them per pixel (the alpha and the weight). Through its blocks, in
    address order, the longest path from the loop's head back to it that
    enters no block holding a MUFU or, after the first MUFU, a shared
    load (every pixel evaluated and skipped) gives the instructions per
    evaluated pair-pixel; the longest path of all (every pixel
    contributing, the values accumulated) less that one, per
    contributing pair-pixel, and its MUFU instructions. Predicated
    instructions count, as they issue. {} if there is no such loop."""
    def target(i):
        m = re.search(r"\bBRA\b.*(0x[0-9a-f]+)$", i)
        return int(m.group(1), 16) if m else None

    loops = [(a, target(i)) for a, i in ins
             if target(i) is not None and target(i) <= a]
    loops = [(a, t) for a, t in loops
             if any(t <= b <= a and "MUFU.EX2" in i for b, i in ins)]
    if not loops:
        return {}
    end, head = min(loops, key=lambda x: x[0] - x[1])
    body = [(a, i) for a, i in ins if head <= a <= end]
    leaders = {head} | {target(i) for _, i in body
                        if target(i) is not None and head < target(i) <= end}
    leaders |= {body[k + 1][0] for k, (_, i) in enumerate(body[:-1])
                if target(i) is not None or "EXIT" in i}
    blocks, cur = [], None
    for a, i in body:
        if a in leaders:
            cur = []
            blocks.append(cur)
        cur.append((a, i))
    first_mufu = min(a for a, i in body if "MUFU" in i)
    starts = [b[0][0] for b in blocks]
    NEG = (-1, 0)

    def longest(allowed):
        best = [NEG] * len(blocks)
        for k in range(len(blocks) - 1, -1, -1):
            if not allowed(k):
                continue
            a, i = blocks[k][-1]
            t = target(i)
            succ = []
            if t is not None and t <= head:
                succ.append((0, 0))  # back to the head: the walk is done
            elif t is not None and t <= end:
                succ.append(best[starts.index(t)])
            conditional = i.startswith("@") and not i.startswith("@PT ")
            if (t is None and "EXIT" not in i) or conditional:
                if k + 1 < len(blocks):
                    succ.append(best[k + 1])
            succ = [s for s in succ if s[0] >= 0]
            if succ:
                n, mu = max(succ)
                best[k] = (n + len(blocks[k]), mu + sum(
                    "MUFU" in x for _, x in blocks[k]))
        return best[0]

    def evaluates(k):
        return k == 0 or not any(
            "MUFU" in i or (a > first_mufu and re.search(r"\bLDS\b", i))
            for a, i in blocks[k])

    every, skipped = longest(lambda k: True), longest(evaluates)
    ppt = sum("MUFU.EX2" in i for _, i in body) // 2
    if skipped[0] < 0 or every[0] < 0 or ppt < 1:
        return {}
    return {"loop_pixels_per_thread": ppt,
            "per_evaluated": skipped[0] / ppt,
            "per_contributing": (every[0] - skipped[0]) / ppt,
            "mufu_per_contributing": (every[1] - skipped[1]) / ppt}


def fwd_floors(sass, key, stats, prefix="") -> dict:
    """The instantiation's registers and local (spill) bytes, and, where
    its SASS counts per pair-pixel are known, its issue floor (4
    warp-instructions per SM per clock, every lane busy) and MUFU floor
    (16 lanes per SM per clock) for this run's evaluated and contributing
    pair-pixels."""
    s = (sass or {}).get(key)
    if not s:
        return {}
    out = {f"{prefix}registers": s["registers"],
           f"{prefix}local_bytes": s["local"]}
    if "per_evaluated" in s:
        n_eval, n_contrib = stats["evaluated"], stats["contributing"]
        issue = s["per_evaluated"] * n_eval + s["per_contributing"] * n_contrib
        mufu = s["mufu_per_contributing"] * n_contrib
        out.update({
            f"{prefix}sass_per_evaluated": s["per_evaluated"],
            f"{prefix}sass_per_contributing": s["per_contributing"],
            f"{prefix}mufu_per_contributing": s["mufu_per_contributing"],
            f"{prefix}issue_floor_ms":
                issue / (SMS * 4 * 32 * SM_CLOCK_HZ) * 1e3,
            f"{prefix}mufu_floor_ms": mufu / (SMS * 16 * SM_CLOCK_HZ) * 1e3})
    return out


def fwd_key(m) -> tuple:
    n_val, n_packed, color, res = m.groups()
    return int(n_val), int(n_packed), color == "1", res == "1"


def sass_functions(sass: str) -> dict:
    """{instantiation key: [SASS lines]} of the forward kernel's functions
    in a cuobjdump -sass listing."""
    out, body = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = FWD_KERNEL_RE.search(line)
            body = out.setdefault(fwd_key(m), []) if m else None
        elif body is not None:
            body.append(line)
    return out


def shuffle_floor_ms(steps: int, shuffles: int) -> float:
    """The least time of `shuffles` warp shuffles in each of `steps`."""
    return steps * shuffles / (SMS * SM_CLOCK_HZ) * 1e3


def deltas(params, net, fid, fused=False):
    from trase_tpu_torch.models.deform import deform_step

    t = torch.full((params.xyz.shape[0], 1), fid, device=params.xyz.device)
    return deform_step(net, params.xyz, t, fused=fused)


def projected(params, aux, cam, d, with_features):
    """What renderer.render hands the rasterizer for deltas `d`."""
    from trase_tpu_torch.models import gaussians as G
    from trase_tpu_torch.ops.projection import compute_cov3d, project_gaussians
    from trase_tpu_torch.renderer import apply_deformation

    means, scales, rots = apply_deformation(params, *d)
    zero = torch.zeros((), device=means.device)
    opacity = torch.where(aux.alive, G.get_opacity(params)[:, 0], zero)
    proj = project_gaussians(means, compute_cov3d(scales, rots), opacity,
                             cam.buffers, cam.image_height, cam.image_width,
                             sh_coeffs=G.get_features(params), sh_degree=3)
    feats = None
    if with_features:
        f = params.gaussian_features
        feats = f / torch.sqrt(torch.sum(f * f, dim=-1, keepdim=True) + 1e-12)
    return proj, feats


def kernel_inputs(proj, feats, H, W, cfg, pack, with_color=True):
    """composite_fwd's arguments, features packed when `pack`; with
    with_color=False the features-only layout."""
    from trase_tpu_torch.ops import rasterize_cuda as RC

    ci = RC.composite_inputs(proj, feats, H, W,
                             cfg._replace(pack_features=pack), with_color)
    payload = ci.payload
    if ci.n_packed:
        payload = RC.pack_feature_words(payload, ci.n_val, ci.n_packed,
                                        with_color)
    return payload, ci.sorted_gauss, ci.tile_start, ci.n_val, ci.n_packed


def stage_ms(params, aux, cam, net, cfg, with_features, pack, frames=5,
             fused=False):
    """Device time of each stage of one frame, from CUDA events recorded
    between the stages on the current stream (launch gaps inside a stage
    count to it), averaged over `frames` frames after one warm-up; the
    deform stage through the fused MLP when `fused`."""
    from trase_tpu_torch.ops import rasterize_cuda as RC

    names = ("deform", "project", "bin_payload", "composite")
    total = dict.fromkeys(names, 0.0)
    H, W = cam.image_height, cam.image_width
    for i in range(frames + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        d = deltas(params, net, 0.5, fused)
        ev[1].record()
        proj, feats = projected(params, aux, cam, d, with_features)
        ev[2].record()
        args = kernel_inputs(proj, feats, H, W, cfg, pack)
        ev[3].record()
        RC.composite_fwd(*args[:3], H, W, *args[3:])
        ev[4].record()
        torch.cuda.synchronize()
        if i:
            for k, name in enumerate(names):
                total[name] += ev[k].elapsed_time(ev[k + 1]) / frames
    return total


def profile_frames(frame, frames=5) -> dict:
    """torch.profiler over `frames` frames: device busy time per frame by
    kernel, and the share of the frame the device sat idle. The profiler
    slows the host, so wall_ms here exceeds the phase-4 frame time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            frame()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / frames
    kernels = [(e.key, e.self_device_time_total / 1e3 / frames,
                e.count / frames)
               for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / frames,
                    e.count / frames) for e in prof.key_averages()
                   if e.self_cpu_time_total > 0), key=lambda k: -k[1])
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall,
            "top": [{"kernel": k[0][:90], "ms": k[1], "per_frame": k[2]}
                    for k in kernels[:12]],
            "host_top": [{"op": k[0][:60], "ms": k[1], "per_frame": k[2]}
                         for k in host[:8]]}


def split(hwc, with_color=True):
    if not with_color:
        return {"alpha": hwc[..., 0], "feats": hwc[..., 1:]}
    return {"alpha": hwc[..., 0], "render": hwc[..., 1:4],
            "feats": hwc[..., 4:-1], "depth": hwc[..., -1]}


def compare(label, proj, feats, H, W, cfg, pack, timed, with_color=True,
            sass=None):
    """Kernel vs plain on one input, bit for bit, and for the features-only
    layouts (with_color=False) the residual instantiation too; with
    `timed`, also times both (the kernel as medians of queued rounds
    beside its host-paced time) and reckons the bound and, from `sass`
    (fwd_sass), the issue and MUFU floors from this input's pair-pixel
    work."""
    from trase_tpu_torch.ops import rasterize_cuda as RC

    args = kernel_inputs(proj, feats, H, W, cfg, pack, with_color)
    payload, sg, tile_start, n_val, n_packed = args
    kw = dict(with_color=with_color)
    got = RC.composite_fwd(payload, sg, tile_start, H, W, n_val, n_packed,
                           **kw)
    torch.cuda.synchronize()
    stats = {}
    ref = RC.composite_plain(payload, sg, tile_start, H, W, n_val, n_packed,
                             stats=stats, **kw)
    errs = {}
    for k, g in split(got, with_color).items():
        if g.numel():
            errs[k] = float((g - split(ref, with_color)[k]).abs().max())
    bad = {k: e for k, e in errs.items() if not e <= FWD_TOL}
    row = {"phase": "compare", "scene": label, "n_val": n_val,
           "n_packed": n_packed, "with_color": with_color,
           "max_abs_diff": errs, "tol": FWD_TOL, "pairs": int(tile_start[-1])}
    if not with_color:
        res, logt, stop = RC.composite_fwd(*args[:3], H, W, n_val, n_packed,
                                           residuals=True, **kw)
        torch.cuda.synchronize()
        _, ref_logt, ref_stop = RC.composite_plain(
            *args[:3], H, W, n_val, n_packed, residuals=True, **kw)
        row["residuals"] = {
            "image": float((res - ref).abs().max()),
            "logt": float((logt - ref_logt).abs().max()),
            "stop_mismatches": int((stop != ref_stop).sum())}
        if any(row["residuals"].values()):
            bad["residuals"] = row["residuals"]
    if timed:
        fns = {"ms": lambda: RC.composite_fwd(
            *args[:3], H, W, n_val, n_packed, **kw)}
        if not with_color:
            fns["ms_residuals"] = lambda: RC.composite_fwd(
                *args[:3], H, W, n_val, n_packed, residuals=True, **kw)
        for k, t in repeated_ms(fns).items():
            row[k], row[f"{k}_repeats"] = t["median"], t
            row[f"{k}_host_paced"] = cuda_ms(fns[k], TIMING_ITERS)
        row["plain_ms"] = cuda_ms(lambda: RC.composite_plain(
            *args[:3], H, W, n_val, n_packed, **kw), 1)
        pairs = int(tile_start[-1])
        nbytes = (pairs * (4 * payload.shape[1] + 4) + 4 * tile_start.numel()
                  + 4 * H * W * (1 + n_val))
        ops = 16 * stats["evaluated"] + (8 + 2 * n_val) * stats["contributing"]
        row.update(bytes=nbytes, ops=ops, evaluated=stats["evaluated"],
                   contributing=stats["contributing"],
                   **bound(None, nbytes, ops),
                   **fwd_floors(sass, (n_val, n_packed, with_color, False),
                                stats))
        if not with_color:
            rbytes = nbytes + 8 * logt.numel()
            row.update(bytes_residuals=rbytes, **bound(
                "residuals", rbytes, ops), **fwd_floors(
                    sass, (n_val, n_packed, False, True), stats,
                    "residuals_"))
    emit(row)
    if bad:
        raise AssertionError(f"kernel disagrees with plain on {label} "
                             f"n_val={n_val} n_packed={n_packed} "
                             f"with_color={with_color}: {bad}")
    return row


def small_scene(device):
    from trase_tpu_torch.ops.projection import compute_cov3d, project_gaussians
    from trase_tpu_torch.renderer import make_render_camera

    rng = np.random.default_rng(1)
    n, H, W = 400, 96, 128
    means = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    means[:, 2] += 5.0
    scales = rng.uniform(0.05, 0.3, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, size=n).astype(np.float32)
    feats = rng.normal(size=(n, 32)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)

    def t(x):
        return torch.tensor(x, device=device)

    cam = make_render_camera(np.eye(3), np.zeros(3), 1.0, 0.8, H, W,
                             device=device)
    proj = project_gaussians(t(means), compute_cov3d(t(scales), t(quats)),
                             t(opac), cam.buffers, H, W,
                             colors_precomp=t(colors))
    return proj, t(feats), H, W


def write_cli_inputs(root, params, aux, net, device, n_train=3, n_test=2,
                     size=64):
    """A Blender-format dataset (transforms_*.json, images, SAM-style
    masks, points3d.ply) and a model directory, written with the port's
    own writers. Each image gets 3 seeded elliptical masks."""
    from PIL import Image

    from trase_tpu_torch.data.masks import save_mask_file

    from trase_tpu_torch.config import save_cfg
    from trase_tpu_torch.data.ply import write_point_cloud
    from trase_tpu_torch.models.deform import flax_variables
    from trase_tpu_torch.models.gaussians_io import save_checkpoint, save_gaussian_ply
    from trase_tpu_torch.renderer import make_render_camera, render

    src, mdl = os.path.join(root, "data"), os.path.join(root, "model")
    # the Blender reader finds masks at <image dir>/masks/<name>.npz
    os.makedirs(os.path.join(src, "images", "masks"))
    fov = 0.9
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for split_name, n, off in (("train", n_train, 0.0), ("test", n_test, 0.37)):
        frames = []
        for i in range(n):
            th = 2 * np.pi * (i / n + off)
            c2w = np.eye(4)
            eye = np.array([4.0 * np.sin(th), 0.0, 4.0 - 4.0 * np.cos(th)])
            fwd = np.array([0.0, 0.0, 4.0]) - eye
            fwd /= np.linalg.norm(fwd)
            right = np.cross(fwd, [0.0, 1.0, 0.0])
            right /= np.linalg.norm(right)
            down = np.cross(fwd, right)
            c2w[:3, :3] = np.stack([right, down, fwd], axis=1)
            c2w[:3, 3] = eye
            w2c = np.linalg.inv(c2w)
            cam = make_render_camera(w2c[:3, :3].T, w2c[:3, 3], fov, fov,
                                     size, size, device=device)
            with torch.no_grad():
                img = render(cam, params, aux.alive,
                             torch.zeros(3, device=device),
                             with_features=False)["render"]
            arr = (img.clamp(0, 1).permute(1, 2, 0).cpu().numpy() * 255)
            name = f"{split_name}_{i:04d}"
            Image.fromarray(arr.astype(np.uint8)).save(
                os.path.join(src, "images", f"{name}.png"))
            c = rng.uniform(0.25, 0.75, size=(3, 2)) * size
            r = rng.uniform(0.12, 0.3, size=(3, 2)) * size
            save_mask_file(os.path.join(src, "images", "masks",
                                        f"{name}.npz"),
                           ((yy - c[:, :1, None]) / r[:, :1, None]) ** 2
                           + ((xx - c[:, 1:, None]) / r[:, 1:, None]) ** 2
                           <= 1.0)
            blender = c2w.copy()
            blender[:3, 1:3] *= -1  # COLMAP -> Blender axes
            frames.append({"file_path": f"images/{name}",
                           "time": i / max(n - 1, 1),
                           "transform_matrix": blender.tolist()})
        with open(os.path.join(src, f"transforms_{split_name}.json"), "w") as f:
            json.dump({"camera_angle_x": fov, "frames": frames}, f)
    pts = params.xyz[aux.alive].cpu().numpy()
    write_point_cloud(os.path.join(src, "points3d.ply"), pts,
                      np.full_like(pts, 128.0))
    it = 7
    save_gaussian_ply(os.path.join(mdl, "point_cloud", f"iteration_{it}",
                                   "point_cloud.ply"), params, aux.alive)
    save_checkpoint(os.path.join(mdl, "deform", f"iteration_{it}",
                                 "deform.pkl"),
                    {"vars": flax_variables(net), "type": "DeformNetwork"})
    import argparse

    save_cfg(mdl, argparse.Namespace(sh_degree=3, source_path=src,
                                     model_path=mdl, eval=True,
                                     is_blender=False,
                                     white_background=False))
    return src, mdl, it, n_train, n_test


def compare_bwd(label, proj, feats, H, W, cfg, timed, pack=False,
                with_color=True, sass=None):
    """Forward residuals, backward kernel and reduce kernel against their
    plain versions on one input and one seeded cotangent, one row per
    backward mode (full, then values-only: geometry exactly 0, value words
    bit for bit the full mode's); each kernel launched twice
    (bit-identical results). With `timed`, also
    times each (medians of repeated rounds) and reckons the bounds and the
    backward's shuffle floor from this input's counts."""
    from trase_tpu_torch.ops import rasterize_cuda as RC

    ci = RC.composite_inputs(proj, feats, H, W, cfg._replace(
        pack_features=pack), with_color)
    n_val, n_packed = ci.n_val, ci.n_packed
    kpay = (RC.pack_feature_words(ci.payload, n_val, n_packed, with_color)
            if n_packed else ci.payload)
    args = (kpay, ci.sorted_gauss, ci.tile_start, H, W, n_val, n_packed)
    out, logt, stop = RC.composite_fwd(*args, with_color=with_color,
                                       residuals=True)
    torch.cuda.synchronize()
    fstats = {}
    ref_out, ref_logt, ref_stop = RC.composite_plain(
        *args, with_color=with_color, residuals=True, stats=fstats)
    fwd = {"image": float((out - ref_out).abs().max()),
           "logt": float((logt - ref_logt).abs().max()),
           "stop_mismatches": int((stop != ref_stop).sum())}
    gen = torch.Generator(device=proj.mean2d.device).manual_seed(0)
    g = torch.randn((H, W, 1 + n_val), generator=gen,
                    device=proj.mean2d.device)
    nv = int(ci.tile_start[-1])
    n = ci.payload.shape[0]
    words = 6 + n_val
    inv = RC.inverse_pairs(ci.sorted_pid)
    groups = dict(GEOM_GROUPS, values=(6, words))
    rows, full_pair = [], None
    for values_only in (False, True):
        mode = dict(with_color=with_color, values_only=values_only)
        first = torch.empty_like(logt)
        dpair = RC.composite_bwd(*args, g, logt, stop, logt_first=first,
                                 **mode)
        again = RC.composite_bwd(*args, g, logt, stop, **mode)
        torch.cuda.synchronize()
        stats = {}
        # the plain version's time is this one call's, which also counts
        # the stats (three host syncs per pair rank, ~1 % at the bench
        # scene): a second plain walk of the bench scene costs 0.7-2.5 s
        ref_pair, plain_ms = timed_call(lambda: RC.composite_bwd_plain(
            *args, g, logt, stop, stats=stats, **mode))
        dpay = RC.reduce_pair_grads(dpair, inv, ci.tile_start, n)
        dpay_again = RC.reduce_pair_grads(dpair, inv, ci.tile_start, n)
        torch.cuda.synchronize()
        same = {"composite_bwd": torch.equal(again[:nv], dpair[:nv]),
                "reduce_pair_grads": torch.equal(dpay_again, dpay)}
        same_input = RC.reduce_pair_grads_plain(dpair, inv, ci.tile_start, n)
        chain = RC.reduce_pair_grads_plain(ref_pair, inv, ci.tile_start, n)
        checked = {k: v for k, v in groups.items()
                   if not (values_only and k != "values")}

        def by_group(a, b):
            out_abs, out_rel = {}, {}
            for name, (lo, hi) in checked.items():
                d = float((a[:, lo:hi] - b[:, lo:hi]).abs().max())
                out_abs[name] = d
                out_rel[name] = d / (float(b[:, lo:hi].abs().max()) + 1e-30)
            return out_abs, out_rel

        pair_abs, pair_rel = by_group(dpair[:nv], ref_pair[:nv])
        gauss_abs, gauss_rel = by_group(dpay, chain)
        row = {"phase": "compare-bwd", "scene": label, "n_val": n_val,
               "n_packed": n_packed, "with_color": with_color,
               "values_only": values_only, "pairs": nv,
               "fwd_residuals": fwd,
               "bwd_max_abs_diff": pair_abs, "bwd_max_rel_diff": pair_rel,
               "reduce_max_abs_diff": float((dpay - same_input).abs().max()),
               "per_gaussian_max_abs_diff": gauss_abs,
               "per_gaussian_max_rel_diff": gauss_rel,
               "logt_first_max_abs": float(first.abs().max()),
               "t_first_max_err": float((first.exp() - 1.0).abs().max()),
               "logt_first_vs_plain": float(
                   (first - stats["logt_first"]).abs().max()),
               "bit_identical_relaunch": same,
               "tol": {"fwd": FWD_TOL, "bwd_rel": BWD_TOL,
                       "reduce": 0.0, "t_first": LOGT_FIRST_TOL}}
        bad = [k for k, v in pair_rel.items() if not v <= BWD_TOL]
        bad += [f"{k} not bit-identical" for k, v in same.items() if not v]
        bad += [k for k, v in gauss_rel.items() if not v <= BWD_TOL]
        if values_only:
            row["geometry_max_abs"] = float(dpair[:nv, :6].abs().max())
            row["values_vs_full_max_abs"] = float(
                (dpair[:nv, 6:] - full_pair[:nv, 6:]).abs().max())
            row["per_gaussian_geometry_max_abs"] = float(
                dpay[:, :6].abs().max())
            if row["geometry_max_abs"] or row["values_vs_full_max_abs"] \
                    or row["per_gaussian_geometry_max_abs"]:
                bad.append("values-only contract")
        full_pair = dpair
        if timed:
            t = repeated_ms({"composite_bwd": lambda: RC.composite_bwd(
                *args, g, logt, stop, **mode)})["composite_bwd"]
            row["bwd_ms"] = t["median"]
            row["bwd_ms_repeats"] = t
            walk = stop.reshape(-1, 256).amax(dim=1)
            row["walk"] = {"tiles": walk.numel(), "max": int(walk.max()),
                           "mean": float(walk.float().mean()),
                           "p99": float(walk.float().quantile(0.99))}
            row["bwd_plain_ms"] = plain_ms
            nbytes = (nv * (4 * kpay.shape[1] + 4) + nv * 4 * words
                      + 4 * H * W * (1 + n_val) + 8 * logt.numel()
                      + 4 * ci.tile_start.numel())
            per_counted = (5 + 2 * n_val) if values_only else 35 + 4 * n_val
            ops = 16 * stats["evaluated"] + per_counted * stats["counted"]
            # the kernel's shuffles: every warp takes every 8-pair
            # sub-batch below its tile's largest stop, and the geometry
            # moments (full mode) and rgb + depth beside them (with colour)
            # take two xor steps each in it. A model of the design this
            # kernel replaced: a warp-wide all-reduce (5 shuffles) per word
            # summed, in every (pair, warp) step with a counted lane
            sub_steps = BWD_WARPS * int(
                ((walk // BWD_BATCH) * (BWD_BATCH // BWD_SUB)
                 + (walk % BWD_BATCH + BWD_SUB - 1) // BWD_SUB).sum())
            shuffles = 2 * ((0 if values_only else 6)
                            + (4 if with_color else 0))
            summed = words - 6 if values_only else words
            row.update(bwd_bytes=nbytes, bwd_ops=ops,
                       evaluated=stats["evaluated"], counted=stats["counted"],
                       warp_steps=stats["warp_steps"],
                       sub_batch_steps=sub_steps,
                       shuffles_per_sub_batch=shuffles,
                       shuffle_floor_ms=shuffle_floor_ms(sub_steps, shuffles),
                       all_reduce_model_floor_ms=shuffle_floor_ms(
                           stats["warp_steps"], 5 * summed),
                       **bound("bwd", nbytes, ops))
            if not values_only:
                fwd_fn = lambda: RC.composite_fwd(  # noqa: E731
                    *args, with_color=with_color, residuals=True)
                t = repeated_ms({"fwd": fwd_fn})["fwd"]
                row.update(fwd_residuals_ms=t["median"],
                           fwd_residuals_ms_repeats=t,
                           fwd_residuals_ms_host_paced=cuda_ms(
                               fwd_fn, TIMING_ITERS),
                           **fwd_floors(sass, (n_val, n_packed, with_color,
                                               True), fstats,
                                        "fwd_residuals_"))
                fbytes = (nv * (4 * kpay.shape[1] + 4)
                          + 4 * ci.tile_start.numel()
                          + 4 * H * W * (1 + n_val) + 8 * logt.numel())
                fops = 16 * fstats["evaluated"] + (8 + 2 * n_val) * fstats[
                    "contributing"]
                row.update(fwd_residuals_bytes=fbytes,
                           fwd_evaluated=fstats["evaluated"],
                           fwd_contributing=fstats["contributing"],
                           **bound("fwd_residuals", fbytes, fops))
                row["reduce_plain_ms"] = cuda_ms(
                    lambda: RC.reduce_pair_grads_plain(
                        dpair, inv, ci.tile_start, n), 3)
                idx = ci.sorted_gauss[:nv].long()
                prows = dpair[:nv].contiguous()
                acc = torch.zeros((n, words), device=dpair.device)
                # the same sums as one PyTorch call (a yardstick only)
                pair = {"reduce_pair_grads": lambda: RC.reduce_pair_grads(
                    dpair, inv, ci.tile_start, n),
                        "index_add_": lambda: acc.index_add_(0, idx, prows)}
                # device time back to back, and as cuda_ms times them:
                # launched as fast as the host enqueues them
                t = repeated_ms(pair)
                row["reduce_ms_repeats"] = {
                    "queued": t, "host_paced": repeated_ms(pair, cuda_ms)}
                row["reduce_ms"] = t["reduce_pair_grads"]["median"]
                row["reduce_library_ms"] = t["index_add_"]["median"]
                k = inv.numel() // n
                rbytes = 4 * inv.numel() + nv * 4 * words + n * 4 * words
                row.update(reduce_words=words, reduce_bytes=rbytes,
                           reduce_ops=n * k * words,
                           **bound("reduce", rbytes, n * k * words))
        emit(row)
        if fwd["stop_mismatches"] or not fwd["image"] <= FWD_TOL \
                or not fwd["logt"] <= FWD_TOL:
            bad.append("forward residuals")
        if row["reduce_max_abs_diff"] != 0.0:
            bad.append("reduce")
        if not row["t_first_max_err"] <= LOGT_FIRST_TOL:
            bad.append("log T reconstruction")
        if bad:
            raise AssertionError(f"backward kernels disagree with plain on "
                                 f"{label} n_val={n_val} n_packed="
                                 f"{n_packed} values_only={values_only}: "
                                 f"{bad}")
        rows.append(row)
    return rows


def cublas_chain(w):
    """The library yardstick for the fused MLP (timed here, never called
    by the port): the same chain as 11 PyTorch calls through cuBLAS, 8 bf16
    F.linear whose bf16 products get the float32 bias before each bf16
    rounding, then the 3 float32 heads."""
    import torch.nn.functional as F

    d = w.in_dim
    mats = ([w.w0[:, :d].contiguous()] + [w.w_hidden[i] for i in range(4)]
            + [torch.cat([w.ws_in[:, :d], w.w_hidden[4]], 1).contiguous()]
            + [w.w_hidden[5], w.w_hidden[6]])
    cols = ((0, 3), (3, 7), (7, 10))
    heads = [(w.wh[:, a:b].T.contiguous(), w.bh[a:b]) for a, b in cols]

    def run(emb):
        inp = emb.to(torch.bfloat16)
        h = inp
        for i, m in enumerate(mats):
            if i == 5:
                h = torch.cat([inp, h], 1)
            h = torch.relu(F.linear(h, m).float() + w.bias[i]).to(
                torch.bfloat16)
        hf = h.float()
        return tuple(F.linear(hf, hw, hb) for hw, hb in heads)

    def gemms(inputs):
        """The chain's 11 products alone, on fixed inputs of each width:
        what cuBLAS takes without the bias / ReLU / rounding passes."""
        for x, m in zip(inputs[:8], mats):
            F.linear(x, m)
        for hw, hb in heads:
            F.linear(inputs[8], hw, hb)

    run.gemms = gemms
    return run


def mlp_rel(a, b):
    """Max abs difference of each head over its largest magnitude in b."""
    return {h: float((x - y).abs().max()) / (float(y.abs().max()) + 1e-12)
            for h, x, y in zip(MLP_HEADS, a, b)}


def compare_mlp(label, net, xyz, t, timed, parent=None):
    """The fused deform MLP kernel against its plain version on one
    embedding (MLP_TOL of each head's scale), relaunched bit for bit, and
    both against the float32 module (MLP_MODULE_TOL); with `timed`, the
    kernel, the cuBLAS chain, its bare products and `parent` (an earlier
    design's library, if given) in interleaved queued rounds, the
    kernel host-paced, the plain version and the module timed, the
    weights' packing uncached and cached, and the bound reckoned."""
    from trase_tpu_torch.models.deform import deform_step, frequency_embed
    from trase_tpu_torch.ops import mlp_cuda as M

    emb = torch.cat([frequency_embed(xyz, net.multires),
                     frequency_embed(t, net.t_multires)], 1).contiguous()
    w = M.pack_fused_weights(net)
    dw = M.device_layout(w)
    got = M.deform_mlp_cuda(dw, emb)
    again = M.deform_mlp_cuda(dw, emb)
    torch.cuda.synchronize()
    ref = M.deform_mlp_plain(w, emb)
    chain = cublas_chain(w)
    with torch.no_grad():
        module = deform_step(net, xyz, t)
        lib = chain(emb)

    row = {"phase": "compare", "kernel": "deform_mlp", "scene": label,
           "rows": emb.shape[0], "in_dim": w.in_dim,
           "kernel_vs_plain": mlp_rel(got, ref),
           "kernel_vs_module": mlp_rel(got, module),
           "plain_vs_module": mlp_rel(ref, module),
           "library_vs_plain": mlp_rel(lib, ref),
           "max_abs_diff": max(float((x - y).abs().max())
                               for x, y in zip(got, ref)),
           "relaunch_identical": all(torch.equal(x, y)
                                     for x, y in zip(got, again)),
           "tol": {"kernel_vs_plain": MLP_TOL, "vs_module": MLP_MODULE_TOL}}
    if parent is not None:
        row["parent_vs_plain"] = mlp_rel(parent_mlp(parent, w, emb), ref)
    if timed:
        with torch.no_grad():
            n, bf = emb.shape[0], torch.bfloat16
            h = torch.ones((n, 256), dtype=bf, device=emb.device)
            ins = ([emb.to(bf)] + [h] * 4
                   + [torch.ones((n, w.in_dim + 256), dtype=bf,
                                 device=emb.device)] + [h] * 2 + [h.float()])
            fns = {"kernel": lambda: M.deform_mlp_cuda(dw, emb),
                   "library": lambda: chain(emb),
                   "library_gemms": lambda: chain.gemms(ins)}
            if parent is not None:
                fns["parent"] = lambda: parent_mlp(parent, w, emb)
            reps = repeated_ms(fns)
            for k, v in reps.items():
                pre = "" if k == "kernel" else f"{k}_"
                row[f"{pre}ms"] = v["median"]
                row[f"{pre}ms_repeats"] = v
            row["ms_host_paced"] = cuda_ms(lambda: M.deform_mlp_cuda(dw, emb),
                                           20)
            row["plain_ms"] = cuda_ms(lambda: M.deform_mlp_plain(w, emb), 5)
            row["module_ms"] = cuda_ms(lambda: deform_step(net, xyz, t), 5)
        row["pack_ms"] = cuda_ms(
            lambda: M.device_layout(M.pack_fused_weights(net)), 20)
        row["pack_cached_ms"] = cuda_ms(lambda: M.fused_weights(net), 20)
        row.update(mlp_bound(emb.shape[0], w.in_dim, w.w0.shape[1]))
    emit(row)
    bad = [k for k in ("kernel_vs_plain", "parent_vs_plain")
           if k in row and not max(row[k].values()) <= MLP_TOL]
    bad += [k for k in ("kernel_vs_module", "plain_vs_module")
            if not max(row[k].values()) <= MLP_MODULE_TOL]
    if not all(bool(torch.isfinite(x).all()) for x in got):
        bad.append("non-finite kernel output")
    if not row["relaunch_identical"]:
        bad.append("relaunch not bit-identical")
    if bad:
        raise AssertionError(f"deform_mlp on {label}: {bad}")
    return row


def counts():
    """The launches since reset_counts by kernel; the mask unpack's and
    the smoothing backward's only where they ran."""
    from trase_tpu_torch.ops import cuda_lib as CL

    totals = dict.fromkeys(("composite_fwd", "composite_bwd",
                            "reduce_pair_grads", "deform_mlp"), 0)
    for key, n in CL.LAYOUT_LAUNCHES.items():
        totals[key[0]] = totals.get(key[0], 0) + n
    return totals


def compositor(n):
    """Launch counts of a training path: each compositor kernel n times."""
    return dict.fromkeys(("composite_fwd", "composite_bwd",
                          "reduce_pair_grads"), n)


def smoothing(n):
    """Launch counts of n FEATURE steps' smoothing backward (none at 0)."""
    return {"smooth_rows_bwd": n} if n else {}


def layout_counts():
    """The launches since reset_counts by instantiation, as strings:
    kernel/n_val/n_packed/with_color/(residuals or values_only) and
    reduce_pair_grads/words."""
    from trase_tpu_torch.ops import cuda_lib as CL

    return {"/".join(str(int(x) if isinstance(x, bool) else x) for x in k):
            v for k, v in sorted(CL.LAYOUT_LAUNCHES.items(), key=str)}


def reset_counts():
    from trase_tpu_torch.ops import cuda_lib as CL

    CL.LAYOUT_LAUNCHES.clear()


class StageTimer:
    """CUDA events around the functions one training step calls: each
    wrapped call records an event before and after itself on the current
    stream, so the split needs no change to the step. Installed only for
    the split's own steps (not for the counted or timed ones). `feature`
    picks the FEATURE step's calls, `style` the style step's (its NNFM
    loss is the "loss" span; timed_vgg wraps its extractor), else the
    GAUSSIAN step's."""

    def __init__(self, feature=False, style=False):
        import trase_tpu_torch.engine.trainer as TT
        import trase_tpu_torch.losses.style as LS
        import trase_tpu_torch.ops.rasterize_cuda as RC
        import trase_tpu_torch.renderer as RR

        self.events = []
        composite = RC._Composite
        if style:
            loss = [(LS, "loss_nnfm_style", "loss")]
            head = [(TT, "apply_deform", "deform_fwd"),
                    (TT, "render", "render_fwd")]
        elif feature:
            loss = [(TT, "bilinear_resize_mm", "loss"),
                    (TT, "cosine_gram", "loss"),
                    (TT, "positive_pixel_pair_loss", "loss"),
                    (TT, "negative_pixel_pair_loss", "loss")]
            head = [(TT, "sample_pixels_and_masks", "sample"),
                    (TT, "pixel_mask_correspondence_matrix", "mask_terms"),
                    (TT, "pixel_weights", "mask_terms"),
                    (TT, "apply_deform", "deform_fwd"),
                    (RR, "smooth_features", "smooth")]
        else:
            loss = [(TT, "l1_loss", "loss"), (TT, "ssim", "loss")]
            head = [(TT, "apply_deform", "deform_fwd")]
        self.patches = head + [
            (RR, "project_gaussians", "project"),
            (RC, "composite_inputs", "bin_payload"),
        ] + loss + [
            (RC, "composite_bwd", "composite_bwd"),
            (RC, "reduce_pair_grads", "reduce"),
            (TT, "adam_update", "adam"), (TT, "adam_update_list", "adam"),
        ]
        self.saved = [(m, a, getattr(m, a)) for m, a, _ in self.patches]
        self.saved.append((RC, "_Composite", composite))
        for (m, a, name), (_, _, fn) in zip(self.patches, self.saved):
            setattr(m, a, self._wrap(fn, name))
        timer = self

        class Shim:
            @staticmethod
            def apply(*args):
                return timer._wrap(composite.apply, "composite_fwd")(*args)

        RC._Composite = Shim

    def _wrap(self, fn, name):
        if isinstance(fn, dict):  # a table of losses by mode
            return {k: self._wrap(f, name) for k, f in fn.items()}

        def wrapped(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            self.events.append((name, a, b))
            return out
        return wrapped

    def restore(self):
        for m, a, fn in self.saved:
            setattr(m, a, fn)

    def timed_vgg(self, vgg):
        """`vgg` with its forward inside a "vgg_fwd" span."""
        timer = self

        class Timed:
            normalize = staticmethod(vgg.normalize)

            def __call__(self, *a, **kw):
                return timer._wrap(vgg, "vgg_fwd")(*a, **kw)

        return Timed()

    def step_split(self, start, end):
        """{stage: ms} of one step bracketed by events start / end; the
        backward is the span from the last loss event to the first Adam
        event (composite_bwd and reduce lie inside it)."""
        torch.cuda.synchronize()
        split = {}
        for name, a, b in self.events:
            split[name] = split.get(name, 0.0) + a.elapsed_time(b)
        last_loss = [b for n, _, b in self.events if n == "loss"][-1]
        first_adam = [a for n, a, _ in self.events if n == "adam"][0]
        split["backward_total"] = last_loss.elapsed_time(first_adam)
        split["adam_stats_guard"] = first_adam.elapsed_time(end)
        split["step"] = start.elapsed_time(end)
        self.events = []
        return split


class KernelCapture:
    """Inside the with-block, keeps each composite_fwd call's arguments and
    output (the wrapper still launches and counts as it does); `plain_err`
    holds the last call against composite_plain on the same inputs."""

    def __enter__(self):
        from trase_tpu_torch.ops import rasterize_cuda as RC

        self.RC, self.fn, self.calls = RC, RC.composite_fwd, []

        def record(*a, **kw):
            out = self.fn(*a, **kw)
            self.calls.append((a, kw, out))
            return out

        RC.composite_fwd = record
        return self

    def __exit__(self, *exc):
        self.RC.composite_fwd = self.fn

    def plain_err(self) -> float:
        a, kw, out = self.calls[-1]
        torch.cuda.synchronize()
        return float((out - self.RC.composite_plain(*a, **kw)).abs().max())


def grouped_features(params, n, dev):
    """The bench scene's feature field grouped by position: one seeded
    32-dim direction per octant around the cloud's centre, plus noise (a
    trained field groups objects so; random features give k-means and the
    cosine post-filter nothing to find)."""
    xyz = params.xyz[:n] - torch.tensor(VIEWER_TARGET, device=dev)
    octant = ((xyz[:, 0] > 0).long() * 4 + (xyz[:, 1] > 0).long() * 2
              + (xyz[:, 2] > 0).long())
    gen = torch.Generator().manual_seed(8)
    dirs = torch.nn.functional.normalize(torch.randn(8, 32, generator=gen),
                                         dim=1).to(dev)
    feats = torch.zeros_like(params.gaussian_features)
    feats[:n] = dirs[octant] + 0.05 * torch.randn(n, 32,
                                                  generator=gen).to(dev)
    return params._replace(gaussian_features=feats)


def aim(v):
    """The orbit camera on the bench cloud: centred on VIEWER_TARGET (the
    camera's pose subtracts `center`), VIEWER_RADIUS away."""
    from trase_tpu_torch.cam_utils import OrbitCamera

    v.cam = OrbitCamera(v.W, v.H, r=VIEWER_RADIUS)
    v.cam.center = -np.asarray(VIEWER_TARGET, np.float32)
    v.fid = 0.5


def frame_launches(before, after):
    return {k: after[k] - before[k] for k in after}


def covered_pixel(v):
    """(px, py) of the largest alpha in the frame's central third: a click
    there lands on geometry."""
    alpha = v._raw_frame()[0]["alpha"][0].cpu().numpy()
    h, w = alpha.shape
    win = alpha[h // 3:2 * h // 3, w // 3:2 * w // 3]
    y, x = np.unravel_index(int(np.argmax(win)), win.shape)
    return int(x) + w // 3, int(y) + h // 3


def viewer_phase(params, aux, n, net, dev, root, seg_dir, seg_it):
    """The port's viewer on the card at full width (module docstring,
    phase viewer). Returns (row, the viewer, launches, layouts)."""
    from trase_tpu_torch.viewer import MODES, HeadlessViewer

    v = HeadlessViewer(grouped_features(params, n, dev), aux, n,
                       deform_net=net, W=WIDTH, H=HEIGHT, sh_degree=3,
                       device=dev)
    aim(v)
    row = {"phase": "viewer", "gaussians": n,
           "capacity": int(params.xyz.shape[0]), "height": HEIGHT,
           "width": WIDTH, "raster_cfg": v.raster_cfg._asdict()}
    t0 = time.perf_counter()
    row["clusters"] = v.cluster(kmeans=True, k=VIEWER_K, save=False)
    row["cluster_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    v._pca()
    row["pca_s"] = time.perf_counter() - t0

    reset_counts()
    modes = {}
    for mode in MODES:
        before = counts()
        ms = []
        for i in range(VIEWER_WARMUP + VIEWER_FRAMES):
            img = v.render_frame(mode)
            if i >= VIEWER_WARMUP:
                ms.append(v.last_frame_ms)
        per = frame_launches(before, counts())
        frames = VIEWER_WARMUP + VIEWER_FRAMES
        assert img.shape == (3, HEIGHT, WIDTH) and img.dtype == np.float32
        assert np.isfinite(img).all(), mode
        # one composite a frame in every mode: the point modes render a
        # frame for its deformation too, as trase_tpu's viewer does
        assert per == dict(composite_fwd=frames, composite_bwd=0,
                           reduce_pair_grads=0, deform_mlp=0), (mode, per)
        modes[mode] = {"frame_ms": float(np.mean(ms)), "frame_ms_all": ms,
                       "fps": 1000.0 / float(np.mean(ms)),
                       "composite_fwd_per_frame": per["composite_fwd"]
                       / frames, "mean": float(img.mean())}
    row["modes"] = modes

    # the Render frame's kernel output against the plain version
    with KernelCapture() as cap:
        base = v.render_frame("Render")
    row["render_vs_plain"] = cap.plain_err()
    assert row["render_vs_plain"] <= FWD_TOL, row["render_vs_plain"]
    a, _, _ = cap.calls[-1]
    row["render_pairs"] = int(a[2][-1])
    row["render_split_ms"] = render_split(v)

    # navigation moves the frame
    v.cam.orbit(300.0, 80.0)
    v.cam.scale(0.5)
    v.cam.pan(400.0, -200.0)
    moved = v.render_frame("Render")
    row["moved_max_abs_diff"] = float(np.abs(moved - base).max())
    assert row["moved_max_abs_diff"] > 0.05, row["moved_max_abs_diff"]
    aim(v)

    # editing: click -> removal -> save -> load -> composite
    px, py = covered_pixel(v)
    t0 = time.perf_counter()
    cid = v.click_select(px, py)
    row["click_s"] = time.perf_counter() - t0
    assert cid is not None, "no geometry under the centre pixel"
    selected = int(v.segmented_mask.sum())
    assert 0 < selected < n, selected
    removed = v.render_frame("Render", apply_selection_removal=True)
    row["removal_ms"] = v.last_frame_ms
    row["removal_changed_share"] = float(
        (np.abs(removed - base).max(axis=0) > 0).mean())
    assert row["removal_changed_share"] > 0.001, row
    obj = v.save_object(os.path.join(root, "viewer_object.ply"))
    n_obj = v.load_object(obj)
    assert n_obj == selected, (n_obj, selected)
    edit = dict(scales_bias=0.8, motion_bias=(1.5, 0.0, 0.0),
                rotation_bias=(0.0, 0.5, 0.0))
    before = counts()
    with KernelCapture() as cap:
        comp = v.render_composite_frame(**edit)
    comp_launch = frame_launches(before, counts())
    assert comp_launch == dict(composite_fwd=1, composite_bwd=0,
                               reduce_pair_grads=0, deform_mlp=0), comp_launch
    row["composite_vs_plain"] = cap.plain_err()
    assert row["composite_vs_plain"] <= FWD_TOL, row["composite_vs_plain"]
    assert comp.shape == (3, HEIGHT, WIDTH) and np.isfinite(comp).all()
    row["composite_changed_share"] = float(
        (np.abs(comp - base).max(axis=0) > 0).mean())
    assert row["composite_changed_share"] > 0.001, row
    ms = []
    for i in range(VIEWER_WARMUP + VIEWER_FRAMES):
        v.render_composite_frame(**edit)
        if i >= VIEWER_WARMUP:
            ms.append(v.last_frame_ms)
    row.update(click_pixel=(px, py), cluster_id=cid, selected=selected, object_gaussians=n_obj,
               object_capacity=int(v.object_params.xyz.shape[0]),
               composite_capacity=int(params.xyz.shape[0]
                                      + v.object_params.xyz.shape[0]),
               composite_ms=float(np.mean(ms)), composite_ms_all=ms,
               composite_launches=comp_launch["composite_fwd"])

    # the trajectory overlay over the selection
    import importlib.util

    v.toggle_trajectory(on=True, samp_num=8, gs_num=512)
    for i in range(4):
        v.fid = 0.2 + 0.1 * i
        img = v.render_frame("Render")
        assert img.shape == (3, HEIGHT, WIDTH) and np.isfinite(img).all()
    row["trajectory_ms"] = v.last_frame_ms
    v.show_trajectory = False
    plain = v.render_frame("Render")
    v.show_trajectory = True
    over = v.render_frame("Render")
    row["trajectory_changed_pixels"] = int(
        (np.abs(over - plain).max(axis=0) > 0).sum())
    row["trajectory_tracks"] = int(len(v._traj["ids"]))
    row["polylines"] = ("cv2" if importlib.util.find_spec("cv2")
                        else "numpy fallback")
    assert row["trajectory_changed_pixels"] > 0, row
    v.toggle_trajectory(on=False)
    v.clear_selection()
    aim(v)
    launches, layouts = counts(), layout_counts()

    row["card_vs_cpu"] = viewer_card_vs_cpu(seg_dir, seg_it, dev)
    return row, v, launches, layouts


def render_split(v, frames=VIEWER_FRAMES):
    """Host-clock split of the Render mode's frame, its steps as
    render_frame takes them: enqueue (camera, deform, render, uint8
    quantization), the wait for the device, the uint8 copy, the host's
    conversion to float32 [0, 1]. Medians over `frames` frames after one
    (the first frame after a large allocation pays the allocator's)."""
    split = {k: [] for k in ("enqueue", "device_wait", "copy_u8",
                             "to_float")}
    for i in range(frames + 1):
        t0 = time.perf_counter()
        out, _ = v._raw_frame()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        u8 = out["render_u8"].cpu().numpy()
        t3 = time.perf_counter()
        u8.transpose(2, 0, 1).astype(np.float32) / 255.0
        t4 = time.perf_counter()
        if i:
            for k, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                split[k].append(dt * 1e3)
    return {k: float(np.median(v)) for k, v in split.items()}


def viewer_card_vs_cpu(seg_dir, seg_it, dev):
    """The click workflow on phase 5's 2000-gaussian model directory (its
    clusters from the segment-cli phase), once on the card and once on the
    CPU: the same cluster id and selection mask, frames (the float render
    before the display quantization) within TOL_RENDER."""
    from trase_tpu_torch.viewer import HeadlessViewer

    got, pixel = {}, None
    for d in (dev, torch.device("cpu")):
        vv = HeadlessViewer.from_model_path(
            seg_dir, iteration=seg_it, W=VIEWER_CPU_SIZE,
            H=VIEWER_CPU_SIZE, device=d)
        aim(vv)
        pixel = pixel or covered_pixel(vv)  # the card's, for both
        frame = vv._raw_frame()[0]["render"].cpu()
        cid = vv.click_select(*pixel)
        assert cid is not None, pixel
        mask = vv.segmented_mask
        removal = vv._raw_frame(mask=~mask)[0]["render"].cpu()
        got[d.type] = (cid, mask.cpu(), frame, removal)
    card, cpu = got[dev.type], got["cpu"]
    out = {"size": VIEWER_CPU_SIZE, "click_pixel": pixel,
           "cluster_id": card[0],
           "cluster_id_cpu": cpu[0],
           "mask_equal": bool(torch.equal(card[1], cpu[1])),
           "selected": int(card[1].sum()),
           "frame_max_abs_diff": float((card[2] - cpu[2]).abs().max()),
           "removal_max_abs_diff": float((card[3] - cpu[3]).abs().max()),
           "tol": TOL_RENDER}
    assert out["cluster_id"] == out["cluster_id_cpu"], out
    assert out["mask_equal"] and out["selected"] > 0, out
    assert out["frame_max_abs_diff"] <= TOL_RENDER, out
    assert out["removal_max_abs_diff"] <= TOL_RENDER, out
    return out


def viewer_web_phase(v, click_pixel):
    """The viewer's web server on the card (module docstring, phase
    viewer-web). Returns (row, launches, layouts)."""
    import io
    import urllib.request

    from PIL import Image

    from trase_tpu_torch.viewer_web import ViewerServer

    srv = ViewerServer(v)
    port = srv.serve(port=0, host="127.0.0.1", block=False)
    base = f"http://127.0.0.1:{port}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=120) as r:
            return r.read()

    def cmd(**body):
        req = urllib.request.Request(
            base + "/cmd", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    def decoded(jpeg):
        with Image.open(io.BytesIO(jpeg)) as im:
            return np.asarray(im, np.int16)

    def against_render_frame(jpeg):
        """The served JPEG against a JPEG (the server's encoding) of
        render_frame at the same state: max abs difference in levels."""
        with srv.lock:
            img = v.render_frame(apply_selection_removal=srv.removal)
        arr = (np.clip(img.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=90)
        return int(np.abs(decoded(jpeg) - decoded(buf.getvalue())).max())

    row = {"phase": "viewer-web", "port": port}
    reset_counts()
    try:
        assert b"trase_tpu_torch viewer" in get("/")
        ms = []
        for i in range(1 + VIEWER_FRAMES):
            t0 = time.perf_counter()
            jpeg = get("/frame.jpg")
            if i:
                ms.append((time.perf_counter() - t0) * 1e3)
        assert decoded(jpeg).shape == (HEIGHT, WIDTH, 3)
        row.update(frame_jpg_ms=float(np.mean(ms)), frame_jpg_ms_all=ms,
                   jpeg_bytes=len(jpeg))
        diffs = {"initial": against_render_frame(jpeg)}
        steps = [("orbit", dict(cmd="orbit", dx=120, dy=30)),
                 ("mode_depth", dict(cmd="mode", name="Depth")),
                 ("mode_render", dict(cmd="mode", name="Render")),
                 ("click", dict(cmd="click", px=click_pixel[0],
                                py=click_pixel[1])),
                 ("removal", dict(cmd="removal", on=True)),
                 ("clear", dict(cmd="clear"))]
        states = {}
        for name, body in steps:
            st = cmd(**body)
            assert st["ok"], st
            states[name] = {k: st[k] for k in ("mode", "selected",
                                               "removal", "ms")}
            diffs[name] = against_render_frame(get("/frame.jpg"))
        assert states["click"]["selected"], states
        assert cmd(cmd="trajectory", on=True)["msg"].endswith(" on")
        for fid in (0.3, 0.4, 0.5):
            cmd(cmd="time", fid=fid)
            assert decoded(get("/frame.jpg")).shape == (HEIGHT, WIDTH, 3)
        assert cmd(cmd="trajectory", on=False)["msg"].endswith(" off")
        row.update(vs_render_frame_levels=diffs, states=states)
        # the served frames are the render_frame frames bit for bit: the
        # JPEGs of one uint8 image decode to the same pixels
        assert not any(diffs.values()), diffs
    finally:
        srv.shutdown()
    assert srv._httpd is None
    return row, counts(), layout_counts()


def mask_unpack_check(dev) -> dict:
    """The mask unpack kernel at the benchmark's stack (MASK_UNPACK_SHAPE
    into MASK_UNPACK_M_MAX) on seeded bits: equal to unpack_masks_plain on
    the same bits on the card, one counted launch; its queued ms beside
    the bits' upload from page-locked memory, the plain version's ms and
    the bound (the float32 stack written and the bits read at
    HBM_BYTES_PER_S)."""
    from trase_tpu_torch.ops import cuda_lib as CL
    from trase_tpu_torch.ops import mask_unpack as MU

    n, h, w = MASK_UNPACK_SHAPE
    m_max = MASK_UNPACK_M_MAX
    packed = np.random.default_rng(19).integers(0, 256, n * h * w // 8,
                                                dtype=np.uint8)
    host = torch.from_numpy(packed).pin_memory() if dev.type == "cuda" \
        else torch.from_numpy(packed)
    bits = host.to(dev)
    before = CL.LAYOUT_LAUNCHES.get(("mask_unpack",), 0)
    got = MU.unpack_masks(bits, n, h, w, m_max)
    if dev.type == "cuda":
        assert CL.LAYOUT_LAUNCHES[("mask_unpack",)] == before + 1
    ref = MU.unpack_masks_plain(bits, n, h, w, m_max)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.equal(got, ref), "mask_unpack differs from its plain version"
    max_abs_err = float((got - ref).abs().max())
    del got, ref
    reps = repeated_ms({
        "kernel": lambda: MU.unpack_masks(bits, n, h, w, m_max),
        "upload": lambda: host.to(dev, non_blocking=True)})
    moved = {"written": m_max * h * w * 4, "read": bits.numel()}
    return {"shape": [n, h, w], "m_max": m_max, "max_abs_err": max_abs_err,
            "equal_to_plain": True, "ms": reps["kernel"]["median"],
            "ms_repeats": reps["kernel"],
            "plain_ms": cuda_ms(
                lambda: MU.unpack_masks_plain(bits, n, h, w, m_max), 5),
            "bound_ms": sum(moved.values()) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes": moved,
            "bits_upload_ms": reps["upload"]["median"],
            "bits_upload_ms_repeats": reps["upload"]}


def mask_io_phase(root, dev):
    """Host IO on the card's machine (module docstring, phase mask-io).
    Returns (row, launches, layouts)."""
    import shutil

    from PIL import Image

    from trase_tpu_torch import native
    from trase_tpu_torch import train as train_cli
    from trase_tpu_torch.data import masks as DM
    from trase_tpu_torch.data.synthetic import write_synthetic_dataset
    from trase_tpu_torch.engine import loop as TL
    from trase_tpu_torch.ops import cuda_lib as CL

    t0 = time.perf_counter()
    assert native.available(), "native/trase_io.cpp did not build"
    row = {"phase": "mask-io", "native_build_s": time.perf_counter() - t0,
           "cameras": MASK_CAMS, "masks": MASK_N}
    rng = np.random.default_rng(9)
    files = {}
    for h, w in MASK_SIZES:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        c = rng.uniform(0.1, 0.9, size=(MASK_N, 2)) * (h, w)
        r = rng.uniform(0.05, 0.3, size=(MASK_N, 2)) * (h, w)
        stack = (((yy - c[:, :1, None]) / r[:, :1, None]) ** 2
                 + ((xx - c[:, 1:, None]) / r[:, 1:, None]) ** 2) <= 1.0
        d = os.path.join(root, f"masks_{h}x{w}")
        os.makedirs(d)
        files[(h, w)] = []
        for i in range(MASK_CAMS):
            p = os.path.join(d, f"cam_{i:04d}.npz")
            DM.save_mask_file(p, np.roll(stack, 7 * i, axis=2))
            files[(h, w)].append(p)
    sizes = {}
    for (h, w), paths in files.items():
        t = {"numpy": [], "native": [], "bits": []}
        for p in paths:
            t0 = time.perf_counter()
            plain = DM.pad_masks(DM.decode_mask_file(p), MASK_N)
            t["numpy"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            fast = DM.load_padded_masks(p, MASK_N)
            t["native"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            bits = DM.load_stack(p, MASK_N)
            t["bits"].append((time.perf_counter() - t0) * 1e3)
            assert np.array_equal(plain.masks, fast.masks)
            assert np.array_equal(plain.valid, fast.valid)
            assert bits.shape == (MASK_N, h, w)
            assert bits.bits.is_pinned() == (dev.type == "cuda")
        sizes[f"{h}x{w}"] = {
            "numpy_ms": float(np.median(t["numpy"])),
            "native_ms": float(np.median(t["native"])),
            "bits_ms": float(np.median(t["bits"])),
            "numpy_ms_all": t["numpy"], "native_ms_all": t["native"],
            "bits_ms_all": t["bits"],
            "npz_mb": os.path.getsize(paths[0]) / 2**20, "bit_identical": True}
    row["load_padded_masks"] = sizes

    h, w = MASK_SIZES[-1]
    png = os.path.join(root, "gt.png")
    Image.fromarray(rng.integers(0, 256, (h, w, 4), np.uint8)).save(png)
    bg = np.zeros(3, np.float32)
    t = {"pil_decode": [], "numpy": [], "native": []}
    for _ in range(5):
        t0 = time.perf_counter()
        with Image.open(png) as im:
            rgba = np.asarray(im.convert("RGBA"))
        t1 = time.perf_counter()
        data = rgba.astype(np.float32) / 255.0
        a = data[..., 3:4]
        ref = np.ascontiguousarray(
            (data[..., :3] * a + bg * (1.0 - a)).transpose(2, 0, 1))
        t2 = time.perf_counter()
        got = native.rgba_to_rgb_f32(rgba, bg)
        t3 = time.perf_counter()
        for k, dt in zip(t, (t1 - t0, t2 - t1, t3 - t2)):
            t[k].append(dt * 1e3)
    row["rgba_to_rgb_f32"] = {
        "size": f"{h}x{w}", **{f"{k}_ms": float(np.median(v))
                               for k, v in t.items()},
        "max_abs_diff": float(np.abs(got - ref).max()), "tol": 1e-6}
    assert row["rgba_to_rgb_f32"]["max_abs_diff"] <= 1e-6, row

    # FEATURE steps of the loop, every step's stack decoded from disk (a
    # mask cache of one stack), with the prefetcher and inline
    src = os.path.join(root, "mask_io_data")
    write_synthetic_dataset(src, n_train=MASK_CAMS, n_test=1,
                            image_size=MASK_LOOP_SIZE, fast_gt=True,
                            device=dev)
    mdir = os.path.join(src, "images", "masks")
    for i, p in enumerate(files[MASK_SIZES[0]]):
        shutil.copy(p, os.path.join(mdir, f"train_{i:04d}.npz"))
    waits, inline = [], []
    get, load = DM.MaskPrefetcher.get, TL.load_stack
    submit = TL.Trainer._submit_mask_prefetch

    def timed_get(self):
        t0 = time.perf_counter()
        out = get(self)
        waits.append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_load(*a, **kw):
        t0 = time.perf_counter()
        out = load(*a, **kw)
        inline.append((time.perf_counter() - t0) * 1e3)
        return out

    row["mask_unpack"] = mask_unpack_check(dev)
    loops = {}
    cache = TL.MASK_CACHE_SIZE, TL.MASK_CACHE_CAP
    reset_counts()
    for arm in ("prefetch", "inline"):
        waits.clear()
        inline.clear()
        fetch = dict(TL.MASK_FETCH)
        unpacks = CL.LAYOUT_LAUNCHES.get(("mask_unpack",), 0)
        DM.MaskPrefetcher.get, TL.load_stack = timed_get, timed_load
        TL.MASK_CACHE_SIZE = TL.MASK_CACHE_CAP = 1
        if arm == "inline":
            TL.Trainer._submit_mask_prefetch = lambda self, cam: None
        t0 = time.perf_counter()
        iters = 2 * MASK_LOOP_FEATURE + 2
        try:
            tr = train_cli.main([
                "-s", src, "-m", os.path.join(root, f"mask_io_{arm}"),
                "--iterations", str(iters), "--device", dev.type, "--quiet",
                "--warm_up", "2", "--warm_up_3d_features",
                str(MASK_LOOP_FEATURE + 2), "--iterative_opt_interval",
                str(MASK_LOOP_FEATURE), "--densify_until_iter", "0",
                "--num_sampled_pixels", "1024", "--num_sampled_masks", "8",
                "--pairs_per_gaussian", "16", "--load_mask_on_the_fly",
                "--save_iterations", str(iters)])
        finally:
            DM.MaskPrefetcher.get, TL.load_stack = get, load
            TL.MASK_CACHE_SIZE, TL.MASK_CACHE_CAP = cache
            TL.Trainer._submit_mask_prefetch = submit
        seconds = time.perf_counter() - t0
        assert tr.feature_calls == MASK_LOOP_FEATURE + 1, tr.feature_calls
        assert tr._prefetcher is None
        fetch = {f"{k[0]}.{k[1]}": TL.MASK_FETCH[k] - fetch.get(k, 0)
                 for k in TL.MASK_FETCH if TL.MASK_FETCH[k] != fetch.get(k, 0)}
        unpacks = CL.LAYOUT_LAUNCHES.get(("mask_unpack",), 0) - unpacks
        # every miss of a native file goes up as bits, one unpack each
        assert fetch.get("bits.miss", 0) > 0 and "float32.miss" not in fetch, \
            fetch
        if dev.type == "cuda":
            assert unpacks == fetch["bits.miss"], (unpacks, fetch)
        loops[arm] = {"seconds": seconds, "feature_steps": tr.feature_calls,
                      "mask_fetch": fetch, "unpack_launches": unpacks,
                      "prefetch_gets": len(waits),
                      "prefetch_wait_ms_per_step": sum(waits)
                      / tr.feature_calls,
                      "inline_decodes": len(inline),
                      "inline_decode_ms_per_step": sum(inline)
                      / tr.feature_calls,
                      "it_per_s": iters / seconds}
    assert loops["prefetch"]["prefetch_gets"] > 0, loops
    assert loops["inline"]["inline_decodes"] >= loops["inline"][
        "feature_steps"], loops
    row["loop"] = dict(loops, mask_size=f"{MASK_SIZES[0][0]}x"
                       f"{MASK_SIZES[0][1]}", image_size=MASK_LOOP_SIZE)
    return row, counts(), layout_counts()


class PlainKernels:
    """Inside the with-block the compositor's forward, backward and reduce
    run through their plain PyTorch versions, also on CUDA tensors (the
    plain arm of a whole-step comparison; they count no launch)."""

    NAMES = (("composite_fwd", "composite_plain"),
             ("composite_bwd", "composite_bwd_plain"),
             ("reduce_pair_grads", "reduce_pair_grads_plain"))

    def __enter__(self):
        from trase_tpu_torch.ops import rasterize_cuda as RC

        self.RC = RC
        self.saved = {k: getattr(RC, k) for k, _ in self.NAMES}
        for k, plain in self.NAMES:
            setattr(RC, k, getattr(RC, plain))
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(self.RC, k, fn)


def style_image(h, w, seed=9):
    """A seeded (3, h, w) style image in [0, 1]: flat tiles on the left
    half (identical VGG columns: ties in the NNFM max), a striped texture
    with noise on the right."""
    rng = np.random.default_rng(seed)
    img = np.empty((3, h, w), np.float32)
    half = w // 2
    tiles = rng.uniform(size=(3, 4, 4)).astype(np.float32)
    img[:, :, :half] = np.repeat(np.repeat(tiles, -(-h // 4), axis=1),
                                 -(-half // 4), axis=2)[:, :h, :half]
    yy, xx = np.mgrid[0:h, 0:w - half].astype(np.float32)
    tex = 0.5 + 0.3 * np.sin(xx / 7.0)[None] * np.cos(yy / 11.0)[None]
    img[:, :, half:] = np.clip(
        tex + 0.15 * rng.normal(size=(3, h, w - half)), 0, 1)
    return img


def style_mask(params, aux, dev):
    """One octant of the bench cloud around VIEWER_TARGET, as
    grouped_features groups it (about 1/8 of the gaussians)."""
    xyz = params.xyz - torch.tensor(VIEWER_TARGET, device=dev)
    octant = ((xyz[:, 0] > 0).long() * 4 + (xyz[:, 1] > 0).long() * 2
              + (xyz[:, 2] > 0).long())
    return (octant == STYLE_OCTANT) & aux.alive


def style_reference(vgg, h, w, dev):
    """The style image's conv4_1 features, (512, h/8 * w/8), normalized
    twice as the style CLI does."""
    img = torch.from_numpy(style_image(h, w)).to(dev)
    with torch.no_grad():
        f = vgg(vgg.normalize(img))[STYLE_KEY][0]
    return f.reshape(f.shape[0], -1)


def vgg_flops(h, w, last=(3, 0)):
    """Multiply-adds x 2 of VGG16's convolutions up to `last` at h x w."""
    from trase_tpu_torch.models.vgg import VGG16_BLOCKS

    total, in_c = 0, 3
    for bi, block in enumerate(VGG16_BLOCKS):
        for ci, out_c in enumerate(block):
            if (bi, ci) > last:
                return total
            total += 2 * (h >> bi) * (w >> bi) * in_c * out_c * 9
            in_c = out_c
    return total


def vgg_probe(vgg, h, w, dev) -> dict:
    """ms (CUDA events) of the extractor's forward to STYLE_KEY and its
    input gradient at h x w, with cuDNN's heuristic algorithm choice (the
    port's setting) and with torch.backends.cudnn.benchmark on (cuDNN
    times its algorithms per shape on the first call; restored after)."""
    x = torch.rand((3, h, w), device=dev, generator=torch.Generator(
        device=dev).manual_seed(4)).requires_grad_(True)

    def fwd_bwd():
        torch.autograd.grad(vgg(x)[STYLE_KEY].sum(), x)

    out = {"heuristic": cuda_ms(fwd_bwd, 3)}
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        out["cudnn_benchmark"] = cuda_ms(fwd_bwd, 3)
    finally:
        torch.backends.cudnn.benchmark = saved
    return out


def style_step_fn(state, cam, net, cfg, dev, vgg, ref, mask, carry=True):
    """One style step of the bench scene per call (bf16 deform stack,
    VGG16 conv4_1, SH 3); returns its metrics. With `carry` each call
    continues from the last call's state, else starts from `state`."""
    from trase_tpu_torch.config import OptimizationParams
    from trase_tpu_torch.engine import trainer as TT

    lrs = TT.make_learning_rate_schedules(OptimizationParams())(1)
    bg = torch.zeros(3, device=dev)
    box = {"state": state, "vgg": vgg}

    def step():
        new, m = TT.style_phase_step(
            box["state"], cam, ref, mask, 0.5, lrs, bg, deform_net=net,
            vgg_ext=box["vgg"], sh_degree=3, use_deform=True,
            is_6dof=False, fx_key=STYLE_KEY, raster_cfg=cfg)
        if carry:
            box["state"] = new
        box["last"] = new
        return m

    step.box = box
    return step


def small_style_scene(dev):
    """Phase 3's small scene (the same draws) as a gaussian field, SH 1,
    seen by its camera."""
    from trase_tpu_torch.models import gaussians as G
    from trase_tpu_torch.renderer import make_render_camera

    rng = np.random.default_rng(1)
    n, H, W = 400, 96, 128
    means = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    means[:, 2] += 5.0
    scales = rng.uniform(0.05, 0.3, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, size=n).astype(np.float32)
    params, aux = G.from_point_cloud(means, colors, sh_degree=1,
                                     capacity=512, device=dev)

    def rows(field, values):
        out = field.clone()
        out[:n] = torch.tensor(values, device=dev).reshape(out[:n].shape)
        return out

    params = params._replace(
        scaling=rows(params.scaling, np.log(scales)),
        rotation=rows(params.rotation, quats),
        opacity=rows(params.opacity, np.log(opac / (1 - opac))))
    cam = make_render_camera(np.eye(3), np.zeros(3), 1.0, 0.8, H, W,
                             device=dev)
    return params, aux, cam


def style_vs_plain(net, vgg, dev) -> dict:
    """One style step on phase 3's small scene through the kernels and the
    same step through their plain versions on the card (not counted): the
    loss bit for bit, the colours' Adam moments within STYLE_TOL of their
    scale, the colours where the gradient is clearly nonzero within
    STYLE_TOL."""
    from trase_tpu_torch.ops.rasterize import RasterConfig

    params, aux, cam = small_style_scene(dev)
    mask = (params.xyz[:, 0] > 0) & aux.alive
    ref = style_reference(vgg, cam.image_height, cam.image_width, dev)
    state = train_state(params, aux, net)
    cfg = RasterConfig(pairs_per_gaussian=16)
    step = style_step_fn(state, cam, net, cfg, dev, vgg, ref, mask,
                         carry=False)
    m = step()
    kern = step.box["last"]
    with PlainKernels():
        rm = step()
    plain = step.box["last"]
    torch.cuda.synchronize()
    out = {"gaussians": 400, "height": cam.image_height,
           "width": cam.image_width, "tol": STYLE_TOL,
           "loss": float(m["loss"]), "loss_plain": float(rm["loss"])}
    bad = []
    if out["loss"] != out["loss_plain"]:
        bad.append("loss")
    for k in ("features_dc", "features_rest"):
        a, b = getattr(kern.opt, k), getattr(plain.opt, k)
        for part in ("mu", "nu"):
            x, y = getattr(a, part), getattr(b, part)
            out[f"{k}_{part}_rel_err"] = err = float(
                (x - y).abs().max() / y.abs().max())
            if not err < STYLE_TOL:
                bad.append(f"{k} {part}")
        big = b.mu.abs() > 0.05 * b.mu.abs().max()
        p, q = getattr(kern.params, k), getattr(plain.params, k)
        out[f"{k}_rel_err"] = err = float((p - q)[big].abs().max()
                                          / q[big].abs().max())
        if not err < STYLE_TOL:
            bad.append(k)
    if bad:
        raise AssertionError(f"style step kernels vs plain: {bad}: {out}")
    return out


def style_phase(params, aux, cam, net, cfg, dev):
    """The style step at full width (module docstring, phase style).
    Returns (row, the step for the profile, launches, layouts)."""
    from trase_tpu_torch.engine import trainer as TT
    from trase_tpu_torch.losses import style as LS
    from trase_tpu_torch.models.vgg import make_vgg16_extractor

    H, W = cam.image_height, cam.image_width
    t0 = time.perf_counter()
    vgg = make_vgg16_extractor([STYLE_KEY], device=dev)
    ref = style_reference(vgg, H, W, dev)
    setup_s = time.perf_counter() - t0
    mask = style_mask(params, aux, dev)
    init = train_state(params, aux, net)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = style_step_fn(init, cam, net, cfg, dev, vgg, ref, mask)
    reset_counts()
    losses = [step()["loss"] for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    finite = []
    for _ in range(STYLE_STEPS):
        m = step()
        losses.append(m["loss"])
        finite.append(m["finite"])
    end.record()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / STYLE_STEPS * 1e3
    step_ms_events = start.elapsed_time(end) / STYLE_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches, layouts = counts(), layout_counts()
    n_steps = TRAIN_WARMUP + STYLE_STEPS
    assert launches == dict(compositor(n_steps), deform_mlp=0), launches
    assert layouts == {"composite_fwd/4/0/1/1": n_steps,
                       "composite_bwd/4/0/1/0": n_steps,
                       "reduce_pair_grads/10": n_steps}, layouts
    losses = [float(x) for x in losses]
    assert all(bool(f) for f in finite), "a style step was skipped"
    assert losses[-1] < losses[0], losses
    state = step.box["state"]
    changed = changed_fields(init, state)
    assert changed == ["params.features_dc", "params.features_rest",
                       "aux.max_radii2d", "aux.xyz_gradient_accum",
                       "aux.denom", "opt.features_dc",
                       "opt.features_rest"], changed
    for k in ("features_dc", "features_rest"):
        new, old = getattr(state.params, k), getattr(init.params, k)
        assert torch.equal(new[~mask], old[~mask]), k
        assert not torch.equal(new[mask], old[mask]), k
        for part in ("mu", "nu"):
            a = getattr(getattr(state.opt, k), part)
            b = getattr(getattr(init.opt, k), part)
            assert torch.equal(a[~mask], b[~mask]), (k, part)

    # the split, on steps from the initial state (wrapped calls)
    fixed = style_step_fn(init, cam, net, cfg, dev, vgg, ref, mask,
                          carry=False)
    fixed()
    timer = StageTimer(style=True)
    fixed.box["vgg"] = timer.timed_vgg(vgg)
    try:
        splits = []
        for _ in range(4):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fixed()
            b.record()
            splits.append(timer.step_split(a, b))
    finally:
        timer.restore()
        fixed.box["vgg"] = vgg
    split = {k: sum(sp[k] for sp in splits[1:]) / (len(splits) - 1)
             for k in splits[-1]}
    split["nnfm"] = split.pop("loss")
    split["vgg_and_rest_bwd"] = (split["backward_total"]
                                 - split.get("composite_bwd", 0.0)
                                 - split.get("reduce", 0.0))
    n_cols = (H // 8) * (W // 8)
    flops = 2 * vgg_flops(H, W) + 2 * 2 * n_cols * n_cols * 512
    kvp = style_vs_plain(net, vgg, dev)
    probe = vgg_probe(vgg, H, W, dev)
    row = {"phase": "style", "gaussians": int(aux.alive.sum()),
           "capacity": int(params.xyz.shape[0]), "height": H, "width": W,
           "styled_gaussians": int(mask.sum()), "fx_key": STYLE_KEY,
           "vgg": "VGG16, seeded fallback", "nnfm_columns": [n_cols,
                                                             n_cols],
           "setup_s": setup_s, "steps": n_steps, "timed_steps": STYLE_STEPS,
           "step_ms": step_ms, "step_ms_events": step_ms_events,
           "stage_ms": split, "peak_memory_gib": peak,
           "flops_per_step": flops,
           "floor_ms_f32": flops / F32_FLOPS_PER_S * 1e3,
           "vgg_fwd_bwd_ms": probe,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "changed": changed,
           "kernels_vs_plain": kvp}
    return row, fixed, launches, layouts


def style_cli_phase(root, src, seg, it, sid, n_train, n_test, dev):
    """The style CLI on a copy of the segment-cli phase's model directory
    (snapshot, deform.pkl; clusters.pt from its k-means clusters: the
    card's machine has no sklearn for HDBSCAN), styling cluster `sid`
    for STYLE_CLI_ITERATIONS iterations against a seeded PNG; then the
    render CLI on its snapshot. Checks: one launch of each compositor
    kernel per iteration, only the object's colours moved, the renders'
    PNGs."""
    import shutil

    from PIL import Image

    from trase_tpu_torch import render as cli
    from trase_tpu_torch import train_style_transfer_nnfm as style_cli
    from trase_tpu_torch.cluster import load_clusters
    from trase_tpu_torch.engine import trainer as TT
    from trase_tpu_torch.models.gaussians_io import load_gaussian_ply

    mdl = os.path.join(root, "styled")
    shutil.copytree(seg, mdl)
    cdir = os.path.join(mdl, "point_cloud", f"iteration_{it}")
    shutil.copyfile(os.path.join(cdir, "clusters_kmeans.pt"),
                    os.path.join(cdir, "clusters.pt"))
    ids, _ = load_clusters(os.path.join(cdir, "clusters.pt"))
    png = os.path.join(root, "style.png")
    Image.fromarray((style_image(128, 128).transpose(1, 2, 0) * 255)
                    .astype(np.uint8)).save(png)
    end = it + STYLE_CLI_ITERATIONS
    starts = []
    step = TT.style_phase_step

    def timed(*a, **kw):
        starts.append(time.perf_counter())
        return step(*a, **kw)

    TT.style_phase_step = timed
    reset_counts()
    t0 = time.perf_counter()
    try:
        trainer = style_cli.main([
            "-s", src, "-m", mdl, "--eval", "--load_iteration", str(it),
            "--iterations", str(end), "--segment_ids", str(sid),
            "--reference_img_path", png, "--quiet", "--device", dev.type])
    finally:
        TT.style_phase_step = step
    seconds = time.perf_counter() - t0
    launches, layouts = counts(), layout_counts()
    assert launches == dict(compositor(STYLE_CLI_ITERATIONS),
                            deform_mlp=0), launches
    assert np.isfinite(trainer.ema_loss), trainer.ema_loss
    before = load_gaussian_ply(os.path.join(cdir, "point_cloud.ply"),
                               device="cpu")
    after = load_gaussian_ply(os.path.join(
        mdl, "point_cloud", f"iteration_{end}", "point_cloud.ply"),
        device="cpu")
    n = before[2]
    obj = torch.from_numpy(ids[:n] == sid)
    moved = {}
    for k in ("features_dc", "features_rest"):
        a, b = getattr(after[0], k)[:n], getattr(before[0], k)[:n]
        assert torch.equal(a[~obj], b[~obj]), k
        moved[k] = int((a[obj] != b[obj]).flatten(1).any(1).sum())
        assert moved[k] > 0, k
    for k in ("xyz", "opacity", "scaling", "rotation"):
        assert torch.equal(getattr(after[0], k), getattr(before[0], k)), k
    cli.main(["-s", src, "-m", mdl, "--iteration", str(end),
              "--pairs_per_gaussian", "6", "--device", dev.type])
    pngs = check_pngs(mdl, end, n_train, n_test)
    return {"phase": "style-cli", "iterations": STYLE_CLI_ITERATIONS,
            "segment_id": sid, "object_gaussians": int(obj.sum()),
            "gaussians": n, "seconds": seconds,
            "s_per_iteration": (starts[-1] - starts[0]) / (len(starts) - 1),
            "ema_loss": trainer.ema_loss, "moved_rows": moved,
            "png_counts": pngs, "launches": launches, "layouts": layouts}


def lpips_phase(root, seg, bench, it, dev):
    """LPIPS through the metrics CLI (--vgg_weights: a seeded VGG16 in
    trase_tpu's .npz format; --lpips_weights: seeded heads) on the
    segment-cli phase's outputs, on the card and with --device cpu (the
    column within LPIPS_TOL); then ms per make_lpips call on a 1008x1344
    pair (VGG16 through conv5_3, twice)."""
    from trase_tpu_torch import metrics_segmentation as metrics_cli
    from trase_tpu_torch.losses.lpips import _LPIPS_CHANNELS, make_lpips
    from trase_tpu_torch.models.vgg import VGG16_BLOCKS, seeded_weights

    rng = np.random.default_rng(13)
    vgg = os.path.join(root, "vgg16_seeded.npz")
    np.savez(vgg, **{f"{bi}_{ci}.{p}": v for (bi, ci), (w, b)
                     in seeded_weights(VGG16_BLOCKS, 3).items()
                     for p, v in (("w", w), ("b", b))})
    lin = os.path.join(root, "lpips_lin.npz")
    np.savez(lin, **{f"lin{i}": rng.uniform(0, 0.2, c).astype(np.float32)
                     for i, c in enumerate(_LPIPS_CHANNELS)})
    reset_counts()
    out = {"phase": "lpips", "tol": LPIPS_TOL}
    for device in (dev.type, "cpu"):
        t0 = time.perf_counter()
        metrics_cli.main(["-m", seg, "--benchmark_path", bench,
                          "--vgg_weights", vgg, "--lpips_weights", lin,
                          "--device", device])
        out[f"metrics_cli_s_{device}"] = time.perf_counter() - t0
        with open(os.path.join(seg, "results.json")) as f:
            out[f"lpips_{device}"] = json.load(f)[f"ours_{it}"]["LPIPS"]
        with open(os.path.join(seg, "per_view.json")) as f:
            per_view = json.load(f)[f"ours_{it}"]["LPIPS"]
        assert per_view and all(np.isfinite(v) for v in per_view.values())
    launches, layouts = counts(), layout_counts()
    assert launches == dict(compositor(0), deform_mlp=0), launches
    got, want = out[f"lpips_{dev.type}"], out["lpips_cpu"]
    assert np.isfinite(got) and got > 0, got
    out["card_vs_cpu"] = abs(got - want)
    assert out["card_vs_cpu"] <= LPIPS_TOL, out
    fn = make_lpips(vgg, lin, device=dev)
    a = torch.rand((3, HEIGHT, WIDTH), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(0))
    b = (a + 0.1 * torch.randn(a.shape, device=dev, generator=torch
                               .Generator(device=dev).manual_seed(1))
         ).clamp(0, 1)
    with torch.no_grad():
        out["value_1008x1344"] = float(fn(a, b))
        out["ms_1008x1344"] = cuda_ms(lambda: fn(a, b), 5)
    last = (len(VGG16_BLOCKS) - 1, len(VGG16_BLOCKS[-1]) - 1)
    out["floor_ms_f32"] = 2 * vgg_flops(HEIGHT, WIDTH, last) \
        / F32_FLOPS_PER_S * 1e3
    return out, launches, layouts


def losses_3d_calls(feats, probs, xyz, xyz2, nbr, gen=None,
                    sample_idx=None) -> dict:
    """{name: thunk} of the four 3D losses on these tensors; the
    subsamples from `gen`, or loss_cls_3d's sample from `sample_idx`."""
    from trase_tpu_torch.losses import losses_3d as L3

    return {
        "loss_cls_3d": lambda: L3.loss_cls_3d(
            feats, probs, generator=gen, sample_idx=sample_idx),
        "loss_reg_3d_feature": lambda: L3.loss_reg_3d_feature(
            feats, xyz, 5),
        "loss_feature3d": lambda: L3.loss_feature3d(feats, xyz,
                                                    generator=gen),
        "rigid_body_motion_loss": lambda: L3.rigid_body_motion_loss(
            xyz, xyz2, nbr),
    }


def losses_3d_phase(params, net, dev) -> dict:
    """The four 3D losses on the bench scene's capacity rows (features,
    class probabilities from a seeded projection of them, positions, the
    deformed positions at t = 0.5, their 8 nearest neighbours): ms (CUDA
    events) and finiteness; then card against CPU on a LOSS3D_SUBSET-row
    subset with loss_cls_3d's sample passed as an index array (the subset
    needs no other subsample)."""
    from trase_tpu_torch.ops.knn import knn

    gen = torch.Generator(device=dev).manual_seed(2)
    feats, xyz = params.gaussian_features, params.xyz
    proj = torch.randn((feats.shape[1], 16), device=dev, generator=gen)
    with torch.no_grad():
        probs = torch.softmax(feats @ proj, dim=1)
        xyz2 = xyz + deltas(params, net, 0.5)[0]
        nbr = knn(xyz, xyz, 8)[1]
    out = {"phase": "losses-3d", "points": int(xyz.shape[0]),
           "subset": LOSS3D_SUBSET, "tol": LOSS3D_TOL, "rigid_tol": RIGID_TOL}
    with torch.no_grad():
        for name, fn in losses_3d_calls(feats, probs, xyz, xyz2, nbr,
                                        gen).items():
            out[name] = float(fn())
            out[f"{name}_ms"] = cuda_ms(fn, 3)
            assert np.isfinite(out[name]), (name, out[name])
    m = LOSS3D_SUBSET
    sample = torch.randperm(m, generator=torch.Generator().manual_seed(3))
    sub = {}
    for where in (dev.type, "cpu"):
        t = [x[:m].to(where) for x in (feats, probs, xyz, xyz2)]
        with torch.no_grad():
            calls = losses_3d_calls(*t, knn(t[2], t[2], 8)[1],
                                    sample_idx=sample[:800])
            sub[where] = {k: float(fn()) for k, fn in calls.items()}
    for name, want in sub["cpu"].items():
        err = abs(sub[dev.type][name] - want) / max(abs(want), 1e-12)
        out[f"{name}_card_vs_cpu"] = err
        tol = RIGID_TOL if name.startswith("rigid") else LOSS3D_TOL
        assert err <= tol, (name, sub[dev.type][name], want)
    return out


def group_rel(a, b, words, skip_geometry=False):
    """Max abs difference of a against b over each column group's largest
    magnitude (mean2d, conic, log opacity, values)."""
    out = {}
    for name, (lo, hi) in dict(GEOM_GROUPS, values=(6, words)).items():
        if skip_geometry and name != "values":
            continue
        d = float((a[:, lo:hi] - b[:, lo:hi]).abs().max())
        out[name] = d / (float(b[:, lo:hi].abs().max()) + 1e-30)
    return out


def slab_compare(label, proj, feats, H, W, cfg, pack, with_color):
    """The compositor kernels' slab mode at one layout: the image's tile
    rows padded to a multiple of MESH_SLABS and split in that many slabs,
    the binning at the padded height (as composite_slab does). Each slab's
    forward (image and residuals) against the plain slab bit for bit, the
    slabs concatenated against the whole-image kernel bit for bit; each
    slab's backward and reduce under its rows of one seeded cotangent
    against their plain versions within BWD_TOL, its pair rows against the
    whole-image backward's bit for bit, and the slabs' payload gradients
    summed against the whole image's within SLAB_SUM_TOL; then each slab's
    kernels and the whole image's timed in interleaved queued rounds."""
    from trase_tpu_torch.ops import cuda_lib as CL
    from trase_tpu_torch.ops import rasterize_cuda as RC
    from trase_tpu_torch.ops.rasterize import _tile_grid

    th, tw = _tile_grid(H, W)
    rows_pad = -(-th // MESH_SLABS) * MESH_SLABS
    rows_local = rows_pad // MESH_SLABS
    h_pad = rows_pad * 16
    ci = RC.composite_inputs(proj, feats, h_pad, W,
                             cfg._replace(pack_features=pack), with_color)
    n_val, n_packed = ci.n_val, ci.n_packed
    kpay = (RC.pack_feature_words(ci.payload, n_val, n_packed, with_color)
            if n_packed else ci.payload)
    args = (kpay, ci.sorted_gauss, ci.tile_start, h_pad, W, n_val, n_packed)
    kw = dict(with_color=with_color)
    dev = kpay.device
    gen = torch.Generator(device=dev).manual_seed(3)
    g = torch.randn((h_pad, W, 1 + n_val), generator=gen, device=dev)
    n, words = ci.payload.shape[0], 6 + n_val
    inv = RC.inverse_pairs(ci.sorted_pid)
    full, flogt, fstop = RC.composite_fwd(*args, residuals=True, **kw)
    fpair = RC.composite_bwd(*args, g, flogt, fstop, **kw)
    fpay = RC.reduce_pair_grads(fpair, inv, ci.tile_start, n)
    total = torch.zeros_like(fpay)
    slabs, per_slab, bad = [], [], []
    lib = CL.library("composite_bwd", RC.BWD_SIGNATURES)

    def per_gaussian(dpair, sl):
        """The whole image's reduce kernel over the slab's pair range
        (every gaussian's K positions read), the slab reduce's yardstick."""
        out = torch.empty((n, words), device=dev)
        rc = lib.trase_reduce_pair_grads(
            dpair.data_ptr(), inv.data_ptr(),
            ci.tile_start[sl["t_lo"]:].data_ptr(),
            ci.tile_start[sl["t_hi"]:].data_ptr(), n, inv.numel() // n, words,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        assert rc == 0, rc
        return out

    fns = {"fwd_full": lambda: RC.composite_fwd(*args, residuals=True, **kw),
           "bwd_full": lambda: RC.composite_bwd(*args, g, flogt, fstop,
                                                **kw),
           "reduce_full": lambda: RC.reduce_pair_grads(fpair, inv,
                                                       ci.tile_start, n),
           # the slab reduce's walk over the whole image, beside the
           # whole image's own reduce
           "walk_full": lambda: RC.reduce_pair_grads(
               fpair, inv, ci.tile_start, n, t_lo=0, t_hi=rows_pad * tw,
               sorted_gauss=ci.sorted_gauss)}
    walk_equal = bool(torch.equal(fns["walk_full"](), fpay))
    if not walk_equal:
        bad.append("the slab walk over the whole image != the whole reduce")
    for r in range(MESH_SLABS):
        sl = dict(t_lo=r * rows_local * tw, t_hi=(r + 1) * rows_local * tw)
        rows = slice(r * rows_local * 16, (r + 1) * rows_local * 16)
        out, logt, stop = RC.composite_fwd(*args, residuals=True, **kw, **sl)
        torch.cuda.synchronize()
        fstats = {}
        ref = RC.composite_plain(*args, residuals=True, stats=fstats, **kw,
                                 **sl)
        fwd = {"image": float((out - ref[0]).abs().max()),
               "logt": float((logt - ref[1]).abs().max()),
               "stop_mismatches": int((stop != ref[2]).sum())}
        gr = g[rows].contiguous()
        dpair = RC.composite_bwd(*args, gr, logt, stop, **kw, **sl)
        bstats = {}
        ref_pair = RC.composite_bwd_plain(*args, gr, logt, stop,
                                          stats=bstats, **kw, **sl)
        lo, hi = int(ci.tile_start[sl["t_lo"]]), int(ci.tile_start[sl["t_hi"]])
        dpay = RC.reduce_pair_grads(dpair, inv, ci.tile_start, n, **sl,
                                    sorted_gauss=ci.sorted_gauss)
        torch.cuda.synchronize()
        same_input = RC.reduce_pair_grads_plain(dpair, inv, ci.tile_start, n,
                                                **sl)
        pg_equal = bool(torch.equal(per_gaussian(dpair, sl), dpay))
        idx = ci.sorted_gauss[lo:hi].long()
        prows = dpair[lo:hi].contiguous()
        acc = torch.zeros((n, words), device=dev)
        chain = RC.reduce_pair_grads_plain(ref_pair, inv, ci.tile_start, n,
                                           **sl)
        row = {"slab": r, **sl, "pairs": hi - lo, "fwd": fwd,
               "bwd_rel": group_rel(dpair[lo:hi], ref_pair[lo:hi], words),
               "pair_rows_equal_whole": bool(torch.equal(dpair[lo:hi],
                                                         fpair[lo:hi])),
               "reduce_max_abs_diff": float((dpay - same_input).abs().max()),
               "reduce_equal_per_gaussian": pg_equal,
               "per_gaussian_rel": group_rel(dpay, chain, words),
               "evaluated": fstats["evaluated"],
               "contributing": fstats["contributing"],
               "bwd_evaluated": bstats["evaluated"],
               "bwd_counted": bstats["counted"]}
        if any(fwd.values()):
            bad.append(f"slab {r} forward")
        if not max(row["bwd_rel"].values()) <= BWD_TOL or not max(
                row["per_gaussian_rel"].values()) <= BWD_TOL:
            bad.append(f"slab {r} backward")
        if not row["pair_rows_equal_whole"] or row["reduce_max_abs_diff"] \
                or not pg_equal:
            bad.append(f"slab {r} pair rows or reduce")
        # the slab's bounds, counted as compare / compare_bwd count them
        pix = (sl["t_hi"] - sl["t_lo"]) * 256
        fbytes = ((hi - lo) * (4 * kpay.shape[1] + 4)
                  + 4 * pix * (1 + n_val) + 8 * pix)
        fops = 16 * fstats["evaluated"] + (8 + 2 * n_val) * fstats[
            "contributing"]
        bbytes = ((hi - lo) * (4 * kpay.shape[1] + 4 + 4 * words)
                  + 4 * pix * (1 + n_val) + 8 * pix)
        bops = 16 * bstats["evaluated"] + (35 + 4 * n_val) * bstats[
            "counted"]
        # the reduce: the slab's rows and their gaussians read, the
        # output written
        rbytes = (hi - lo) * (4 + 4 * words) + n * 4 * words
        row.update(**bound("fwd", fbytes, fops), **bound("bwd", bbytes, bops),
                   **bound("reduce", rbytes, (hi - lo) * words))
        if r == 0:
            row["fwd_plain_ms"] = cuda_ms(lambda: RC.composite_plain(
                *args, residuals=True, **kw, **sl), 1)
            row["bwd_plain_ms"] = cuda_ms(lambda: RC.composite_bwd_plain(
                *args, gr, logt, stop, **kw, **sl), 1)
            row["reduce_plain_ms"] = cuda_ms(
                lambda: RC.reduce_pair_grads_plain(dpair, inv, ci.tile_start,
                                                   n, **sl), 3)
        fns[f"fwd_slab{r}"] = (lambda sl=sl: RC.composite_fwd(
            *args, residuals=True, **kw, **sl))
        fns[f"bwd_slab{r}"] = (lambda sl=sl, gr=gr, logt=logt, stop=stop:
                               RC.composite_bwd(*args, gr, logt, stop, **kw,
                                                **sl))
        fns[f"reduce_slab{r}"] = (lambda sl=sl, dpair=dpair:
                                  RC.reduce_pair_grads(
                                      dpair, inv, ci.tile_start, n, **sl,
                                      sorted_gauss=ci.sorted_gauss))
        fns[f"pergauss_slab{r}"] = (lambda sl=sl, dpair=dpair:
                                    per_gaussian(dpair, sl))
        # the same sums as one PyTorch call (a yardstick only)
        fns[f"index_add_slab{r}"] = (lambda acc=acc, idx=idx, prows=prows:
                                     acc.index_add_(0, idx, prows))
        total += dpay
        slabs.append((out, logt, stop))
        per_slab.append(row)
    concat = [torch.cat([s[i] for s in slabs]) for i in range(3)]
    concat_equal = {"image": bool(torch.equal(concat[0], full)),
                    "logt": bool(torch.equal(concat[1], flogt)),
                    "stop": bool(torch.equal(concat[2], fstop))}
    sum_rel = group_rel(total, fpay, words)
    if not all(concat_equal.values()):
        bad.append(f"slabs concatenated != whole image: {concat_equal}")
    if not max(sum_rel.values()) <= SLAB_SUM_TOL:
        bad.append(f"slab gradients summed != whole image's: {sum_rel}")
    t = repeated_ms(fns)
    for row in per_slab:
        for kern in ("fwd", "bwd", "reduce", "pergauss", "index_add"):
            tk = t[f"{kern}_slab{row['slab']}"]
            row[f"{kern}_ms"], row[f"{kern}_ms_repeats"] = tk["median"], tk
    out = {"phase": "mesh-slabs", "scene": label, "n_val": n_val,
           "n_packed": n_packed, "with_color": with_color,
           "slabs": MESH_SLABS, "rows_pad": rows_pad, "tw": tw,
           "h_pad": h_pad, "pairs": int(ci.tile_start[-1]),
           "concat_equal_whole": concat_equal,
           "slab_sum_vs_whole_rel": sum_rel,
           "whole_ms": {k: t[f"{k}_full"]["median"]
                        for k in ("fwd", "bwd", "reduce", "walk")},
           "whole_ms_repeats": {k: t[f"{k}_full"]
                                for k in ("fwd", "bwd", "reduce", "walk")},
           "walk_whole_equal": walk_equal,
           "per_slab": per_slab,
           "tol": {"fwd": FWD_TOL, "bwd_rel": BWD_TOL,
                   "slab_sum_rel": SLAB_SUM_TOL}}
    out["card"] = nvidia_smi()
    emit(out)
    if bad:
        raise AssertionError(f"slab mode on {label} n_val={n_val} "
                             f"n_packed={n_packed}: {bad}")
    return out


def peak_of(fn, into: dict, name: str):
    """fn()'s result; into[name] = the device memory it allocated at its
    peak beyond what was allocated before it, and that baseline (MiB)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    into[name] = {"peak_above_base": (torch.cuda.max_memory_allocated()
                                      - base) / 2 ** 20,
                  "base": base / 2 ** 20}
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def states_rel(a, b, parts) -> float:
    """The largest difference between two TrainStates' gaussian fields
    ("params") or Adam moments ("opt") over each tensor's largest
    magnitude."""
    worst = 0.0
    for part in parts:
        for x, y in zip(getattr(a, part), getattr(b, part)):
            pairs = zip(x[:2], y[:2]) if part == "opt" else [(x, y)]
            for u, v in pairs:
                d = float((u - v).abs().max())
                worst = max(worst, d / (float(v.abs().max()) + 1e-30))
    return worst


def mesh_phase(params, aux, cam, net, cfg, dev, root, src):
    """The multi-device path on one card. 1: the slab kernels at the bench
    scene (slab_compare, GAUSSIAN and FEATURE layouts). 2 (counted, the
    main path, each run counted on its own): a world of one over NCCL in
    this process: one sharded GAUSSIAN and one FEATURE (smoothing on) step
    at the bench scene, against the single-device steps from the same
    state (loss equal, params and moments within MESH_STEP_TOL), then
    timed beside them with CUDA events, with the device's idle share and
    each step's peak memory; then the train CLI with --mesh 1 as torchrun
    starts it (WORLD_SIZE=1, a TCP store on localhost) on the 64x64
    dataset through both phases, its launches exactly one of each slab
    kernel a step, its peak memory beside the same flags' on one device,
    its checkpoint loaded in a single-device Trainer bit for bit. 3: the
    same CLI spawning its rank (a subprocess), and --mesh 2, which must
    fail at once naming the device count."""
    from trase_tpu_torch import train as train_cli
    from trase_tpu_torch.config import OptimizationParams
    from trase_tpu_torch.engine import trainer as TT
    from trase_tpu_torch.losses.contrastive import sample_pixels_and_masks
    from trase_tpu_torch.ops.knn import (build_feature_smooth_map,
                                         smooth_slots, transpose_smooth_map)
    from trase_tpu_torch.parallel import sharded as S
    from trase_tpu_torch.parallel.world import close_world, init_world

    rows = []
    with torch.no_grad():
        bproj, bfeats = projected(params, aux, cam, deltas(params, net, 0.5),
                                  True)
        rows.append(slab_compare("bench", bproj, None, HEIGHT, WIDTH, cfg,
                                 False, True))
        rows.append(slab_compare("bench", bproj, bfeats, HEIGHT, WIDTH, cfg,
                                 True, False))
    del bproj, bfeats

    lr_at = TT.make_learning_rate_schedules(OptimizationParams())
    lrs = lr_at(12000)
    gt = torch.zeros((3, HEIGHT, WIDTH), device=dev)
    bg = torch.zeros(3, device=dev)
    masks, valid = feature_masks(dev)
    init = train_state(params, aux, net)
    with torch.no_grad():
        smooth_map = transpose_smooth_map(
            build_feature_smooth_map(init.params.xyz, SMOOTH_K))
    gen = torch.Generator(device=dev).manual_seed(4)
    sample = sample_pixels_and_masks(gen, masks, valid, FEATURE_PIXELS,
                                     FEATURE_MASKS)
    perm = smooth_slots(SMOOTH_K, generator=gen)
    gkw = dict(sh_degree=3, use_deform=True, is_6dof=False,
               lambda_dssim=0.2, lambda_reg_deform=0.0)
    fkw = dict(sh_degree=3, use_deform=True, is_6dof=False,
               contrastive_mode="soft", rfn=1.0, positive_th=0.75,
               negative_th=0.5, num_sampled_pixels=FEATURE_PIXELS,
               num_sampled_masks=FEATURE_MASKS)
    fargs = (masks, valid, 0.5, lrs, bg, smooth_map)
    fopts = dict(sample=sample, smooth_perm=perm)

    def single_g():
        return TT.gaussian_phase_step(init, cam, gt, 0.5, 0.0, lrs, bg,
                                      deform_net=net, raster_cfg=cfg, **gkw)

    def single_f():
        return TT.feature_phase_step(init, cam, *fargs, deform_net=net,
                                     raster_cfg=cfg, **fkw, **fopts)

    peak = {}
    ref_g = peak_of(single_g, peak, "gaussian_single")
    ref_f = peak_of(single_f, peak, "feature_single")
    ms = {"gaussian_single": cuda_ms(single_g, 5),
          "feature_single": cuda_ms(single_f, 5)}
    world = init_world(1, 0, dev.type, store_dir=os.path.join(root, "mesh1"))
    try:
        local = S.shard_train_state(init, world)
        gstep = S.make_sharded_gaussian_step(world, net, raster_cfg=cfg,
                                             **gkw)
        fstep = S.make_sharded_feature_step(world, net, raster_cfg=cfg,
                                            **fkw)

        def sharded_g():
            return gstep(local, cam, gt, 0.5, 0.0, lrs, bg)

        def sharded_f():
            return fstep(local, cam, *fargs, **fopts)

        # the main path's counted run: one step of each phase
        reset_counts()
        got_g = peak_of(sharded_g, peak, "gaussian_sharded")
        got_f = peak_of(sharded_f, peak, "feature_sharded")
        step_launches = layout_counts()
        ms["gaussian_sharded"] = cuda_ms(sharded_g, 5)
        ms["feature_sharded"] = cuda_ms(sharded_f, 5)
        prof = {"gaussian": profile_frames(sharded_g, frames=3),
                "feature": profile_frames(sharded_f, frames=3)}
    finally:
        close_world()
    want = {k: 1 for k in MESH_SLAB_KEYS}
    assert step_launches == want, (step_launches, want)
    checks = {}
    for name, (gs, gm), (rs, rm) in (("gaussian", got_g, ref_g),
                                     ("feature", got_f, ref_f)):
        checks[name] = {"loss": float(gm["loss"]),
                        "loss_single": float(rm["loss"]),
                        "finite": bool(gm["finite"]),
                        "params_rel": states_rel(gs, rs, ("params",)),
                        "moments_rel": states_rel(gs, rs, ("opt",))}
    # the GAUSSIAN step in a world of one runs the single step's
    # operations; the FEATURE step reads its sampled pixels through the
    # four-tap gather where the single step resizes by products
    g, f = checks["gaussian"], checks["feature"]
    assert g["finite"] and f["finite"], checks
    assert g["loss"] == g["loss_single"], g
    assert abs(f["loss"] - f["loss_single"]) <= 1e-6 * abs(
        f["loss_single"]), f
    assert max(g["params_rel"], g["moments_rel"], f["moments_rel"]) \
        <= MESH_STEP_TOL, checks

    # the train CLI with --mesh 1 as torchrun starts it, counted
    mdl = os.path.join(root, "mesh_cli")
    flags = ["-s", src, "--iterations", str(MESH_CLI_ITERATIONS), "--eval",
             "--warm_up", "20", "--densify_from_iter", "10",
             "--densification_interval", "20", "--warm_up_3d_features",
             "30", "--iterative_opt_interval", "14", "--densify_until_iter",
             "50", "--num_sampled_pixels", "1024", "--num_sampled_masks", "3",
             "--pairs_per_gaussian", "6", "--device", dev.type, "--quiet",
             "--checkpoint_iterations", str(MESH_CLI_ITERATIONS),
             "--test_iterations", str(MESH_CLI_ITERATIONS)]
    env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        reset_counts()
        tr = peak_of(lambda: train_cli.main(flags + ["-m", mdl, "--mesh",
                                                     "1"]), peak, "cli_mesh1")
        launches, layouts = counts(), layout_counts()
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    cli_s = time.perf_counter() - t0
    assert tr.feature_calls > 0 and tr.step_calls > 0, (tr.feature_calls,
                                                         tr.step_calls)
    assert int(tr.skipped) == 0 and np.isfinite(tr.ema_loss), tr.ema_loss
    # every compositor launch of the run in slab mode: one of each kernel
    # per step (the FEATURE steps' backward full or values-only), plus
    # the evaluation's forwards without residuals
    gs, fs = tr.step_calls, tr.feature_calls
    want = {"composite_fwd/4/0/1/1/slab": gs,
            "composite_bwd/4/0/1/0/slab": gs,
            "reduce_pair_grads/10/slab": gs,
            "composite_fwd/32/16/0/1/slab": fs,
            "reduce_pair_grads/38/slab": fs, "smooth_rows_bwd": fs}
    got = {k: layouts.get(k, 0) for k in want}
    bwd_f = layouts.get("composite_bwd/32/16/0/0/slab", 0) + layouts.get(
        "composite_bwd/32/16/0/1/slab", 0)
    unslabbed = {k: v for k, v in layouts.items() if not k.endswith("/slab")
                 and k.split("/")[0] in ("composite_fwd", "composite_bwd",
                                         "reduce_pair_grads")}
    assert got == want and bwd_f == fs and not unslabbed, (got, want, bwd_f,
                                                          unslabbed, layouts)
    # the same flags on one device, for its peak memory and time
    t0 = time.perf_counter()
    peak_of(lambda: train_cli.main(flags + ["-m", mdl + "_one"]), peak,
            "cli_single")
    cli_single_s = time.perf_counter() - t0
    # its checkpoint in a single-device Trainer, bit for bit
    ckpt = os.path.join(mdl, f"chkpnt{MESH_CLI_ITERATIONS}.pkl")
    single = train_cli.main(flags + ["-m", os.path.join(root, "mesh_single"),
                                     "--start_checkpoint", ckpt])
    with open(ckpt, "rb") as f:
        saved = _flat_state(pickle.load(f)["state"])
    loaded = _flat_state(TT.train_state_to_numpy(single.state))
    diff = [k for k, v in saved.items()
            if v.dtype != loaded[k].dtype or not np.array_equal(v, loaded[k])]
    assert sorted(saved) == sorted(loaded) and not diff, diff

    # the spawn path, and a world larger than the machine
    cmd = [sys.executable, "-m", "trase_tpu_torch.train"]
    t0 = time.perf_counter()
    spawn = subprocess.run(cmd + flags + ["-m", mdl + "_spawn", "--mesh",
                                          "1"], capture_output=True,
                           text=True, timeout=300)
    spawn_s = time.perf_counter() - t0
    assert spawn.returncode == 0 and "Training complete" in spawn.stdout, \
        spawn.stderr[-2000:]
    t0 = time.perf_counter()
    two = subprocess.run(cmd + flags + ["-m", mdl + "_two", "--mesh", "2"],
                         capture_output=True, text=True, timeout=120)
    two_s = time.perf_counter() - t0
    named = "needs 2 devices" in two.stderr and "has 1" in two.stderr
    assert two.returncode != 0 and named, (two.returncode, two.stderr)
    row = {"phase": "mesh", "world": 1, "backend": world.backend,
           "card": nvidia_smi(),
           "step_ms": ms, "checks": checks, "tol": MESH_STEP_TOL,
           "peak_mib": peak,
           "profile": {k: {"wall_ms": v["wall_ms"],
                           "device_busy_ms": v["device_busy_ms"],
                           "idle_share": v["idle_share"],
                           "top": v["top"][:6]} for k, v in prof.items()},
           "step_layouts": step_launches,
           "cli": {"iterations": MESH_CLI_ITERATIONS, "seconds": cli_s,
                   "single_seconds": cli_single_s,
                   "feature_steps": tr.feature_calls,
                   "gaussian_steps": tr.step_calls,
                   "ema_loss": tr.ema_loss, "checkpoint_loads_single": True},
           "cli_spawn_seconds": spawn_s,
           "mesh2": {"returncode": two.returncode, "seconds": two_s,
                     "error": two.stderr.strip().splitlines()[-1]},
           "launches": launches}
    return row, rows, launches, layouts, step_launches


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mlp-parent", default=None,
                    help="an earlier deform_mlp.cu (the wmma design's C interface) "
                    "to time beside the kernel")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    run(torch.device("cuda"), a.mlp_parent)
    return 0


def run(dev: torch.device, mlp_parent: str | None = None) -> None:
    from trase_tpu_torch.models import gaussians as G
    from trase_tpu_torch.models.deform import init_deform, make_deform_network
    from trase_tpu_torch.ops import cuda_lib as CL
    from trase_tpu_torch.ops import rasterize_cuda as RC
    from trase_tpu_torch.ops.rasterize import RasterConfig
    from trase_tpu_torch.ops.rasterize_ref import rasterize_reference
    from trase_tpu_torch.renderer import make_render_camera, render

    t_start = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(dev)
    emit({"phase": "device", "nvidia_smi": smi, "torch_device": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    parent_build = None
    if mlp_parent:
        with open(mlp_parent) as f:
            parent_build = start_nvcc("deform_mlp_parent", f.read())
    libs = CL.build_library()
    for name, (lib, seconds, log) in libs.items():
        emit({"phase": "build", "source": name, "library": os.path.relpath(lib),
              "seconds": seconds,
              "ptxas": [ln.strip() for ln in log.splitlines()
                        if any(w in ln for w in ("registers", "spill",
                                                 "wgmma", "setmaxnreg"))]})
    parent = None
    if parent_build:
        parent, so, lines = finish_nvcc(
            parent_build, {"trase_deform_mlp": PARENT_MLP_ARGTYPES})
        emit({"phase": "build", "source": mlp_parent, "ptxas": lines,
              "res_usage": res_usage(so) if parent else None})
        assert parent is not None, f"{mlp_parent} did not build"
    mlp_res = res_usage(libs["deform_mlp"][0])
    emit({"phase": "mlp-res", "res_usage": mlp_res})
    spills = {k: v for k, v in mlp_res.items() if v["local"] or v["stack"]}
    assert mlp_res and not spills, f"deform_mlp spills: {spills}"
    sass = fwd_sass(libs["composite_fwd"][0])
    emit({"phase": "fwd-sass", "saved": os.path.relpath(
              os.path.splitext(libs["composite_fwd"][0])[0] + ".sass"),
          "instantiations": {"/".join(str(int(x)) for x in k): v
                             for k, v in sorted(sass.items())}})
    spills = {k: v for k, v in sass.items() if v["local"] or v["stack"]}
    assert not spills, f"forward instantiations spill: {spills}"
    bwd_res = bwd_res_usage(libs["composite_bwd"][0])
    emit({"phase": "bwd-res", "instantiations": bwd_res})
    spills = {k: v for k, v in bwd_res.items() if v["local"] or v["stack"]}
    assert len(bwd_res) == 12 and not spills, \
        f"backward library: {sorted(bwd_res)}, spills: {spills}"

    # 3. kernels vs plain (and the small scene vs the oracle)
    rows = []
    proj, feats, H, W = small_scene(dev)
    cfg16 = RasterConfig(pairs_per_gaussian=16)
    for pack, f in ((False, None), (False, feats), (True, feats)):
        rows.append(compare("small", proj, f, H, W, cfg16, pack, False))
    for pack in (False, True):
        rows.append(compare("small", proj, feats, H, W, cfg16, pack, False,
                            with_color=False))
    with torch.no_grad():
        bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
        tiled = RC.rasterize_tiled(proj, feats, bg, H, W,
                                   cfg16._replace(pack_features=False))
        oracle = rasterize_reference(proj, feats, bg, H, W)
    # the tiled path culls by the exact-support rect, the oracle composites
    # every tail: test_rasterize_pallas.py::test_matches_oracle's 2e-3
    oracle_err = float((tiled["render"] - oracle["render"]).abs().max())
    emit({"phase": "compare", "scene": "small", "against": "oracle",
          "render_max_abs_diff": oracle_err, "tol": 2e-3})
    assert oracle_err <= 2e-3, oracle_err
    bwd_rows = compare_bwd("small", proj, None, H, W, cfg16, False)
    for pack in (False, True):
        for with_color in (False, True):
            bwd_rows += compare_bwd("small", proj, feats, H, W, cfg16, False,
                                    pack=pack, with_color=with_color)

    n, cap, H, W = N_GAUSSIANS, CAPACITY, HEIGHT, WIDTH
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(n, 3)) * 1.2).astype(np.float32)
    pts[:, 2] += 4.0
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    params, aux = G.from_point_cloud(pts, cols, sh_degree=3, capacity=cap,
                                     dist2=np.full(n, 0.0004, np.float32),
                                     device=dev)
    cam = make_render_camera(np.eye(3), np.zeros(3), 1.2, 0.95, H, W,
                             device=dev)
    net = init_deform(make_deform_network("DeformNetwork", device=dev),
                      torch.Generator().manual_seed(0))
    net.eval()
    cfg = RasterConfig(pairs_per_gaussian=6)
    full = {}
    with torch.no_grad():
        for with_features, pack, with_color in (
                (False, False, True), (True, False, True), (True, True, True),
                (True, False, False), (True, True, False)):
            bproj, bfeats = projected(params, aux, cam,
                                      deltas(params, net, 0.5), with_features)
            r = compare("bench", bproj, bfeats, H, W, cfg, pack, True,
                        with_color, sass)
            full[(r["n_val"], r["n_packed"], with_color)] = r
            rows.append(r)
        bench_bwd = compare_bwd("bench", bproj, None, H, W, cfg, True,
                                sass=sass)
        for pack in (True, False):
            bench_bwd += compare_bwd("bench", bproj, bfeats, H, W, cfg, True,
                                     pack=pack, with_color=False, sass=sass)
        # colour beside the features (36 values), packed as served
        for pack in (True, False):
            bench_bwd += compare_bwd("bench", bproj, bfeats, H, W, cfg, True,
                                     pack=pack, with_color=True, sass=sass)
    bwd_rows += bench_bwd
    kb = bench_bwd[0]
    # the fused deform MLP: a ragged tile, then the bench scene's capacity
    mlp_rows = [
        compare_mlp("small", net, params.xyz[:300],
                    torch.full((300, 1), 0.42, device=dev), False),
        compare_mlp("bench", net, params.xyz,
                    torch.full((cap, 1), 0.5, device=dev), True, parent)]
    mlp_rows[-1]["registers"] = max(v["registers"] for v in mlp_res.values())

    # 4. the serving path: deform_step -> renderer.render, counted
    from trase_tpu_torch.models.deform import deform_step

    bg = torch.zeros(3, device=dev)

    def frame(fid, with_features, fused=False):
        t = torch.full((cap, 1), fid, device=dev)
        d = deform_step(net, params.xyz, t, fused=fused)
        return render(cam, params, aux.alive, bg, *d, sh_degree=3,
                      with_features=with_features, raster_cfg=cfg)

    launches, layouts = {}, {}
    reset_counts()
    calls = 0
    frame_ms = {}
    with torch.no_grad():
        for with_features in (False, True):
            for i in range(WARMUP):
                out = frame(0.1 * i, with_features)
                calls += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(FRAMES):
                out = frame(i / FRAMES, with_features)
                calls += 1
            torch.cuda.synchronize()
            frame_ms[with_features] = (time.perf_counter() - t0) / FRAMES * 1e3
            checks = {k: out[k] for k in ("render", "depth", "alpha")}
            if with_features:
                checks["feats"] = out["render_gaussian_features"]
                assert out["render_gaussian_features"].shape == (32, H, W)
            assert out["render"].shape == (3, H, W)
            for k, v in checks.items():
                assert bool(torch.isfinite(v).all()), f"non-finite {k}"
            a = out["alpha"]
            assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    launches["render"] = counts()
    layouts["render"] = layout_counts()
    # serving keeps the no-residual forward and launches no backward
    assert launches["render"] == {"composite_fwd": calls, "composite_bwd": 0,
                                  "reduce_pair_grads": 0,
                                  "deform_mlp": 0}, launches
    # the same frame through deform_step(fused=True): one deform_mlp
    # launch per frame
    reset_counts()
    with torch.no_grad():
        for i in range(WARMUP):
            frame(0.1 * i, False, fused=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(FRAMES):
            out_f = frame(i / FRAMES, False, fused=True)
        torch.cuda.synchronize()
        frame_ms["fused"] = (time.perf_counter() - t0) / FRAMES * 1e3
    launches["render_fused"] = counts()
    layouts["render_fused"] = layout_counts()
    n_fused = WARMUP + FRAMES
    assert launches["render_fused"] == {
        "composite_fwd": n_fused, "composite_bwd": 0, "reduce_pair_grads": 0,
        "deform_mlp": n_fused}, launches["render_fused"]
    # the same frames with the weights repacked every frame, as before
    # fused_weights cached them (not counted: a comparison)
    from trase_tpu_torch.ops import mlp_cuda as M

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(FRAMES):
            M._CACHE.clear()
            frame(i / FRAMES, False, fused=True)
        torch.cuda.synchronize()
        frame_ms["fused_repack"] = (time.perf_counter() - t0) / FRAMES * 1e3
    for k in ("render", "depth", "alpha"):
        assert bool(torch.isfinite(out_f[k]).all()), f"non-finite fused {k}"
    with torch.no_grad():
        img_f32 = frame(0.5, False)["render"]
        img_fused = frame(0.5, False, fused=True)["render"]
        stages = stage_ms(params, aux, cam, net, cfg, False, False)
        stages_feats = stage_ms(params, aux, cam, net, cfg, True, True)
        stages_fused = stage_ms(params, aux, cam, net, cfg, False, False,
                                fused=True)
    fused_diff = (img_fused - img_f32).abs()
    k4, k36 = full[(4, 0, True)], full[(36, 16, True)]
    emit({"phase": "render", "gaussians": n, "capacity": cap,
          "height": H, "width": W, "pairs_per_gaussian": 6,
          "render_calls": calls, "launches": launches["render"],
          "frame_ms": frame_ms[False], "frame_ms_with_features":
          frame_ms[True], "frame_ms_pr1": 8.174053,
          "compositor_ms": k4["ms"],
          "compositor_ms_with_features": k36["ms"],
          "plain_ms": k4["plain_ms"], "plain_ms_with_features":
          k36["plain_ms"], "bound_ms": k4["bound_ms"],
          "bound_ms_with_features": k36["bound_ms"],
          "stage_ms": stages, "stage_ms_with_features": stages_feats,
          "fused_frames": n_fused, "launches_fused": launches["render_fused"],
          "frame_ms_fused": frame_ms["fused"],
          "frame_ms_fused_repack": frame_ms["fused_repack"],
          "stage_ms_fused": stages_fused,
          "fused_vs_f32_image_max_abs_diff": float(fused_diff.max()),
          "fused_vs_f32_image_mean_abs_diff": float(fused_diff.mean()),
          "overflow": float(out["overflow"]),
          "alpha_mean": float(out["alpha"].mean())})
    grad_row, launches["render_grad"], layouts["render_grad"] = \
        render_grad_check(params, aux, cam, net, cfg, dev)
    emit(grad_row)

    # 5. the render CLI on the card
    from trase_tpu_torch import render as cli

    tmp = tempfile.TemporaryDirectory()
    small = 2000
    keep = torch.zeros(cap, dtype=torch.bool, device=dev)
    keep[:small] = True
    cli_aux = aux._replace(alive=aux.alive & keep)
    src, mdl, it, n_train, n_test = write_cli_inputs(tmp.name, params,
                                                     cli_aux, net, dev)
    reset_counts()
    cli.main(["-s", src, "-m", mdl, "--iteration", str(it),
              "--pairs_per_gaussian", "6", "--device", dev.type])
    png_counts = check_pngs(mdl, it, n_train, n_test)
    launches["cli"] = counts()
    layouts["cli"] = layout_counts()
    assert launches["cli"]["composite_fwd"] == 2 * (n_train + n_test) + 2, \
        launches["cli"]
    assert launches["cli"]["deform_mlp"] == 0, launches["cli"]
    emit({"phase": "cli", "png_counts": png_counts,
          "launches": launches["cli"],
          "launches_per_view": launches["cli"]["composite_fwd"]
          / (n_train + n_test)})

    # 5b. the segmentation pipeline: cluster -> render --segment_ids ->
    # metrics, then k-means at the bench scene's size
    seg = segment_cli_phase(tmp.name, src, mdl, it, n_train, n_test, dev)
    launches["segment_cli"] = seg.pop("launches")
    layouts["segment_cli"] = seg.pop("layouts")
    emit({"phase": "segment-cli", **seg})
    emit({"phase": "kmeans", **kmeans_phase(params, n, dev)})

    # 6. the training step on the bench scene
    train = train_step_phase(params, aux, cam, net, cfg, dev)
    launches["train_step"] = train.pop("launches")
    layouts["train_step"] = train.pop("layouts")
    emit({"phase": "train-step", **train})

    # 6b. the FEATURE step on the bench scene, both arms
    feature = feature_step_phase(params, aux, cam, net, cfg, dev)
    launches["feature_step"] = feature.pop("launches")
    layouts["feature_step"] = feature.pop("layouts")
    emit({"phase": "feature-step", **feature})

    # 7. the training CLI, then the render CLI on its snapshot
    cli_row = train_cli_phase(src, tmp.name, dev, n_train, n_test)
    launches["train_cli"] = cli_row["launches"]
    layouts["train_cli"] = cli_row.pop("layouts")
    emit({"phase": "train-cli", **cli_row})

    # 7b. the synthetic dataset writer, then a checkpointed run resumed
    syn = synthetic_phase(tmp.name, dev)
    launches["synthetic"] = syn.pop("launches")
    layouts["synthetic"] = syn.pop("layouts")
    emit({"phase": "synthetic", **syn})
    res = resume_phase(tmp.name, dev)
    launches["resume"] = res.pop("launches")
    layouts["resume"] = res.pop("layouts")
    emit({"phase": "resume", **res})

    # 7c. the viewer and its web server on the bench scene, then host IO
    row, viewer, launches["viewer"], layouts["viewer"] = viewer_phase(
        params, aux, n, net, dev, tmp.name, os.path.join(tmp.name, "segment"),
        it)
    emit(row)
    web, launches["viewer_web"], layouts["viewer_web"] = viewer_web_phase(
        viewer, row["click_pixel"])
    emit(web)
    mio, launches["mask_io"], layouts["mask_io"] = mask_io_phase(tmp.name,
                                                                dev)
    emit(mio)

    # 7d. style transfer: the step at full width, the style CLI; LPIPS in
    # the metrics CLI; the 3D losses
    seg_dir = os.path.join(tmp.name, "segment")
    row, style_step, launches["style"], layouts["style"] = style_phase(
        params, aux, cam, net, cfg, dev)
    emit(row)
    scli = style_cli_phase(tmp.name, src, seg_dir, it, seg["segment_id"],
                           n_train, n_test, dev)
    launches["style_cli"] = scli.pop("launches")
    layouts["style_cli"] = scli.pop("layouts")
    emit(scli)
    lp, launches["lpips"], layouts["lpips"] = lpips_phase(
        tmp.name, seg_dir, os.path.join(tmp.name, "benchmark"), it, dev)
    emit(lp)
    emit(losses_3d_phase(params, net, dev))

    # 7e. the multi-device path on one card: the slab kernels, a world of
    # one over NCCL, the --mesh CLI
    (row, slab_rows, launches["mesh"], layouts["mesh_cli"],
     layouts["mesh_steps"]) = mesh_phase(
        params, aux, cam, net, cfg, dev, tmp.name, src)
    emit(row)

    # 7f. the interop tools: a converted dataset trained on the card, masks
    # from label maps, the render CLI's --text_prompt fallback
    conv = convert_phase(tmp.name, src, seg_dir, it, seg["segment_id"], dev)
    launches["convert"] = conv.pop("launches")
    layouts["convert"] = conv.pop("layouts")
    emit(conv)

    # 7g. the production-scale validation tool at 1008 px
    sc = scale_phase(tmp.name, dev)
    launches["scale"] = sc.pop("launches")
    layouts["scale"] = sc.pop("layouts")
    emit(sc)
    tmp.cleanup()

    # 8. where a frame's and a step's device time goes
    with torch.no_grad():
        for with_features in (False, True):
            emit({"phase": "profile", "path": "render",
                  "with_features": with_features,
                  **profile_frames(lambda: frame(0.5, with_features))})
        emit({"phase": "profile", "path": "render", "with_features": False,
              "fused": True,
              **profile_frames(lambda: frame(0.5, False, fused=True))})
    emit({"phase": "profile", "path": "train-step",
          **profile_frames(train_step_fn(params, aux, cam, net, cfg, dev,
                                         carry=False), frames=3)})
    emit({"phase": "profile", "path": "viewer", "mode": "Render",
          **profile_frames(lambda: viewer.render_frame("Render"), frames=3)})
    for stats in (True, False):
        emit({"phase": "profile", "path": "feature-step",
              "with_densify_stats": stats,
              **profile_frames(feature_step_fn(
                  train_state(params, aux, net), cam, net, cfg, dev, stats,
                  carry=False), frames=3)})
    emit({"phase": "profile", "path": "style-step",
          **profile_frames(style_step, frames=3)})

    # 9. kernels
    emit(kernel_table(rows, bwd_rows, full, kb, mlp_rows, launches, layouts,
                      slab_rows, mio["mask_unpack"],
                      feature["smooth_rows_bwd"],
                      time.perf_counter() - t_start))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


def render_grad_check(params, aux, cam, net, cfg, dev):
    """Bench-scene frames under autograd through rasterize_tiled, one per
    backward instantiation no training step launches: colour beside the
    32 features (36 values), packed (as served) and unpacked, full and
    values-only, and rgb + depth values-only. The gradient of a seeded
    loss in every projected input (the payload's columns before
    build_payload's masks and log) through the kernels, counted. The
    packed full frame against the same frame through the plain versions
    on the card, within BWD_TOL of each field's largest magnitude; each
    values-only frame: exact zeros in mean2d, conic and opacity, and the
    value inputs' gradients bit for bit its full frame's."""
    from trase_tpu_torch.ops import rasterize_cuda as RC

    H, W = HEIGHT, WIDTH
    with torch.no_grad():
        proj, feats = projected(params, aux, cam, deltas(params, net, 0.5),
                                True)
    names = ("mean2d", "conic", "opacity", "color", "depth")
    geometry = ("mean2d", "conic", "opacity")
    gen = torch.Generator(device=dev).manual_seed(3)
    w_rgb = torch.randn((3, H, W), generator=gen, device=dev)
    w_feat = torch.randn((32, H, W), generator=gen, device=dev)
    bg = torch.zeros(3, device=dev)

    def frame(pack, with_features, values_only):
        leaves = {k: getattr(proj, k).detach().clone().requires_grad_(True)
                  for k in names}
        inputs = list(leaves.values())
        f = None
        if with_features:
            f = feats.detach().clone().requires_grad_(True)
            inputs.append(f)
        out = RC.rasterize_tiled(proj._replace(**leaves), f, bg, H, W,
                                 cfg._replace(pack_features=pack),
                                 grad_values_only=values_only)
        loss = ((out["render"] * w_rgb).sum() + out["alpha"].sum()
                + 0.1 * out["depth"].sum())
        if with_features:
            loss = loss + (out["feats"] * w_feat).sum()
        g = torch.autograd.grad(loss, inputs)
        return dict(zip(names + ("features",), g))

    cases = {"36/16/1": (True, True), "36/0/1": (False, True),
             "4/0/1": (False, False)}
    reset_counts()
    t0 = time.perf_counter()
    got = {}
    for lay, (pack, with_features) in cases.items():
        for vo in (False, True) if with_features else (True,):
            got[f"{lay}/{int(vo)}"] = frame(pack, with_features, vo)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, layouts = counts(), layout_counts()
    want = {"composite_fwd/36/16/1/1": 2, "composite_fwd/36/0/1/1": 2,
            "composite_fwd/4/0/1/1": 1, "reduce_pair_grads/42": 4,
            "reduce_pair_grads/10": 1,
            **{f"composite_bwd/{k}": 1 for k in got}}
    assert layouts == want, layouts
    t0 = time.perf_counter()
    with PlainKernels():
        ref = frame(True, True, False)
    torch.cuda.synchronize()
    plain_seconds = time.perf_counter() - t0
    full = got["36/16/1/0"]
    rel = {k: float((full[k] - ref[k]).abs().max())
           / (float(ref[k].abs().max()) + 1e-30) for k in ref}
    scale = {k: float(ref[k].abs().max()) for k in ref}
    bad = [k for k, v in rel.items()
           if not (v <= BWD_TOL and bool(torch.isfinite(full[k]).all()))]
    assert not bad and min(scale.values()) > 0, (bad, rel, scale)
    vo_check = {}
    for key, g in got.items():
        if key.endswith("/1"):
            zero = all(not bool(g[k].any()) for k in geometry)
            full_key = key[:-1] + "0"
            same = (full_key not in got
                    or all(torch.equal(g[k], got[full_key][k])
                           for k in g if k not in geometry))
            vo_check[key] = {"geometry_zero": zero,
                             "values_equal_full": same}
            assert zero and same, (key, vo_check[key])
    return ({"phase": "render", "check": "gradients on the card",
             "height": H, "width": W, "layouts": layouts,
             "packed_full_vs_plain_max_rel_diff": rel, "grad_scale": scale,
             "tol": BWD_TOL, "values_only": vo_check,
             "seconds": seconds, "plain_seconds": plain_seconds},
            launches, layouts)


def llff_pose_row(eye, h, w, fl=80.0):
    """One LLFF poses_bounds row for a camera at `eye` looking at the
    origin ([down right back] columns, tests/test_converters.py's)."""
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0, 1, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.stack([down, right, -fwd, eye], axis=1)
    hwf = np.array([[h], [w], [fl]])
    return np.concatenate([c2w, hwf], axis=1).reshape(-1).tolist() + [0.5,
                                                                      8.0]


def scale_phase(root, dev) -> dict:
    """The validation tool on the card (SCALE_ARGS), counted: two curve
    lines (the milestone and the end) with a finite test PSNR, the alive
    count above the initial cloud's, the snapshots (ply, deform.pkl) of
    both on disk, and each line scored exactly when scikit-learn is
    installed (the card's machine has none: the snapshots are then left
    for --score_only). Seconds (the dataset's writing included), it/s and
    PSNR."""
    import importlib.util
    import math

    from trase_tpu_torch.tools import validate_scale as V

    out = os.path.join(root, "scale")
    reset_counts()
    t0 = time.perf_counter()
    result = V.main(["--out", out, "--device", dev.type] + SCALE_ARGS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, layouts = counts(), layout_counts()
    with open(os.path.join(out, "curve.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln["iteration"] for ln in lines] == [SCALE_MILESTONE,
                                                 SCALE_ITERATIONS], lines
    sklearn = importlib.util.find_spec("sklearn") is not None
    for ln in lines:
        assert math.isfinite(ln["psnr_test"]), ln
        assert ln["n_alive"] > SCALE_START_ALIVE, ln
        assert ln["scored"] is sklearn, (ln, sklearn)
        for path in (("point_cloud", f"iteration_{ln['iteration']}",
                      "point_cloud.ply"),
                     ("deform", f"iteration_{ln['iteration']}",
                      "deform.pkl")):
            assert os.path.exists(os.path.join(out, "model", *path)), path
    assert all(launches[k] > 0 for k in ("composite_fwd", "composite_bwd",
                                         "reduce_pair_grads")), launches
    return {"phase": "scale", "seconds": seconds,
            "iters_per_s": result["iters_per_s"],
            "train_s": result["train_s"], "data_gen_s": result["data_gen_s"],
            "psnr_test": result["psnr_test"], "n_alive": result["n_alive"],
            "curve": lines, "sklearn": sklearn, "launches": launches,
            "layouts": layouts}


def convert_phase(root, src, seg, it, sid, dev) -> dict:
    """The interop tools on the card's machine. Synthetic Neu3D videos
    (CONVERT_CAMS cameras at CONVERT_SIZE, cv2's mp4v) and LLFF poses ->
    trase_tpu_torch.neu3d2blender --random_points (a 100k-point cloud);
    label maps (CONVERT_LABELS vertical stripes) -> extract_masks
    --from_dir into the scene's masks/, read back by data/masks.py equal
    to the labels; trase_tpu_torch.train on the card through both phases
    (GAUSSIAN, then FEATURE blocks on those masks) to a finite test PSNR,
    counted; then the render CLI on the segment-cli model with
    --text_prompt beside its --text_prompt_mask: without Grounded-SAM it
    warns and writes the text-prompt objects of the mask alone, byte for
    byte those of a run with the mask alone. Seconds for each."""
    import contextlib
    import io
    import shutil

    import cv2
    from PIL import Image

    from trase_tpu_torch import extract_masks as masks_cli
    from trase_tpu_torch import neu3d2blender
    from trase_tpu_torch import render as cli
    from trase_tpu_torch import train as train_cli
    from trase_tpu_torch.data.masks import decode_mask_file

    h, w = CONVERT_SIZE
    scene = os.path.join(root, "neu3d")
    os.makedirs(scene)
    eyes = [np.array(e) for e in ((0, 0, 4.0), (1.2, 0.2, 3.8),
                                  (-1.2, -0.2, 3.8), (0.6, -0.4, 3.9))]
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(CONVERT_CAMS):
        vw = cv2.VideoWriter(os.path.join(scene, f"cam{i:02d}.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
        assert vw.isOpened(), "cv2 cannot write mp4v"
        for f in range(CONVERT_FRAMES):  # smooth colour fields + noise
            base = np.stack([(xx + 7 * f + 13 * i) % w / w * 255,
                             (yy + 5 * f) % h / h * 255,
                             np.full((h, w), 40.0 * i)], axis=-1)
            vw.write(np.clip(base + rng.normal(0, 8, (h, w, 3)), 0,
                             255).astype(np.uint8))
        vw.release()
    np.save(os.path.join(scene, "poses_bounds.npy"),
            np.array([llff_pose_row(e, h, w) for e in eyes[:CONVERT_CAMS]]))
    out = {"size": [h, w], "cameras": CONVERT_CAMS,
           "frames": CONVERT_FRAMES}
    t0 = time.perf_counter()
    neu3d2blender.main(["--path", scene, "--random_points"])
    out["neu3d2blender_s"] = time.perf_counter() - t0
    counts_json = {}
    for split in ("train", "test"):
        with open(os.path.join(scene, f"transforms_{split}.json")) as f:
            counts_json[split] = len(json.load(f)["frames"])
    assert counts_json == {"train": (CONVERT_CAMS - 1) * CONVERT_FRAMES,
                           "test": CONVERT_FRAMES}, counts_json
    assert os.path.exists(os.path.join(scene, "points3d.ply"))
    out["frames_by_split"] = counts_json

    labels = os.path.join(root, "neu3d_labels")
    os.makedirs(labels)
    stripe = np.minimum(xx * CONVERT_LABELS // w, CONVERT_LABELS - 1) + 1
    names = sorted(f[:-4] for f in os.listdir(os.path.join(scene, "images")))
    for name in names:
        Image.fromarray(stripe.astype(np.uint8) * 40).save(
            os.path.join(labels, name + ".png"))
    t0 = time.perf_counter()
    masks_cli.main(["--from_dir", labels, "--output", scene])
    out["extract_masks_s"] = time.perf_counter() - t0
    want = np.stack([stripe == v for v in range(1, CONVERT_LABELS + 1)])
    for name in names:
        got = decode_mask_file(os.path.join(scene, "masks", name + ".npz"))
        assert got is not None and np.array_equal(got, want), name
    out["mask_files"] = len(names)

    mdl = os.path.join(root, "neu3d_model")
    reset_counts()
    t0 = time.perf_counter()
    trainer = train_cli.main([
        "-s", scene, "-m", mdl, "--eval", "--iterations",
        str(CONVERT_ITERATIONS), "--warm_up", "10",
        "--warm_up_3d_features", "20", "--iterative_opt_interval", "10",
        "--densify_from_iter", "15", "--densification_interval", "20",
        "--densify_until_iter", "40", "--num_sampled_pixels", "512",
        "--num_sampled_masks", str(CONVERT_LABELS), "--pairs_per_gaussian",
        "6", "--device", dev.type, "--quiet"])
    out["train_s"] = time.perf_counter() - t0
    launches, layouts = counts(), layout_counts()
    assert launches == dict(compositor(CONVERT_ITERATIONS), deform_mlp=0,
                            **smoothing(trainer.feature_calls)), launches
    assert 0 < trainer.feature_calls < CONVERT_ITERATIONS, \
        trainer.feature_calls
    psnr = float(trainer.evaluate(CONVERT_ITERATIONS))
    assert np.isfinite(psnr) and psnr > 0, psnr
    out.update(iterations=CONVERT_ITERATIONS,
               feature_steps=trainer.feature_calls, test_psnr=psnr)

    # the render CLI on two copies of the segment-cli model: the mask
    # alone, then --text_prompt beside it (the same objects folder name)
    text, logs = {}, {}
    for name, prompt in (("mask", []), ("prompt", ["--text_prompt",
                                                   "center"])):
        copy = os.path.join(root, f"segment_{name}")
        shutil.copytree(seg, copy)
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            cli.main(["-s", src, "-m", copy, "--iteration", str(it),
                      "--pairs_per_gaussian", "6", "--use_kmeans",
                      "--segment_ids", str(sid), "--text_prompt_mask",
                      os.path.join(root, "center.png"), "--threshold", "50",
                      "--skip_train", "--device", dev.type] + prompt)
        out[f"render_{name}_s"] = time.perf_counter() - t0
        logs[name] = log.getvalue()
        folder = os.path.join(copy, "test", f"ours_{it}",
                              "text_prompt_center_objects")
        text[name] = {}
        for f in sorted(os.listdir(folder)):
            with open(os.path.join(folder, f), "rb") as fh:
                text[name][f] = fh.read()
    assert "Grounded-SAM unavailable" in logs["prompt"]
    assert "Grounded-SAM unavailable" not in logs["mask"]
    pngs = [f for f in text["mask"] if f.endswith(".png")]
    assert pngs and text["prompt"] == text["mask"], sorted(text["prompt"])
    out["text_prompt_fallback"] = {"warned": True, "pngs_equal": len(pngs)}
    out.update(launches=launches, layouts=layouts)
    return {"phase": "convert", **out}


def kernel_table(rows, bwd_rows, full, kb, mlp_rows, launches, layouts,
                 slab_rows, mu, sb, seconds):
    """The kernels line: one object per kernel with its headline numbers
    (the GAUSSIAN layout, as in earlier runs) and one variant per
    instantiation, with its launches summed over the paths' counts; the
    slab mode's variants (the mesh phase) carry each slab's time beside
    the whole image's, their sum, and the slabs' summed bound. The mask
    unpack (`mu`, mask_unpack_check's row) counts the mask-io phase's
    training runs' launches, the smoothing's backward (`sb`,
    smooth_bwd_check's row) every path's."""
    def launched(key):  # over every path (the FEATURE step's per arm)
        flat = [c for lc in layouts.values()
                for c in (lc.values() if "densify_stats" in lc else [lc])]
        return sum(c.get(key, 0) for c in flat)

    def picked(r, prefix):  # a variant's measured times (the floors, a
        keys = ("ms_repeats", "ms_host_paced")  # model, stay in its row)
        return {k: r[prefix + k] for k in keys if prefix + k in r}

    fwd_variants = []
    for (n_val, n_packed, color), r in full.items():
        key = f"composite_fwd/{n_val}/{n_packed}/{int(color)}"
        same = dict(n_val=n_val, n_packed=n_packed, with_color=color,
                    max_abs_err=max(r["max_abs_diff"].values()),
                    plain_ms=r["plain_ms"], pairs=r["pairs"],
                    evaluated=r["evaluated"],
                    contributing=r["contributing"])
        fwd_variants.append(dict(same, residuals=False,
                                 launches=launched(key + "/0"), ms=r["ms"],
                                 bound_ms=r["bound_ms"],
                                 bound_by=r["bound_by"], **picked(r, "")))
        if not color:
            fwd_variants.append(dict(
                same, residuals=True, launches=launched(key + "/1"),
                ms=r["ms_residuals"], bound_ms=r["residuals_bound_ms"],
                bound_by=r["residuals_bound_by"], **{
                    k.replace("ms_residuals", "ms"): v for k, v in r.items()
                    if k.startswith("ms_residuals_")},
                **picked(r, "residuals_")))
    bwd_variants, red_variants = [], []
    for r in bwd_rows:
        if "bwd_ms" not in r:
            continue
        key = (f"composite_bwd/{r['n_val']}/{r['n_packed']}/"
               f"{int(r['with_color'])}/{int(r['values_only'])}")
        bwd_variants.append(dict(
            n_val=r["n_val"], n_packed=r["n_packed"],
            with_color=r["with_color"], values_only=r["values_only"],
            launches=launched(key),
            max_abs_err=max(r["bwd_max_abs_diff"].values()),
            max_rel_err=max(r["bwd_max_rel_diff"].values()),
            ms=r["bwd_ms"], ms_repeats=r["bwd_ms_repeats"],
            plain_ms=r["bwd_plain_ms"],
            bound_ms=r["bwd_bound_ms"], bound_by=r["bwd_bound_by"],
            evaluated=r["evaluated"], counted=r["counted"]))
        if "reduce_ms" in r:
            if r["with_color"]:
                fwd_variants.append(dict(
                    n_val=r["n_val"], n_packed=r["n_packed"],
                    with_color=True, residuals=True,
                    launches=launched(f"composite_fwd/{r['n_val']}/"
                                      f"{r['n_packed']}/1/1"),
                    ms=r["fwd_residuals_ms"],
                    max_abs_err=max(r["fwd_residuals"]["image"],
                                    r["fwd_residuals"]["logt"]),
                    bound_ms=r["fwd_residuals_bound_ms"],
                    bound_by=r["fwd_residuals_bound_by"],
                    evaluated=r["fwd_evaluated"],
                    contributing=r["fwd_contributing"],
                    **picked(r, "fwd_residuals_")))
            red_variants.append(dict(
                words=r["reduce_words"], n_packed=r["n_packed"],
                launches=launched(f"reduce_pair_grads/{r['reduce_words']}"),
                max_abs_err=r["reduce_max_abs_diff"], ms=r["reduce_ms"],
                plain_ms=r["reduce_plain_ms"],
                bound_ms=r["reduce_bound_ms"],
                bound_by=r["reduce_bound_by"],
                library_ms=r["reduce_library_ms"],
                ms_repeats=r["reduce_ms_repeats"]))
    for r in slab_rows:
        lay = f"{r['n_val']}/{r['n_packed']}/{int(r['with_color'])}"
        ps = r["per_slab"]
        same = dict(n_val=r["n_val"], n_packed=r["n_packed"],
                    with_color=r["with_color"], slab=True,
                    slabs=r["slabs"], whole_image_rows=r["h_pad"])

        def slab_variant(kern, key, **extra):
            return dict(same, launches=launched(key), **extra,
                        ms=sum(p[f"{kern}_ms"] for p in ps),
                        ms_per_slab=[p[f"{kern}_ms"] for p in ps],
                        whole_image_ms=r["whole_ms"][kern],
                        plain_ms=ps[0][f"{kern}_plain_ms"],
                        plain_ms_of="slab 0",
                        bound_ms=sum(p[f"{kern}_bound_ms"] for p in ps),
                        bound_by=ps[0][f"{kern}_bound_by"])

        fwd_variants.append(slab_variant(
            "fwd", f"composite_fwd/{lay}/1/slab", residuals=True,
            max_abs_err=max(max(p["fwd"]["image"], p["fwd"]["logt"])
                            for p in ps)))
        bwd_variants.append(slab_variant(
            "bwd", f"composite_bwd/{lay}/0/slab", values_only=False,
            max_rel_err=max(max(p["bwd_rel"].values()) for p in ps),
            slab_sum_vs_whole_rel=max(r["slab_sum_vs_whole_rel"].values())))
        words = 6 + r["n_val"]
        red_variants.append(slab_variant(
            "reduce", f"reduce_pair_grads/{words}/slab", words=words,
            max_abs_err=max(p["reduce_max_abs_diff"] for p in ps),
            library_ms=sum(p["index_add_ms"] for p in ps),
            library_ms_per_slab=[p["index_add_ms"] for p in ps],
            library="index_add_ over the slab's pairs",
            per_gaussian_ms=sum(p["pergauss_ms"] for p in ps),
            per_gaussian_ms_per_slab=[p["pergauss_ms"] for p in ps]))
    fwd_err = max(max(r["max_abs_diff"].values()) for r in rows)
    fwd_err = max([fwd_err] + [max(r["fwd_residuals"]["image"],
                                   r["fwd_residuals"]["logt"])
                               for r in bwd_rows])
    k4 = full[(4, 0, True)]
    entries = [
        dict(name="composite_fwd", launches=launches["render"][
            "composite_fwd"], max_abs_err=fwd_err, ms=k4["ms"],
             plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
             bound_by=k4["bound_by"], library_ms=None,
             variants=fwd_variants),
        dict(name="composite_bwd", launches=launches["train_step"][
            "composite_bwd"],
             max_abs_err=max(max(r["bwd_max_abs_diff"].values())
                             for r in bwd_rows),
             max_rel_err=max(max(r["bwd_max_rel_diff"].values())
                             for r in bwd_rows),
             ms=kb["bwd_ms"], plain_ms=kb["bwd_plain_ms"],
             bound_ms=kb["bwd_bound_ms"], bound_by=kb["bwd_bound_by"],
             library_ms=None, t_first_max_err=max(
                 r["t_first_max_err"] for r in bwd_rows),
             variants=bwd_variants),
        dict(name="reduce_pair_grads", launches=launches["train_step"][
            "reduce_pair_grads"],
             max_abs_err=max(r["reduce_max_abs_diff"] for r in bwd_rows),
             ms=kb["reduce_ms"], plain_ms=kb["reduce_plain_ms"],
             bound_ms=kb["reduce_bound_ms"], bound_by=kb["reduce_bound_by"],
             library_ms=kb["reduce_library_ms"], variants=red_variants),
    ]
    mb = mlp_rows[-1]
    entries.append(dict(
        name="deform_mlp", launches=launches["render_fused"]["deform_mlp"],
        max_abs_err=max(r["max_abs_diff"] for r in mlp_rows),
        max_rel_err=max(max(r["kernel_vs_plain"].values())
                        for r in mlp_rows),
        ms=mb["ms"], plain_ms=mb["plain_ms"], bound_ms=mb["bound_ms"],
        bound_by=mb["bound_by"], library_ms=mb["library_ms"],
        library="cuBLAS bf16 chain (8 F.linear + 3 float32 heads)",
        ms_repeats=mb["ms_repeats"], ms_host_paced=mb["ms_host_paced"],
        library_gemms_ms=mb["library_gemms_ms"],
        parent_ms=mb.get("parent_ms"), registers=mb["registers"],
        pack_ms=mb["pack_ms"], pack_cached_ms=mb["pack_cached_ms"],
        module_ms=mb["module_ms"], rows=mb["rows"],
        launches_by_path={
            p: c["deform_mlp"] if "deform_mlp" in c
            else {arm: v["deform_mlp"] for arm, v in c.items()}
            for p, c in launches.items()}))
    unpacks = launches["mask_io"].get("mask_unpack", 0)
    assert unpacks > 0, launches["mask_io"]
    entries.append(dict(
        name="mask_unpack", launches=unpacks,
        max_abs_err=mu["max_abs_err"], ms=mu["ms"],
        ms_repeats=mu["ms_repeats"], plain_ms=mu["plain_ms"],
        bound_ms=mu["bound_ms"], bound_by=mu["bound_by"], library_ms=None,
        shape=mu["shape"], m_max=mu["m_max"],
        bits_upload_ms=mu["bits_upload_ms"]))
    entries.append(dict(
        name="smooth_rows_bwd", launches=launched("smooth_rows_bwd"),
        max_rel_err=sb["max_rel_err"], ms=sb["ms"],
        ms_repeats=sb["ms_repeats"], ms_by_chunk=sb["ms_by_chunk"],
        plain_ms=sb["plain_ms"], bound_ms=sb["bound_ms"],
        bound_by=sb["bound_by"], library_ms=sb["index_add_ms"],
        library="index_add_ of the drawn rows",
        autograd_ms=sb["autograd_ms"], rows=sb["rows"],
        max_in_degree=sb["max_in_degree"]))
    for e in entries:
        e["route"] = "cuda"
        e["source"], e["replaces"] = KERNELS[e["name"]]
    return {"kernels": entries, "launches_by_path": launches,
            "launches_by_instantiation": layouts, "seconds": seconds}


def check_pngs(mdl, it, n_train, n_test):
    got_counts = {}
    for split_name, nv in (("train", n_train), ("test", n_test)):
        base = os.path.join(mdl, split_name, f"ours_{it}")
        for s in ("renders", "gt", "rendered_feats", "canonical"):
            got = len([f for f in os.listdir(os.path.join(base, s))
                       if f.endswith(".png")])
            want = 1 if s == "canonical" else nv
            assert got == want, (split_name, s, got, want)
            got_counts[f"{split_name}/{s}"] = got
    return got_counts


def segment_cli_phase(root, src, mdl, it, n_train, n_test, dev) -> dict:
    """The segmentation pipeline through the port's CLIs on phase 5's
    dataset and a copy of its model directory whose feature field is
    grouped by position (4 quadrants in x, y, one direction each plus
    noise): the cluster CLI (k-means on the card, SEGMENT_K clusters;
    HDBSCAN too where sklearn is installed), the render CLI with
    --segment_ids (the largest k-means cluster) and --text_prompt_mask
    (the image's central square), and the metrics CLI against a benchmark
    folder of the test views' first dataset mask. Checks every stream's
    PNG count, the compositor's launches per view, no deform_mlp launch
    and finite metrics, mIoU and mAcc in [0, 1]."""
    import importlib.util
    import shutil

    from PIL import Image

    from trase_tpu_torch import metrics_segmentation as metrics_cli
    from trase_tpu_torch import render as cli
    from trase_tpu_torch.cluster import __main__ as cluster_cli
    from trase_tpu_torch.cluster import load_clusters
    from trase_tpu_torch.data.masks import decode_mask_file
    from trase_tpu_torch.models.gaussians_io import (load_gaussian_ply,
                                                     save_gaussian_ply)

    seg = os.path.join(root, "segment")
    shutil.copytree(mdl, seg)
    cdir = os.path.join(seg, "point_cloud", f"iteration_{it}")
    ply = os.path.join(cdir, "point_cloud.ply")
    params, aux, n, _ = load_gaussian_ply(ply, sh_degree=3, device=dev)
    xyz = params.xyz[:n]
    med = xyz.median(dim=0).values
    group = (2 * (xyz[:, 0] > med[0]).long() + (xyz[:, 1] > med[1]).long())
    gen = torch.Generator().manual_seed(7)
    dirs = torch.nn.functional.normalize(torch.randn(4, 32, generator=gen),
                                         dim=1).to(dev)
    feats = params.gaussian_features.clone()
    feats[:n] = dirs[group] + 0.05 * torch.randn(n, 32, generator=gen).to(dev)
    save_gaussian_ply(ply, params._replace(gaussian_features=feats),
                      aux.alive)

    t0 = time.perf_counter()
    cluster_cli.main(["-m", seg, "--kmeans", "--k", str(SEGMENT_K),
                      "--device", dev.type])
    out = {"gaussians": n, "kmeans_k": SEGMENT_K,
           "kmeans_cli_s": time.perf_counter() - t0}
    if importlib.util.find_spec("sklearn") is not None:
        t0 = time.perf_counter()
        cluster_cli.main(["-m", seg])
        hd, _ = load_clusters(os.path.join(cdir, "clusters.pt"))
        out["hdbscan"] = {"ran": True, "seconds": time.perf_counter() - t0,
                          "clusters": int(len(np.unique(hd)))}
    else:
        out["hdbscan"] = {"ran": False, "why": "sklearn is not installed"}
    ids, _ = load_clusters(os.path.join(cdir, "clusters_kmeans.pt"))
    sid = int(np.bincount(ids).argmax())
    mask = np.zeros((64, 64), np.uint8)
    mask[16:48, 16:48] = 255
    mask_png = os.path.join(root, "center.png")
    Image.fromarray(mask).save(mask_png)

    reset_counts()
    t0 = time.perf_counter()
    cli.main(["-s", src, "-m", seg, "--iteration", str(it),
              "--pairs_per_gaussian", "6", "--use_kmeans", "--segment_ids",
              str(sid), "--text_prompt_mask", mask_png, "--threshold", "50",
              "--device", dev.type])
    out["render_cli_s"] = time.perf_counter() - t0
    launches, layouts = counts(), layout_counts()
    text = "text_prompt_center_objects"
    pngs, videos = {}, 0
    for split_name, nv in (("train", n_train), ("test", n_test)):
        base = os.path.join(seg, split_name, f"ours_{it}")
        for s in ("renders", "gt", "canonical", "rendered_feats",
                  "pointcloud", "gaussian_feats", "gaussian_clusters",
                  "segmentation", "pred_masks", "segment_objects", text):
            got = len([f for f in os.listdir(os.path.join(base, s))
                       if f.endswith(".png")])
            want = 1 if s == "canonical" else nv
            assert got == want, (split_name, s, got, want)
            pngs[f"{split_name}/{s}"] = got
        videos += len([f for f in os.listdir(base) if f.endswith(".mp4")])
    # per view: renders, rendered_feats, segmentation, pred_masks,
    # segment_objects, the text-prompt object (2); canonical once per split
    views = n_train + n_test
    assert launches == dict(composite_fwd=7 * views + 2, composite_bwd=0,
                            reduce_pair_grads=0, deform_mlp=0), launches

    bench = os.path.join(root, "benchmark")
    for sub in ("gt_masks", "gt_masks_object"):
        os.makedirs(os.path.join(bench, sub))
    for i in range(n_test):
        m = decode_mask_file(os.path.join(src, "images", "masks",
                                          f"test_{i:04d}.npz"))[0]
        with Image.open(os.path.join(src, "images",
                                     f"test_{i:04d}.png")) as im:
            img = np.asarray(im.convert("RGB"))
        Image.fromarray((m * 255).astype(np.uint8)).save(
            os.path.join(bench, "gt_masks", f"{i:05d}.png"))
        Image.fromarray((img * m[..., None]).astype(np.uint8)).save(
            os.path.join(bench, "gt_masks_object", f"{i:05d}.png"))
    t0 = time.perf_counter()
    metrics_cli.main(["-m", seg, "--benchmark_path", bench, "--device",
                      dev.type])
    out["metrics_cli_s"] = time.perf_counter() - t0
    with open(os.path.join(seg, "results.json")) as f:
        results = json.load(f)[f"ours_{it}"]
    for k in ("mIOU", "mACC"):
        assert 0.0 <= results[k] <= 1.0, (k, results[k])
    for k in ("SSIM", "PSNR"):
        assert np.isfinite(results[k]), (k, results[k])
    out.update(segment_id=sid, segment_size=int((ids == sid).sum()),
               png_counts=pngs, videos=videos, results=results,
               launches=launches, layouts=layouts,
               launches_per_view=(launches["composite_fwd"] - 2) / views)
    return out


def kmeans_phase(params, n, dev) -> dict:
    """kmeans_cluster on the bench scene's n x 32 features (KMEANS_K
    clusters, KMEANS_ITERS iterations, on the card): host-clock seconds of
    the whole call and of the k-means++ init on the host, and the Lloyd
    iterations' device time (CUDA events)."""
    from trase_tpu_torch.cluster import clustering as CL

    feats = params.gaussian_features[:n].cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, _, centers = CL.kmeans_cluster(feats, k=KMEANS_K,
                                        iters=KMEANS_ITERS, device=dev)
    seconds = time.perf_counter() - t0
    assert ids.shape == (n,) and 0 <= ids.min() and ids.max() < KMEANS_K
    assert np.isfinite(centers).all()
    xn = CL._normalize(feats).astype(np.float32)
    t0 = time.perf_counter()
    init = CL.kmeans_init(xn, KMEANS_K, 0)
    init_s = time.perf_counter() - t0
    x = torch.from_numpy(xn).to(dev)
    c0 = torch.from_numpy(init).to(dev)
    return {"points": n, "k": KMEANS_K, "iterations": KMEANS_ITERS,
            "seconds": seconds, "init_seconds": init_s,
            "lloyd_ms": cuda_ms(lambda: CL.lloyd(x, c0, KMEANS_ITERS), 2),
            "nonempty_clusters": int((np.bincount(
                ids, minlength=KMEANS_K) > 0).sum())}


def train_state(params, aux, net):
    from trase_tpu_torch.engine import trainer as TT

    return TT.init_train_state(params, aux, TT.deform_tensors(net))


def train_step_fn(params, aux, cam, net, cfg, dev, carry=True):
    """One GAUSSIAN step of the bench scene per call (bf16 deform stack,
    lambda_dssim 0.2, gt zeros); returns the step's metrics. With
    `carry` each call continues from the last call's state (training);
    without, every call starts from the initial state (the same work
    each time: gt zeros empty the scene within a few steps)."""
    from trase_tpu_torch.config import OptimizationParams
    from trase_tpu_torch.engine import trainer as TT

    lr_at = TT.make_learning_rate_schedules(OptimizationParams())
    gt = torch.zeros((3, cam.image_height, cam.image_width), device=dev)
    bg = torch.zeros(3, device=dev)
    init = train_state(params, aux, net)
    box = {"state": init, "i": 0}

    def step():
        box["i"] += 1
        state, m = TT.gaussian_phase_step(
            box["state"], cam, gt, (box["i"] % 10) / 10, 0.0,
            lr_at(3000 + box["i"]), bg, deform_net=net, sh_degree=3,
            use_deform=True, is_6dof=False, lambda_dssim=0.2,
            lambda_reg_deform=0.0, raster_cfg=cfg)
        if carry:
            box["state"] = state
        return m

    step.box = box
    return step


def train_step_phase(params, aux, cam, net, cfg, dev) -> dict:
    from trase_tpu_torch.engine import trainer as TT

    step = train_step_fn(params, aux, cam, net, cfg, dev)
    reset_counts()
    losses = []
    for _ in range(TRAIN_WARMUP):
        losses.append(step()["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finite = []
    for _ in range(TRAIN_STEPS):
        m = step()
        losses.append(m["loss"])
        finite.append(m["finite"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    launches, layouts = counts(), layout_counts()
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    assert launches == dict(compositor(n_steps), deform_mlp=0), launches
    assert layouts == {"composite_fwd/4/0/1/1": n_steps,
                       "composite_bwd/4/0/1/0": n_steps,
                       "reduce_pair_grads/10": n_steps}, layouts
    losses = [float(x) for x in losses]
    assert all(bool(f) for f in finite), "a step was skipped as non-finite"
    state = step.box["state"]
    for x in TT.float_tensors(state):
        assert bool(torch.isfinite(x).all()), "non-finite state tensor"
    assert losses[-1] < losses[0], losses
    assert float(state.aux.denom.sum()) > 0  # densify stats accumulate
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # steps from the initial state: host-clock time, then the per-stage
    # split (wrapped calls)
    del step
    fixed = train_step_fn(params, aux, cam, net, cfg, dev, carry=False)
    fixed()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        fixed()
    torch.cuda.synchronize()
    fixed_ms = (time.perf_counter() - t0) / 5 * 1e3
    timer = StageTimer()
    try:
        splits = []
        for _ in range(4):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fixed()
            b.record()
            splits.append(timer.step_split(a, b))
    finally:
        timer.restore()
    split = {k: sum(s[k] for s in splits[1:]) / (len(splits) - 1)
             for k in splits[-1]}
    # the deform MLP's forward + backward alone, bf16 stack
    dp = [t.detach().requires_grad_(True) for t in state.deform]

    def deform_fb():
        d = TT.apply_deform(net, dp, state.params.xyz, 0.5, 0.0, True)
        torch.autograd.grad([x.sum() for x in d], dp)

    split["deform_fwd_bwd_alone"] = cuda_ms(deform_fb, 5)
    return {"steps": n_steps, "timed_steps": TRAIN_STEPS, "step_ms": step_ms,
            "step_ms_initial_state": fixed_ms,
            "losses": losses, "launches": launches, "layouts": layouts,
            "stage_ms": split,
            "peak_memory_gib": peak,
            "n_alive": int(state.aux.alive.sum())}


def feature_masks(dev):
    """FEATURE_MASKS seeded elliptical regions at half the render's
    resolution, each a different one, some overlapping (identical masks,
    as in bench.py:178, would leave no negative pair)."""
    hm, wm = HEIGHT // 2, WIDTH // 2
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:hm, 0:wm].astype(np.float32)
    masks = np.zeros((FEATURE_MASKS, hm, wm), np.float32)
    for m in range(FEATURE_MASKS):
        cy, cx = rng.uniform(0.2, 0.8) * hm, rng.uniform(0.2, 0.8) * wm
        ry, rx = rng.uniform(0.1, 0.3) * hm, rng.uniform(0.1, 0.3) * wm
        masks[m] = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    return (torch.tensor(masks, device=dev),
            torch.ones(FEATURE_MASKS, dtype=torch.bool, device=dev))


def feature_step_fn(init, cam, net, cfg, dev, stats, carry=True):
    """One FEATURE step of the bench scene per call, from `init` (bf16
    deform stack, smoothing over a KNN map of init's xyz, soft mode);
    `stats` picks the arm. With `carry` each call continues from the last
    call's state; without, every call starts from `init`."""
    from trase_tpu_torch.config import OptimizationParams
    from trase_tpu_torch.engine import trainer as TT
    from trase_tpu_torch.ops.knn import (build_feature_smooth_map,
                                         transpose_smooth_map)

    lr_at = TT.make_learning_rate_schedules(OptimizationParams())
    masks, valid = feature_masks(dev)
    with torch.no_grad():
        smooth_map = transpose_smooth_map(
            build_feature_smooth_map(init.params.xyz, SMOOTH_K))
    gen = torch.Generator(device=dev).manual_seed(1)
    bg = torch.zeros(3, device=dev)
    box = {"state": init, "i": 0}

    def step():
        box["i"] += 1
        state, m = TT.feature_phase_step(
            box["state"], cam, masks, valid, (box["i"] % 10) / 10,
            lr_at(10000 + box["i"]), bg, smooth_map, deform_net=net,
            sh_degree=3, use_deform=True, is_6dof=False,
            contrastive_mode="soft", rfn=1.0, positive_th=0.75,
            negative_th=0.5, num_sampled_pixels=FEATURE_PIXELS,
            num_sampled_masks=FEATURE_MASKS, raster_cfg=cfg,
            with_densify_stats=stats, generator=gen)
        if carry:
            box["state"] = state
        return m

    step.box = box
    return step


def smooth_bwd_check(dev) -> dict:
    """The smoothing's backward (csrc/smooth_rows_bwd.cu) at the n3v
    benchmark's map (SMOOTH_BWD_ROWS x SMOOTH_K slots, half of them drawn,
    SMOOTH_BWD_FEATURES features; SMOOTH_BWD_DEAD dead rows tied at the
    origin, whose neighbours are hubs) on a seeded cotangent: equal to
    smooth_rows_bwd_plain and to a second call, within 1e-5 (of the
    largest magnitude) of the same sums in float64, with autograd's
    gather-mean backward's error beside it; one counted launch a call. Its
    queued ms for each hub chunk length (SMOOTH_BWD_CHUNKS) beside
    index_add_ of the drawn rows (queued) and autograd's backward of the
    gather-mean (host-paced), the plain version's ms, the bytes
    bound (each input and output byte once), the transpose's ms and the
    map's in-degree histogram."""
    from trase_tpu_torch.ops import cuda_lib as CL
    from trase_tpu_torch.ops import knn as K

    n, dead, f = SMOOTH_BWD_ROWS, SMOOTH_BWD_DEAD, SMOOTH_BWD_FEATURES
    live = n - dead
    g = torch.Generator(device=dev).manual_seed(23)
    lo = torch.tensor([-3.0, -3.0, 2.0], device=dev)
    centres = lo + 6.0 * torch.rand((SMOOTH_BWD_BLOBS, 3), generator=g,
                                    device=dev)
    xyz = torch.zeros((n, 3), device=dev)
    xyz[:live] = centres[torch.randint(0, SMOOTH_BWD_BLOBS, (live,),
                                       generator=g, device=dev)] \
        + 0.3 * torch.randn((live, 3), generator=g, device=dev)
    with torch.no_grad():
        idx = K.build_feature_smooth_map(xyz, SMOOTH_K)
    del xyz
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smap = K.transpose_smooth_map(idx)
    torch.cuda.synchronize()
    transpose_ms = (time.perf_counter() - t0) * 1e3
    slots = K.smooth_slots(SMOOTH_K, generator=g)
    n_sel = slots.numel()
    cot = torch.randn((n, f), generator=g, device=dev)

    def kernel(m=smap):
        return K.smooth_rows_bwd(cot, m, slots)

    before = CL.LAYOUT_LAUNCHES.get(("smooth_rows_bwd",), 0)
    got, again = kernel(), kernel()
    assert CL.LAYOUT_LAUNCHES[("smooth_rows_bwd",)] == before + 2
    assert torch.equal(got, again), "smooth_rows_bwd differs between calls"
    plain = K.smooth_rows_bwd_plain(cot, smap, slots)
    assert torch.equal(got, plain), "smooth_rows_bwd differs from plain"
    sel = idx[:, slots]
    normed = torch.zeros((n, f), device=dev, requires_grad=True)
    gathered = normed[sel].mean(dim=1)

    def autograd_bwd():
        return torch.autograd.grad(gathered, normed, cot, retain_graph=True)[0]

    exact = torch.zeros((n, f), dtype=torch.float64, device=dev).index_add_(
        0, sel.reshape(-1), cot.double().repeat_interleave(n_sel, 0)) / n_sel
    scale = float(exact.abs().max())
    err = float((got.double() - exact).abs().max()) / scale
    autograd_err = float((autograd_bwd().double() - exact).abs().max()) \
        / scale
    assert err <= 1e-5, (err, autograd_err)
    del got, again, plain, exact
    maps = {c: (smap if c == smap.chunk else K.transpose_smooth_map(
        idx, chunk=c)) for c in SMOOTH_BWD_CHUNKS}
    src = (cot / n_sel).repeat_interleave(n_sel, 0)
    flat = sel.reshape(-1)
    reps = repeated_ms({
        **{f"chunk_{c}": (lambda m=m: kernel(m)) for c, m in maps.items()},
        "index_add": lambda: torch.zeros((n, f), device=dev).index_add_(
            0, flat, src)})
    del src
    deg = (smap.rev_ptr[1:] - smap.rev_ptr[:-1]).long()
    edges = (0, 1, 9, 17, 33, 65, 257, 4097, 2 ** 31)
    hist = {f"{a}-{b - 1}": int(((deg >= a) & (deg < b)).sum())
            for a, b in zip(edges[:-1], edges[1:])}
    entries = n * SMOOTH_K
    moved = {"g": n * f * 4, "rev_ptr": (n + 1) * 4, "rev_src": entries * 4,
             "rev_slot": entries, "grad": n * f * 4,
             "chunks": smap.part_begin.numel() * (8 + 2 * f * 4)
             + smap.hub_rows.numel() * 8}
    main = reps[f"chunk_{smap.chunk}"]
    return {"rows": n, "dead": dead, "slots": SMOOTH_K, "drawn": n_sel,
            "features": f, "chunk": smap.chunk,
            "max_in_degree": smap.max_in_degree,
            "hub_rows": smap.hub_rows.numel(),
            "hub_chunks": smap.part_begin.numel(),
            "in_degree_hist": hist, "equal_to_plain": True,
            "bit_identical_relaunch": True, "max_rel_err": err,
            "autograd_max_rel_err": autograd_err, "ms": main["median"],
            "ms_repeats": main,
            "ms_by_chunk": {c: reps[f"chunk_{c}"]["median"]
                            for c in SMOOTH_BWD_CHUNKS},
            "index_add_ms": reps["index_add"]["median"],
            "autograd_ms": cuda_ms(autograd_bwd, 5),
            "plain_ms": cuda_ms(lambda: K.smooth_rows_bwd_plain(
                cot, smap, slots), 2),
            "bound_ms": sum(moved.values()) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes": moved,
            "gathered_rows": int(sel.numel()), "transpose_ms": transpose_ms}


def changed_fields(old, new) -> list:
    """Names of the state's tensors that differ between two states."""
    out = []
    for part in ("params", "aux", "opt"):
        for name, a, b in zip(getattr(old, part)._fields, getattr(old, part),
                              getattr(new, part)):
            pairs = (zip(a, b) if part == "opt" else [(a, b)])
            if not all(torch.equal(x, y) for x, y in pairs):
                out.append(f"{part}.{name}")
    for i, (a, b) in enumerate(zip(old.deform, new.deform)):
        if not torch.equal(a, b):
            out.append(f"deform.{i}")
    return out


def feature_step_phase(params, aux, cam, net, cfg, dev) -> dict:
    """The FEATURE step at the bench scene in both arms: TRAIN_WARMUP +
    TRAIN_STEPS carried steps each, counted (one launch of each kernel
    per step, in the features-only packed instantiation: values-only in
    the second arm), checked (finite; only the features, their Adam
    state and, with stats, the densification accumulators change) and
    timed; then steps from the initial state split by stage, and the
    smoothing's backward at the benchmark's map (smooth_bwd_check)."""
    from trase_tpu_torch.ops.knn import (build_feature_smooth_map,
                                         transpose_smooth_map)

    init = train_state(params, aux, net)
    xyz = init.params.xyz
    with torch.no_grad():
        smooth_ms = cuda_ms(lambda: build_feature_smooth_map(xyz, SMOOTH_K),
                            3)
        nmap = build_feature_smooth_map(xyz, SMOOTH_K)
        transpose_ms = cuda_ms(lambda: transpose_smooth_map(nmap), 3)
    out = {"masks": [FEATURE_MASKS, HEIGHT // 2, WIDTH // 2],
           "sampled_pixels": FEATURE_PIXELS, "smooth_k": SMOOTH_K,
           "contrastive_mode": "soft", "smooth_map_ms": smooth_ms,
           "smooth_transpose_ms": transpose_ms,
           "launches": {}, "layouts": {}, "arms": {}}
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    for stats in (True, False):
        arm = "densify_stats" if stats else "values_only"
        step = feature_step_fn(init, cam, net, cfg, dev, stats)
        reset_counts()
        first = [step() for _ in range(TRAIN_WARMUP)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = [step() for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
        launches, layouts = counts(), layout_counts()
        assert launches == dict(compositor(n_steps), deform_mlp=0,
                                **smoothing(n_steps)), launches
        want = {"composite_fwd/32/16/0/1": n_steps,
                f"composite_bwd/32/16/0/{int(not stats)}": n_steps,
                "reduce_pair_grads/38": n_steps, "smooth_rows_bwd": n_steps}
        assert layouts == want, (arm, layouts)
        metrics = first + ms
        assert all(bool(m["finite"]) for m in metrics), arm
        state = step.box["state"]
        for x in state.params + tuple(state.opt.gaussian_features[:2]):
            assert bool(torch.isfinite(x).all()), "non-finite state tensor"
        changed = changed_fields(init, state)
        expect = ["params.gaussian_features", "opt.gaussian_features"]
        if stats:
            expect[1:1] = ["aux.max_radii2d", "aux.xyz_gradient_accum",
                           "aux.denom"]
        assert changed == expect, (arm, changed)
        out["launches"][arm] = launches
        out["layouts"][arm] = layouts
        out["arms"][arm] = {
            "step_ms": step_ms, "changed": changed,
            "losses": [float(m["loss"]) for m in metrics],
            "last": {k: float(metrics[-1][k])
                     for k in ("rfn", "pos_sim", "neg_sim", "overflow")}}
        del step
        fixed = feature_step_fn(init, cam, net, cfg, dev, stats, carry=False)
        fixed()
        timer = StageTimer(feature=True)
        try:
            splits = []
            for _ in range(4):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fixed()
                b.record()
                splits.append(timer.step_split(a, b))
        finally:
            timer.restore()
        out["arms"][arm]["stage_ms"] = {
            k: sum(sp[k] for sp in splits[1:]) / (len(splits) - 1)
            for k in splits[-1]}
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del init, xyz, nmap
    out["smooth_rows_bwd"] = smooth_bwd_check(dev)
    return out


def train_cli_phase(src, root, dev, n_train, n_test) -> dict:
    """trase_tpu_torch.train on the CLI dataset with densification and an
    opacity reset inside the run, crossing warm_up_3d_features
    (CLI_FEATURE_FROM) into two FEATURE blocks, the second of which runs
    past densify_until_iter (values-only), then the render CLI on its
    snapshot."""
    from trase_tpu_torch import render as cli
    from trase_tpu_torch import train as train_cli
    from trase_tpu_torch.engine import trainer as TT

    mdl = os.path.join(root, "trained")
    it = CLI_ITERATIONS
    events = {"densify": [], "reset": [], "feature": []}
    densify, reset = TT.densify_step, TT.reset_opacity_step
    feature = TT.feature_phase_step

    def count_densify(*a, **kw):
        out = densify(*a, **kw)
        events["densify"].append({k: int(v) for k, v in out[1].items()})
        return out

    def count_reset(*a, **kw):
        events["reset"].append(1)
        return reset(*a, **kw)

    def count_feature(*a, **kw):
        events["feature"].append(kw["with_densify_stats"])
        return feature(*a, **kw)

    TT.densify_step, TT.reset_opacity_step = count_densify, count_reset
    TT.feature_phase_step = count_feature
    reset_counts()
    t0 = time.perf_counter()
    try:
        trainer = train_cli.main([
            "-s", src, "-m", mdl, "--iterations", str(it), "--eval",
            "--warm_up", "100", "--densify_from_iter", "50",
            "--densification_interval", "100", "--opacity_reset_interval",
            "250", "--warm_up_3d_features", str(CLI_FEATURE_FROM),
            "--iterative_opt_interval", str(CLI_INTERVAL),
            "--densify_until_iter", str(CLI_DENSIFY_UNTIL),
            "--num_sampled_pixels", "1024", "--num_sampled_masks", "3",
            "--pairs_per_gaussian", "6", "--device", dev.type, "--quiet"])
    finally:
        TT.densify_step, TT.reset_opacity_step = densify, reset
        TT.feature_phase_step = feature
    seconds = time.perf_counter() - t0
    launches, layouts = counts(), layout_counts()
    block = CLI_INTERVAL + 1
    n_feature = 2 * block
    assert launches == dict(compositor(it), deform_mlp=0,
                            **smoothing(n_feature)), launches
    n_stats = block + CLI_DENSIFY_UNTIL - (CLI_FEATURE_FROM + 2 * block)
    assert events["feature"] == [True] * n_stats + [False] * (
        n_feature - n_stats), events["feature"]
    assert trainer.feature_calls == n_feature
    assert trainer.step_calls == it - n_feature
    assert int(trainer.skipped) == 0
    assert layouts["composite_bwd/32/16/0/1"] == n_feature - n_stats
    assert len(events["densify"]) >= 1 and len(events["reset"]) >= 1, events
    cli.main(["-s", src, "-m", mdl, "--iteration", str(it),
              "--pairs_per_gaussian", "6", "--device", dev.type])
    pngs = check_pngs(mdl, it, n_train, n_test)
    return {"iterations": it, "seconds": seconds,
            "it_per_s": it / seconds, "launches": launches,
            "layouts": layouts, "feature_steps": n_feature,
            "feature_steps_values_only": n_feature - n_stats,
            "densify": events["densify"], "opacity_resets":
            len(events["reset"]), "n_alive": trainer._n_alive_cache,
            "capacity": int(trainer.state.params.xyz.shape[0]),
            "png_counts": pngs}


def compare_datasets(a, b) -> dict:
    """Two synthetic dataset directories of the same views: the largest
    8-bit difference of their PNGs and the largest share of mask pixels
    that differ; their transforms JSON and points3d.ply must be equal."""
    from PIL import Image

    from trase_tpu_torch.data.masks import decode_mask_file

    png, mask, views = 0, 0.0, 0
    for split_name in ("train", "test"):
        with open(os.path.join(a, f"transforms_{split_name}.json")) as f:
            ja = json.load(f)
        with open(os.path.join(b, f"transforms_{split_name}.json")) as f:
            assert json.load(f) == ja, split_name
        for frame in ja["frames"]:
            name = os.path.basename(frame["file_path"])
            ia, ib = (np.asarray(Image.open(os.path.join(d, "images",
                                                         f"{name}.png")),
                                 np.int32) for d in (a, b))
            ma, mb = (decode_mask_file(os.path.join(d, "images", "masks",
                                                    f"{name}.npz"))
                      for d in (a, b))
            assert ma.shape == mb.shape and ma.any(), name
            png = max(png, int(np.abs(ia - ib).max()))
            mask = max(mask, float((ma != mb).mean()))
            views += 1
    plys = []
    for d in (a, b):
        with open(os.path.join(d, "points3d.ply"), "rb") as f:
            plys.append(f.read())
    assert plys[0] == plys[1], "points3d.ply differs"
    return {"views": views, "png_max_levels": png, "mask_max_share": mask}


def synthetic_phase(root, dev) -> dict:
    """The port's synthetic writer on the card: 256x256 with the fast GT
    (the compositor kernel, two launches a view) against the oracle GT,
    PNGs within one 8-bit level and masks differing on at most 0.5 % of
    pixels; then the fast GT at 1008x1008, seconds per view."""
    from trase_tpu_torch.data.synthetic import write_synthetic_dataset

    fast, oracle = (os.path.join(root, n) for n in ("syn_fast", "syn_oracle"))
    reset_counts()
    t0 = time.perf_counter()
    write_synthetic_dataset(fast, image_size=SYN_SIZE, fast_gt=True,
                            device=dev)
    torch.cuda.synchronize()
    fast_s = time.perf_counter() - t0
    launches, layouts = counts(), layout_counts()
    t0 = time.perf_counter()
    write_synthetic_dataset(oracle, image_size=SYN_SIZE, fast_gt=False,
                            device=dev)
    oracle_s = time.perf_counter() - t0
    row = compare_datasets(oracle, fast)
    n_views = row["views"]
    assert launches == dict(compositor(0), composite_fwd=2 * n_views,
                            deform_mlp=0), launches
    assert row["png_max_levels"] <= SYN_PNG_LEVELS, row
    assert row["mask_max_share"] <= SYN_MASK_SHARE, row
    big = os.path.join(root, "syn_1008")
    reset_counts()
    t0 = time.perf_counter()
    write_synthetic_dataset(big, n_train=SYN_BIG_VIEWS[0],
                            n_test=SYN_BIG_VIEWS[1], image_size=SYN_BIG_SIZE,
                            fast_gt=True, device=dev)
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t0
    big_views = sum(SYN_BIG_VIEWS)
    big_launches = counts()
    assert big_launches == dict(compositor(0), composite_fwd=2 * big_views,
                                deform_mlp=0), big_launches
    from PIL import Image

    with Image.open(os.path.join(big, "images", "train_0000.png")) as im:
        assert im.size == (SYN_BIG_SIZE, SYN_BIG_SIZE)
    for k, v in layout_counts().items():  # the path's launches: both runs
        layouts[k] = layouts.get(k, 0) + v
    launches["composite_fwd"] += big_launches["composite_fwd"]
    return {"size": SYN_SIZE, **row, "png_tol": SYN_PNG_LEVELS,
            "mask_tol": SYN_MASK_SHARE, "seconds_fast": fast_s,
            "seconds_oracle": oracle_s, "s_per_view_fast": fast_s / n_views,
            "s_per_view_oracle": oracle_s / n_views,
            "size_big": SYN_BIG_SIZE, "views_big": big_views, "seconds_big": big_s,
            "s_per_view_big": big_s / big_views,
            "launches_big": big_launches, "launches": launches,
            "layouts": layouts}


def _flat_state(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_state(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _run_state(tr) -> dict:
    """What a resume restores besides the state tensors: SH degree, the
    phase machine, the generators (feature_gen on the card) and the
    skipped-step counters."""
    return {"sh": tr.active_sh_degree,
            "phase": (tr.opt_state.state, tr.opt_state.iterations),
            "np_rng": tr.np_rng.bit_generator.state,
            "densify_gen": tr.densify_gen.get_state().numpy().tobytes(),
            "feature_gen": tr.feature_gen.get_state().numpy().tobytes(),
            "feature_gen_device": tr.feature_gen.device.type,
            "skipped": (int(tr.skipped), tr._skipped_seen)}


def resume_phase(root, dev) -> dict:
    """The train CLI's run state on the card, on a dataset the port's
    writer wrote (8 train and 2 test views at 256x256, the n_times rig,
    with masks): (a) a run to 2M with --checkpoint_iterations M, past
    warm_up_3d_features into FEATURE blocks before M; (b) a run resumed
    from chkpnt<M>.pkl to 2M, with --profile_iters over 3 of its
    iterations. Checks: (b)'s loaded state, Adam moments, phase machine
    and generator states equal (a)'s at M bit for bit; (b) launches each
    compositor kernel once per iteration M+1..2M (and the forward once
    per evaluated view); its final test PSNR within RESUME_PSNR_BAND dB of
    (a)'s; the trace names the three compositor kernels."""
    from trase_tpu_torch import train as train_cli
    from trase_tpu_torch.data.synthetic import write_synthetic_dataset
    from trase_tpu_torch.engine import loop as TL
    from trase_tpu_torch.engine import trainer as TT

    src = os.path.join(root, "resume_data")
    write_synthetic_dataset(src, n_train=8, n_test=2, image_size=RESUME_SIZE,
                            n_times=4, fast_gt=True, device=dev)
    m = RESUME_M
    a_dir, b_dir = (os.path.join(root, n) for n in ("resume_a", "resume_b"))
    common = ["-s", src, "--iterations", str(2 * m), "--eval", "--quiet",
              "--test_iterations", str(2 * m), "--save_iterations",
              str(2 * m), "--warm_up", "20", "--densify_from_iter", "10",
              "--densification_interval", "20", "--densify_until_iter",
              str(m + 30), "--warm_up_3d_features", str(RESUME_FEATURE_FROM),
              "--iterative_opt_interval", "14", "--device", dev.type]
    seen = {}
    save, load = TL.Trainer.save_ckpt, TL.Trainer.load_ckpt

    def timed_save(self, iteration):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(self, iteration)
        seen["save_s"] = time.perf_counter() - t0
        seen["saved"] = TT.train_state_to_numpy(self.state)
        seen["saved_run"] = _run_state(self)
        seen["feature_calls_at_m"] = self.feature_calls

    def timed_load(self, path):
        t0 = time.perf_counter()
        it = load(self, path)
        torch.cuda.synchronize()
        seen["load_s"] = time.perf_counter() - t0
        seen["loaded"] = TT.train_state_to_numpy(self.state)
        seen["loaded_run"] = _run_state(self)
        return it

    TL.Trainer.save_ckpt, TL.Trainer.load_ckpt = timed_save, timed_load
    try:
        t0 = time.perf_counter()
        tr_a = train_cli.main(common + ["-m", a_dir, "--checkpoint_iterations",
                                        str(m)])
        a_s = time.perf_counter() - t0
        ckpt = os.path.join(a_dir, f"chkpnt{m}.pkl")
        reset_counts()
        t0 = time.perf_counter()
        p0 = RESUME_PROFILE_FROM
        tr_b = train_cli.main(common + ["-m", b_dir, "--start_checkpoint", ckpt,
                                        "--profile_iters", str(p0),
                                        str(p0 + 3)])
        b_s = time.perf_counter() - t0
    finally:
        TL.Trainer.save_ckpt, TL.Trainer.load_ckpt = save, load
    launches, layouts = counts(), layout_counts()
    assert seen["feature_calls_at_m"] > 0, "no FEATURE step before M"
    flat_saved, flat_loaded = (_flat_state(seen[k]) for k in ("saved",
                                                              "loaded"))
    assert sorted(flat_saved) == sorted(flat_loaded)
    differ = [k for k in flat_saved
              if flat_saved[k].dtype != flat_loaded[k].dtype
              or not np.array_equal(flat_saved[k], flat_loaded[k])]
    assert not differ, f"loaded state differs from the saved: {differ[:8]}"
    assert seen["loaded_run"] == seen["saved_run"], (seen["loaded_run"],
                                                     seen["saved_run"])
    assert seen["loaded_run"]["feature_gen_device"] == dev.type
    evaluated = 10  # views 5, 10, ..., 25 of each split, at 2M
    assert launches == dict(compositor(m), deform_mlp=0,
                            composite_fwd=m + evaluated,
                            **smoothing(tr_b.feature_calls)), launches
    assert tr_b.step_calls + tr_b.feature_calls == m
    psnr_a, psnr_b = tr_a.best_psnr, tr_b.best_psnr
    assert 10.0 < psnr_a < 60.0, psnr_a
    assert abs(psnr_b - psnr_a) <= RESUME_PSNR_BAND, (psnr_a, psnr_b)
    with open(tr_b.profile_trace) as f:
        trace = f.read()
    named = {k: k in trace for k in ("composite_fwd_kernel",
                                     "composite_bwd_kernel",
                                     "reduce_pair_grads_kernel")}
    assert all(named.values()), named
    return {"m": m, "iterations": 2 * m,
            "feature_steps_before_m": seen["feature_calls_at_m"],
            "feature_steps_resumed": tr_b.feature_calls,
            "seconds_a": a_s, "seconds_b": b_s,
            "save_ckpt_s": seen["save_s"], "load_ckpt_s": seen["load_s"],
            "checkpoint_mb": os.path.getsize(ckpt) / 2**20,
            "capacity": int(tr_b.state.params.xyz.shape[0]),
            "n_alive": tr_b._n_alive_cache,
            "state_tensors_equal": len(flat_saved),
            "test_psnr_a": psnr_a, "test_psnr_b": psnr_b,
            "psnr_band": RESUME_PSNR_BAND,
            "trace": os.path.basename(tr_b.profile_trace),
            "trace_mb": os.path.getsize(tr_b.profile_trace) / 2**20,
            "trace_names": named, "launches": launches, "layouts": layouts}


if __name__ == "__main__":
    sys.exit(main())
