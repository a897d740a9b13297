#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (trase_tpu_torch) on one card.

    python3 chip_smoke.py            # from the repository root

Drives the port's serving and training paths on the card and prints one
JSON line per phase:

1. device       the card's name and power limit (nvidia-smi), torch's view;
2. build        nvcc builds csrc/*.cu for sm_90a, one process per source,
                all started together; build seconds;
3. compare      the CUDA compositor against its plain PyTorch version
                (composite_plain) on the same inputs, for 4 values
                (rgb+depth), 36 (+32 features) and 36 with bf16-packed
                features, at a small random scene and at the full scene of
                phase 4; plus the small scene's render against the
                all-pairs oracle;
   compare-bwd  at both scenes (4 values): the forward's residual outputs,
                the backward kernel (composite_bwd) and the reduce kernel
                (reduce_pair_grads) against their plain versions on the
                same inputs and cotangent, with errors per column group,
                and the log T the reverse walk reconstructs at each tile's
                first pair against log 1 = 0;
4. render       the bench scene of bench.py (100k gaussians in a 131072
                capacity, SH degree 3, 32-dim features, DeformNetwork
                8x256, 1008x1344, K=6, seeded): deform_step ->
                renderer.render with and without features, warm-up then
                timed frames; checks the outputs and that the compositor
                kernel ran once per render;
5. cli          writes a small Blender-format dataset and a model
                directory with the port's own writers and runs
                trase_tpu_torch.render;
6. train-step   the same scene through engine.trainer.gaussian_phase_step
                (bf16 deform stack on, lambda_dssim 0.2, gt zeros): warm-up
                then timed steps; checks finiteness, a falling loss and
                one launch of each kernel per step; the per-stage split;
7. train-cli    trase_tpu_torch.train on phase 5's dataset, with densify
                and opacity reset inside the run, then trase_tpu_torch.render
                on its snapshot;
8. profile      torch.profiler over a few frames of phase 4 and a few steps
                of phase 6: device busy time by kernel and the idle share;
9. kernels      one object per kernel: launches, error against the plain
                version, times and the bound.

The last two lines are the nvidia-smi name/power-limit line and
{"ok": true, "device": {...}}. Any failed check raises: the script then
exits non-zero without that line. Without a CUDA device, or without the
package beside it, it exits non-zero at once.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit) for the bound
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# kernel vs plain: same expressions, same order, -fmad=false; only libm
# ulps and the sign of zero may differ. Depth sums reach ~10, so 1e-4.
TOL = {"render": 1e-5, "feats": 1e-5, "alpha": 1e-5, "depth": 1e-4}
# backward kernel vs plain: same per-pixel terms, 256-pixel sums in
# another order: max abs difference over each column group's largest
# magnitude. The reduce kernel sums in the plain version's order: exact.
BWD_TOL = 1e-4
LOGT_FIRST_TOL = 1e-3  # |T reconstructed at a tile's first pair - 1|
WARMUP, FRAMES = 3, 10
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
CLI_ITERATIONS = 300
# the bench scene of bench.py:110-130
N_GAUSSIANS, CAPACITY, HEIGHT, WIDTH = 100_000, 131072, 1008, 1344
KERNELS = {
    "composite_fwd": ("trase_tpu_torch/csrc/composite_fwd.cu",
                      "trase_tpu/ops/rasterize_pallas.py:590"),
    "composite_bwd": ("trase_tpu_torch/csrc/composite_bwd.cu",
                      "trase_tpu/ops/rasterize_pallas.py:817"),
    "reduce_pair_grads": ("trase_tpu_torch/csrc/composite_bwd.cu",
                          "trase_tpu/ops/rasterize_pallas.py:1195"),
}
GROUPS = {"mean2d": (0, 2), "conic": (2, 5), "log_op": (5, 6),
          "values": (6, 10)}


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


def deltas(params, net, fid):
    from trase_tpu_torch.models.deform import deform_step

    t = torch.full((params.xyz.shape[0], 1), fid, device=params.xyz.device)
    return deform_step(net, params.xyz, t)


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


def kernel_inputs(proj, feats, H, W, cfg, pack):
    """composite_fwd's arguments, features packed when `pack`."""
    from trase_tpu_torch.ops import rasterize_cuda as RC

    ci = RC.composite_inputs(proj, feats, H, W,
                             cfg._replace(pack_features=pack))
    payload = ci.payload
    if ci.n_packed:
        payload = RC.pack_feature_words(payload, ci.n_val, ci.n_packed)
    return payload, ci.sorted_gauss, ci.tile_start, ci.n_val, ci.n_packed


def stage_ms(params, aux, cam, net, cfg, with_features, pack, frames=5):
    """Device time of each stage of one frame, from CUDA events recorded
    between the stages on the current stream (launch gaps inside a stage
    count to it), averaged over `frames` frames after one warm-up."""
    from trase_tpu_torch.ops import rasterize_cuda as RC

    names = ("deform", "project", "bin_payload", "composite")
    total = dict.fromkeys(names, 0.0)
    H, W = cam.image_height, cam.image_width
    for i in range(frames + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        d = deltas(params, net, 0.5)
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
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall,
            "top": [{"kernel": k[0][:90], "ms": k[1], "per_frame": k[2]}
                    for k in kernels[:12]]}


def split(hwc):
    return {"alpha": hwc[..., 0], "render": hwc[..., 1:4],
            "feats": hwc[..., 4:-1], "depth": hwc[..., -1]}


def compare(label, proj, feats, H, W, cfg, pack, timed):
    """Kernel vs plain on one input; with `timed`, also times both and
    reckons the bound from this input's bytes and pair-pixel work."""
    from trase_tpu_torch.ops import rasterize_cuda as RC

    args = kernel_inputs(proj, feats, H, W, cfg, pack)
    payload, sg, tile_start, n_val, n_packed = args
    got = RC.composite_fwd(payload, sg, tile_start, H, W, n_val, n_packed)
    torch.cuda.synchronize()
    stats = {}
    ref = RC.composite_plain(payload, sg, tile_start, H, W, n_val, n_packed,
                             stats=stats)
    errs = {}
    for k, g in split(got).items():
        if g.numel():
            errs[k] = float((g - split(ref)[k]).abs().max())
    bad = {k: e for k, e in errs.items() if not e <= TOL[k]}
    row = {"phase": "compare", "scene": label, "n_val": n_val,
           "n_packed": n_packed, "max_abs_diff": errs, "tol": TOL,
           "pairs": int(tile_start[-1])}
    if timed:
        row["ms"] = cuda_ms(lambda: RC.composite_fwd(*args[:3], H, W,
                                                     n_val, n_packed), 20)
        row["plain_ms"] = cuda_ms(lambda: RC.composite_plain(
            *args[:3], H, W, n_val, n_packed), 1)
        pairs = int(tile_start[-1])
        nbytes = (pairs * (4 * payload.shape[1] + 4) + 4 * tile_start.numel()
                  + 4 * H * W * (1 + n_val))
        ops = 16 * stats["evaluated"] + (8 + 2 * n_val) * stats["contributing"]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_FLOPS_PER_S * 1e3
        row.update(bytes=nbytes, ops=ops, evaluated=stats["evaluated"],
                   contributing=stats["contributing"],
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    emit(row)
    if bad:
        raise AssertionError(f"kernel disagrees with plain on {label} "
                             f"n_val={n_val} n_packed={n_packed}: {bad}")
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
    """A Blender-format dataset (transforms_*.json, images, points3d.ply)
    and a model directory, written with the port's own writers."""
    from PIL import Image

    from trase_tpu_torch.config import save_cfg
    from trase_tpu_torch.data.ply import write_point_cloud
    from trase_tpu_torch.models.deform import flax_variables
    from trase_tpu_torch.models.gaussians_io import save_checkpoint, save_gaussian_ply
    from trase_tpu_torch.renderer import make_render_camera, render

    src, mdl = os.path.join(root, "data"), os.path.join(root, "model")
    os.makedirs(os.path.join(src, "images"))
    fov = 0.9
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


def compare_bwd(label, proj, H, W, cfg, timed):
    """Forward residuals, backward kernel and reduce kernel against their
    plain versions on one input and one seeded cotangent; with `timed`,
    also times each and reckons the bounds from this input's counts."""
    from trase_tpu_torch.ops import rasterize_cuda as RC

    ci = RC.composite_inputs(proj, None, H, W, cfg._replace(
        pack_features=False))
    args = (ci.payload, ci.sorted_gauss, ci.tile_start, H, W, 4, 0)
    out, logt, stop = RC.composite_fwd(*args, residuals=True)
    torch.cuda.synchronize()
    ref_out, ref_logt, ref_stop = RC.composite_plain(*args, residuals=True)
    fwd = {"image": float((out - ref_out).abs().max()),
           "logt": float((logt - ref_logt).abs().max()),
           "stop_mismatches": int((stop != ref_stop).sum())}
    gen = torch.Generator(device=proj.mean2d.device).manual_seed(0)
    g = torch.randn((H, W, 5), generator=gen, device=proj.mean2d.device)
    first = torch.empty_like(logt)
    dpair = RC.composite_bwd(*args, g, logt, stop, logt_first=first)
    torch.cuda.synchronize()
    stats = {}
    ref_pair = RC.composite_bwd_plain(*args, g, logt, stop, stats=stats)
    nv = int(ci.tile_start[-1])
    n = ci.payload.shape[0]
    inv = RC.inverse_pairs(ci.sorted_pid)
    dpay = RC.reduce_pair_grads(dpair, inv, ci.tile_start, n)
    torch.cuda.synchronize()
    same_input = RC.reduce_pair_grads_plain(dpair, inv, ci.tile_start, n)
    chain = RC.reduce_pair_grads_plain(ref_pair, inv, ci.tile_start, n)

    def by_group(a, b):
        out_abs, out_rel = {}, {}
        for name, (lo, hi) in GROUPS.items():
            d = float((a[:, lo:hi] - b[:, lo:hi]).abs().max())
            out_abs[name] = d
            out_rel[name] = d / (float(b[:, lo:hi].abs().max()) + 1e-30)
        return out_abs, out_rel

    pair_abs, pair_rel = by_group(dpair[:nv], ref_pair[:nv])
    gauss_abs, gauss_rel = by_group(dpay, chain)
    row = {"phase": "compare-bwd", "scene": label, "pairs": nv,
           "fwd_residuals": fwd,
           "bwd_max_abs_diff": pair_abs, "bwd_max_rel_diff": pair_rel,
           "reduce_max_abs_diff": float((dpay - same_input).abs().max()),
           "per_gaussian_max_abs_diff": gauss_abs,
           "per_gaussian_max_rel_diff": gauss_rel,
           "logt_first_max_abs": float(first.abs().max()),
           "t_first_max_err": float((first.exp() - 1.0).abs().max()),
           "logt_first_vs_plain": float(
               (first - stats["logt_first"]).abs().max()),
           "tol": {"fwd": TOL["depth"], "bwd_rel": BWD_TOL,
                   "reduce": 0.0, "t_first": LOGT_FIRST_TOL}}
    if timed:
        words = 10
        row["bwd_ms"] = cuda_ms(lambda: RC.composite_bwd(
            *args, g, logt, stop), 20)
        row["bwd_plain_ms"] = cuda_ms(lambda: RC.composite_bwd_plain(
            *args, g, logt, stop), 1)
        nbytes = (nv * (4 * words + 4) + nv * 4 * words + 4 * H * W * 5
                  + 8 * logt.numel() + 4 * ci.tile_start.numel())
        ops = 16 * stats["evaluated"] + 51 * stats["counted"]
        row.update(bwd_bytes=nbytes, bwd_ops=ops,
                   evaluated=stats["evaluated"], counted=stats["counted"],
                   **bound("bwd", nbytes, ops))
        row["reduce_ms"] = cuda_ms(lambda: RC.reduce_pair_grads(
            dpair, inv, ci.tile_start, n), 20)
        row["reduce_plain_ms"] = cuda_ms(lambda: RC.reduce_pair_grads_plain(
            dpair, inv, ci.tile_start, n), 3)
        idx = ci.sorted_gauss[:nv].long()
        rows = dpair[:nv].contiguous()
        acc = torch.zeros((n, words), device=dpair.device)
        # the same sums as one PyTorch call (a yardstick only)
        row["reduce_library_ms"] = cuda_ms(
            lambda: acc.index_add_(0, idx, rows), 20)
        k = inv.numel() // n
        rbytes = 4 * inv.numel() + nv * 4 * words + n * 4 * words
        row.update(reduce_bytes=rbytes, reduce_ops=n * k * words,
                   **bound("reduce", rbytes, n * k * words))
    emit(row)
    bad = [k for k, v in pair_rel.items() if not v <= BWD_TOL]
    bad += [k for k, v in gauss_rel.items() if not v <= BWD_TOL]
    if fwd["stop_mismatches"] or not fwd["image"] <= TOL["depth"] \
            or not fwd["logt"] <= TOL["depth"]:
        bad.append("forward residuals")
    if row["reduce_max_abs_diff"] != 0.0:
        bad.append("reduce")
    if not row["t_first_max_err"] <= LOGT_FIRST_TOL:
        bad.append("log T reconstruction")
    if bad:
        raise AssertionError(f"backward kernels disagree with plain on "
                             f"{label}: {bad}")
    return row


def bound(prefix, nbytes, ops):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS_PER_S * 1e3
    return {f"{prefix}_bound_ms": max(bytes_ms, ops_ms),
            f"{prefix}_bound_by": "bytes" if bytes_ms >= ops_ms
            else "operations"}


def counts():
    from trase_tpu_torch.ops import rasterize_cuda as RC

    return {"composite_fwd": RC.FWD_LAUNCHES,
            "composite_bwd": RC.BWD_LAUNCHES,
            "reduce_pair_grads": RC.REDUCE_LAUNCHES}


def reset_counts():
    from trase_tpu_torch.ops import rasterize_cuda as RC

    RC.FWD_LAUNCHES = RC.BWD_LAUNCHES = RC.REDUCE_LAUNCHES = 0


class StageTimer:
    """CUDA events around the functions one training step calls: each
    wrapped call records an event before and after itself on the current
    stream, so the split needs no change to the step. Installed only for
    the split's own steps (not for the counted or timed ones)."""

    def __init__(self):
        import trase_tpu_torch.engine.trainer as TT
        import trase_tpu_torch.ops.rasterize_cuda as RC
        import trase_tpu_torch.renderer as RR

        self.events = []
        composite = RC._Composite
        self.patches = [
            (TT, "apply_deform", "deform_fwd"),
            (RR, "project_gaussians", "project"),
            (RC, "composite_inputs", "bin_payload"),
            (TT, "l1_loss", "loss"), (TT, "ssim", "loss"),
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    run(torch.device("cuda"))
    return 0


def run(dev: torch.device) -> None:
    from trase_tpu_torch.models import gaussians as G
    from trase_tpu_torch.models.deform import init_deform, make_deform_network
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
    for name, (lib, seconds, log) in RC.build_library().items():
        emit({"phase": "build", "source": name, "library": os.path.relpath(lib),
              "seconds": seconds,
              "ptxas": [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]})

    # 3. kernels vs plain (and the small scene vs the oracle)
    rows = []
    proj, feats, H, W = small_scene(dev)
    for pack, f in ((False, None), (False, feats), (True, feats)):
        rows.append(compare("small", proj, f, H, W,
                            RasterConfig(pairs_per_gaussian=16), pack, False))
    with torch.no_grad():
        bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
        cfg16 = RasterConfig(pairs_per_gaussian=16, pack_features=False)
        tiled = RC.rasterize_tiled(proj, feats, bg, H, W, cfg16)
        oracle = rasterize_reference(proj, feats, bg, H, W)
    # the tiled path culls by the exact-support rect, the oracle composites
    # every tail: test_rasterize_pallas.py::test_matches_oracle's 2e-3
    oracle_err = float((tiled["render"] - oracle["render"]).abs().max())
    emit({"phase": "compare", "scene": "small", "against": "oracle",
          "render_max_abs_diff": oracle_err, "tol": 2e-3})
    assert oracle_err <= 2e-3, oracle_err
    bwd_rows = [compare_bwd("small", proj, H, W,
                            RasterConfig(pairs_per_gaussian=16), False)]

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
        for with_features, pack in ((False, False), (True, False),
                                    (True, True)):
            bproj, bfeats = projected(params, aux, cam,
                                      deltas(params, net, 0.5), with_features)
            r = compare("bench", bproj, bfeats, H, W, cfg, pack, True)
            full[(r["n_val"], r["n_packed"])] = r
            rows.append(r)
        bproj, _ = projected(params, aux, cam, deltas(params, net, 0.5),
                             False)
        bwd_rows.append(compare_bwd("bench", bproj, H, W, cfg, True))
    kb = bwd_rows[-1]

    # 4. the serving path: deform_step -> renderer.render, counted
    from trase_tpu_torch.models.deform import deform_step

    bg = torch.zeros(3, device=dev)

    def frame(fid, with_features):
        t = torch.full((cap, 1), fid, device=dev)
        d = deform_step(net, params.xyz, t)
        return render(cam, params, aux.alive, bg, *d, sh_degree=3,
                      with_features=with_features, raster_cfg=cfg)

    launches = {}
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
    # serving keeps the no-residual forward and launches no backward
    assert launches["render"] == {"composite_fwd": calls, "composite_bwd": 0,
                                  "reduce_pair_grads": 0}, launches
    with torch.no_grad():
        stages = stage_ms(params, aux, cam, net, cfg, False, False)
        stages_feats = stage_ms(params, aux, cam, net, cfg, True, True)
    k4, k36 = full[(4, 0)], full[(36, 16)]
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
          "overflow": float(out["overflow"]),
          "alpha_mean": float(out["alpha"].mean())})

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
    assert launches["cli"]["composite_fwd"] == 2 * (n_train + n_test) + 2, \
        launches["cli"]
    emit({"phase": "cli", "png_counts": png_counts,
          "launches": launches["cli"],
          "launches_per_view": launches["cli"]["composite_fwd"]
          / (n_train + n_test)})

    # 6. the training step on the bench scene
    train = train_step_phase(params, aux, cam, net, cfg, dev)
    launches["train_step"] = train.pop("launches")
    emit({"phase": "train-step", **train})

    # 7. the training CLI, then the render CLI on its snapshot
    cli_row = train_cli_phase(src, tmp.name, dev, n_train, n_test)
    launches["train_cli"] = cli_row["launches"]
    emit({"phase": "train-cli", **cli_row})
    tmp.cleanup()

    # 8. where a frame's and a step's device time goes
    with torch.no_grad():
        for with_features in (False, True):
            emit({"phase": "profile", "path": "render",
                  "with_features": with_features,
                  **profile_frames(lambda: frame(0.5, with_features))})
    emit({"phase": "profile", "path": "train-step",
          **profile_frames(train_step_fn(params, aux, cam, net, cfg, dev,
                                         carry=False), frames=3)})

    # 9. kernels
    fwd_err = max(max(r["max_abs_diff"].values()) for r in rows)
    fwd_err = max([fwd_err] + [max(r["fwd_residuals"]["image"],
                                   r["fwd_residuals"]["logt"])
                               for r in bwd_rows])
    bwd_err = max(max(r["bwd_max_abs_diff"].values()) for r in bwd_rows)
    red_err = max(r["reduce_max_abs_diff"] for r in bwd_rows)
    entries = [
        dict(name="composite_fwd", launches=launches["render"][
            "composite_fwd"], max_abs_err=fwd_err, ms=k4["ms"],
             plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
             bound_by=k4["bound_by"], library_ms=None,
             variants=[{k: r[k] for k in ("n_val", "n_packed", "ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "pairs", "evaluated",
                                          "contributing")}
                       for r in full.values()]),
        dict(name="composite_bwd", launches=launches["train_step"][
            "composite_bwd"], max_abs_err=bwd_err,
             max_rel_err=max(max(r["bwd_max_rel_diff"].values())
                             for r in bwd_rows),
             ms=kb["bwd_ms"], plain_ms=kb["bwd_plain_ms"],
             bound_ms=kb["bwd_bound_ms"], bound_by=kb["bwd_bound_by"],
             library_ms=None, t_first_max_err=max(
                 r["t_first_max_err"] for r in bwd_rows)),
        dict(name="reduce_pair_grads", launches=launches["train_step"][
            "reduce_pair_grads"], max_abs_err=red_err, ms=kb["reduce_ms"],
             plain_ms=kb["reduce_plain_ms"], bound_ms=kb["reduce_bound_ms"],
             bound_by=kb["reduce_bound_by"],
             library_ms=kb["reduce_library_ms"]),
    ]
    for e in entries:
        e["route"] = "cuda"
        e["source"], e["replaces"] = KERNELS[e["name"]]
    emit({"kernels": entries, "launches_by_path": launches,
          "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


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
    launches = counts()
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    assert launches == dict.fromkeys(launches, n_steps), launches
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
            "losses": losses, "launches": launches, "stage_ms": split,
            "peak_memory_gib": peak,
            "n_alive": int(state.aux.alive.sum())}


def train_cli_phase(src, root, dev, n_train, n_test) -> dict:
    """trase_tpu_torch.train on the CLI dataset with densification and an
    opacity reset inside the run, then the render CLI on its snapshot."""
    from trase_tpu_torch import render as cli
    from trase_tpu_torch import train as train_cli
    from trase_tpu_torch.engine import trainer as TT

    mdl = os.path.join(root, "trained")
    it = CLI_ITERATIONS
    events = {"densify": [], "reset": []}
    densify, reset = TT.densify_step, TT.reset_opacity_step

    def count_densify(*a, **kw):
        out = densify(*a, **kw)
        events["densify"].append({k: int(v) for k, v in out[1].items()})
        return out

    def count_reset(*a, **kw):
        events["reset"].append(1)
        return reset(*a, **kw)

    TT.densify_step, TT.reset_opacity_step = count_densify, count_reset
    reset_counts()
    t0 = time.perf_counter()
    try:
        trainer = train_cli.main([
            "-s", src, "-m", mdl, "--iterations", str(it), "--eval",
            "--warm_up", "100", "--densify_from_iter", "50",
            "--densification_interval", "100", "--opacity_reset_interval",
            "250", "--pairs_per_gaussian", "6", "--device", dev.type,
            "--quiet"])
    finally:
        TT.densify_step, TT.reset_opacity_step = densify, reset
    seconds = time.perf_counter() - t0
    launches = counts()
    assert launches == dict.fromkeys(launches, it), launches
    assert trainer.step_calls == it and int(trainer.skipped) == 0
    assert len(events["densify"]) >= 1 and len(events["reset"]) >= 1, events
    cli.main(["-s", src, "-m", mdl, "--iteration", str(it),
              "--pairs_per_gaussian", "6", "--device", dev.type])
    pngs = check_pngs(mdl, it, n_train, n_test)
    return {"iterations": it, "seconds": seconds,
            "it_per_s": it / seconds, "launches": launches,
            "densify": events["densify"], "opacity_resets":
            len(events["reset"]), "n_alive": trainer._n_alive_cache,
            "capacity": int(trainer.state.params.xyz.shape[0]),
            "png_counts": pngs}


if __name__ == "__main__":
    sys.exit(main())
