#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (trase_tpu_torch) on one card.

    python3 chip_smoke.py            # from the repository root

Drives the port's serving path on the card and prints one JSON line per
phase:

1. device   the card's name and power limit (nvidia-smi) and torch's view;
2. build    nvcc builds csrc/composite_fwd.cu for sm_90a; build seconds;
3. compare  the CUDA compositor against its plain PyTorch version
            (composite_plain) on the same inputs, for 4 values (rgb+depth),
            36 (+32 features) and 36 with bf16-packed features, at a small
            random scene and at the full scene of phase 4; plus the small
            scene's render against the all-pairs oracle;
4. render   the bench scene of bench.py (100k gaussians in a 131072
            capacity, SH degree 3, 32-dim features, DeformNetwork 8x256,
            1008x1344, K=6, seeded): deform_step -> renderer.render with
            and without features, warm-up then timed frames; checks the
            outputs and that the compositor kernel ran once per render;
5. cli      writes a small Blender-format dataset and a model directory
            with the port's own writers and runs trase_tpu_torch.render;
6. profile  torch.profiler over a few frames of phase 4: device busy time
            by kernel and the device's idle share;
7. kernels  one object per kernel: launches, error against the plain
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
WARMUP, FRAMES = 3, 10
# the bench scene of bench.py:110-130
N_GAUSSIANS, CAPACITY, HEIGHT, WIDTH = 100_000, 131072, 1008, 1344
REPLACES = "trase_tpu/ops/rasterize_pallas.py:590"
SOURCE = "trase_tpu_torch/csrc/composite_fwd.cu"


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


def flax_variables(net):
    """The port's deform weights in trase_tpu's flax layout (numpy)."""
    return {"params": {
        f"Dense_{i}": {"kernel": lin.weight.detach().T.cpu().numpy(),
                       "bias": lin.bias.detach().cpu().numpy()}
        for i, lin in enumerate(net.flax_order())}}


def write_cli_inputs(root, params, aux, net, device, n_train=3, n_test=2,
                     size=64):
    """A Blender-format dataset (transforms_*.json, images, points3d.ply)
    and a model directory, written with the port's own writers."""
    from PIL import Image

    from trase_tpu_torch.config import save_cfg
    from trase_tpu_torch.data.ply import write_point_cloud
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
    lib, seconds, log = RC.build_library()
    emit({"phase": "build", "library": os.path.relpath(lib), "seconds": seconds,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    # 3. kernel vs plain (and the small scene vs the oracle)
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

    # 4. the main path: deform_step -> renderer.render, counted
    from trase_tpu_torch.models.deform import deform_step

    bg = torch.zeros(3, device=dev)

    def frame(fid, with_features):
        t = torch.full((cap, 1), fid, device=dev)
        d = deform_step(net, params.xyz, t)
        return render(cam, params, aux.alive, bg, *d, sh_degree=3,
                      with_features=with_features, raster_cfg=cfg)

    RC.FWD_LAUNCHES = 0
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
    launches = RC.FWD_LAUNCHES
    assert launches == calls, (launches, calls)
    with torch.no_grad():
        stages = stage_ms(params, aux, cam, net, cfg, False, False)
        stages_feats = stage_ms(params, aux, cam, net, cfg, True, True)
    k4, k36 = full[(4, 0)], full[(36, 16)]
    emit({"phase": "render", "gaussians": n, "capacity": cap,
          "height": H, "width": W, "pairs_per_gaussian": 6,
          "render_calls": calls, "fwd_launches": launches,
          "frame_ms": frame_ms[False], "frame_ms_with_features":
          frame_ms[True], "compositor_ms": k4["ms"],
          "compositor_ms_with_features": k36["ms"],
          "plain_ms": k4["plain_ms"], "plain_ms_with_features":
          k36["plain_ms"], "bound_ms": k4["bound_ms"],
          "bound_ms_with_features": k36["bound_ms"],
          "stage_ms": stages, "stage_ms_with_features": stages_feats,
          "overflow": float(out["overflow"]),
          "alpha_mean": float(out["alpha"].mean())})

    # 5. the render CLI on the card
    from trase_tpu_torch import render as cli

    with tempfile.TemporaryDirectory() as tmp:
        small = 2000
        keep = torch.zeros(cap, dtype=torch.bool, device=dev)
        keep[:small] = True
        cli_aux = aux._replace(alive=aux.alive & keep)
        src, mdl, it, n_train, n_test = write_cli_inputs(tmp, params,
                                                         cli_aux, net, dev)
        RC.FWD_LAUNCHES = 0
        cli.main(["-s", src, "-m", mdl, "--iteration", str(it),
                  "--pairs_per_gaussian", "6", "--device", dev.type])
        counts = {}
        for split_name, nv in (("train", n_train), ("test", n_test)):
            base = os.path.join(mdl, split_name, f"ours_{it}")
            for s in ("renders", "gt", "rendered_feats", "canonical"):
                got = len([f for f in os.listdir(os.path.join(base, s))
                           if f.endswith(".png")])
                want = 1 if s == "canonical" else nv
                assert got == want, (split_name, s, got, want)
                counts[f"{split_name}/{s}"] = got
        cli_launches = RC.FWD_LAUNCHES
        assert cli_launches == 2 * (n_train + n_test) + 2, cli_launches
    emit({"phase": "cli", "png_counts": counts, "fwd_launches": cli_launches,
          "launches_per_view": cli_launches / (n_train + n_test)})

    # 6. where a frame's device time goes
    with torch.no_grad():
        for with_features in (False, True):
            emit({"phase": "profile", "with_features": with_features,
                  **profile_frames(lambda: frame(0.5, with_features))})

    # 7. kernels
    max_err = max(max(r["max_abs_diff"].values()) for r in rows)
    emit({"kernels": [{
        "name": "composite_fwd", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max_err, "max_abs_diff": max_err,
        "ms": k4["ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
        "library_ms": None,
        "variants": [{k: r[k] for k in ("n_val", "n_packed", "ms",
                                        "plain_ms", "bound_ms", "bound_by",
                                        "pairs", "evaluated",
                                        "contributing")}
                     for r in full.values()]}],
          "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
