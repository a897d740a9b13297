"""Synthetic scene generator (test / bench fixture).

Counterpart of trase_tpu/data/synthetic.py: a small multi-view
"Blender"-format dataset on disk (transforms_train.json /
transforms_test.json with a per-frame `time`, points3d.ply, images/,
images/masks/) from a procedural dynamic gaussian scene, blobs of
coloured points orbiting the origin. The ground-truth images and the
per-blob coverage masks (stand-ins for SAM masks) come from the port's
compositors: the all-pairs oracle (``ops/rasterize_ref.py``) by default,
the tiled compositor (``ops/rasterize_cuda.py``, the CUDA kernel on the
card) with ``fast=True``. The numpy draws are trase_tpu's, so both
packages write the same scene and the same points3d.ply.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import resolve_device

# the features-only compositor composites 32 values: the blob one-hot is
# padded to that width, so a fast GT render takes at most 32 blobs
FAST_MAX_BLOBS = 32
# the fast GT's least pair budget (RasterConfig's default); it grows to a
# power of two that covers every gaussian's tiles
MIN_PAIRS = 8


def _look_at(eye: np.ndarray, target: np.ndarray, up=np.array([0., 1., 0.])):
    """OpenCV-style W2C rotation/translation for a camera at `eye`."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_w2c = np.stack([right, down, fwd], axis=0)  # rows
    t = -R_w2c @ eye
    return R_w2c, t


def make_blob_scene(n_blobs: int = 4, pts_per_blob: int = 64, seed: int = 0):
    """Ground-truth gaussian cloud: n_blobs clusters with distinct colours.

    Returns a dict of numpy arrays (xyz, rgb, blob_id, centers) and the
    shared scale and opacity, in canonical (t=0) space."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.8, 0.8, size=(n_blobs, 3)).astype(np.float32)
    palette = np.array([
        [0.9, 0.2, 0.2], [0.2, 0.8, 0.3], [0.25, 0.35, 0.95],
        [0.9, 0.8, 0.2], [0.8, 0.3, 0.8], [0.2, 0.8, 0.8],
    ], np.float32)
    xyz, rgb, blob_id = [], [], []
    for b in range(n_blobs):
        p = centers[b] + rng.normal(0, 0.08, size=(pts_per_blob, 3))
        xyz.append(p.astype(np.float32))
        c = palette[b % len(palette)] * rng.uniform(
            0.8, 1.0, size=(pts_per_blob, 1))
        rgb.append(c.astype(np.float32))
        blob_id.append(np.full(pts_per_blob, b, np.int32))
    return {
        "xyz": np.concatenate(xyz),
        "rgb": np.concatenate(rgb),
        "blob_id": np.concatenate(blob_id),
        "centers": centers,
        "scale": np.float32(0.05),
        "opacity": np.float32(0.8),
    }


def deform_blobs(scene: dict, t: float) -> np.ndarray:
    """Time-dependent positions: each blob translates on a small orbit."""
    xyz = scene["xyz"].copy()
    for b, c in enumerate(scene["centers"]):
        phase = 2 * np.pi * (t + b / max(len(scene["centers"]), 1))
        offset = 0.15 * np.array(
            [np.cos(phase), np.sin(phase), 0.0], np.float32)
        xyz[scene["blob_id"] == b] += offset
    return xyz


def render_gt(scene: dict, t: float, R, T, fovx, fovy, h, w,
              bg=(0.0, 0.0, 0.0), fast: bool = False, device="cuda"):
    """(image (3, h, w) float32, masks (n_blobs, h, w) bool) of the blob
    cloud at time t, as numpy; a mask is a blob's coverage above 0.3.

    fast=False: the all-pairs oracle (O(N * pixels) memory; the small
    fixtures). fast=True: projection, then the tiled compositor's
    ``composite_inputs`` and ``composite`` (rasterize_tiled): one launch
    for the image and one for the coverage, the one-hot padded to the
    32-feature, features-only layout and sliced back. Its pair budget K
    covers the largest gaussian's tile rectangle, so no tile is dropped
    and the image is the oracle's (trase_tpu's fast GT keeps K = 8 and
    drops tiles from 256x256 on: ROADMAP.md, Queue 3)."""
    from ..ops import project_cuda
    from ..ops.rasterize import RasterConfig, _tile_grid, _tile_rects
    from ..ops.rasterize_cuda import rasterize_tiled
    from ..ops.rasterize_ref import rasterize_reference
    from ..renderer import make_render_camera

    dev = resolve_device(device)
    n_blobs = scene["centers"].shape[0]
    if fast and n_blobs > FAST_MAX_BLOBS:
        raise ValueError(f"fast GT renders at most {FAST_MAX_BLOBS} blobs "
                         f"(the features-only compositor's width), not "
                         f"{n_blobs}")
    cam = make_render_camera(R.T, T, fovx, fovy, h, w, device=dev)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    xyz = f32(deform_blobs(scene, t))
    n = xyz.shape[0]
    onehot = np.eye(n_blobs, dtype=np.float32)[scene["blob_id"]]
    scales = torch.full((n, 3), float(scene["scale"]), device=dev)
    rots = torch.zeros((n, 4), device=dev)
    rots[:, 0] = 1.0
    opac = torch.full((n,), float(scene["opacity"]), device=dev)
    bg = f32(bg)
    with torch.no_grad():
        proj = project_cuda.project(xyz, scales, rots, opac, cam.buffers, h,
                                    w, colors_precomp=f32(scene["rgb"]))
        if fast:
            count = _tile_rects(proj, *_tile_grid(h, w))[3]
            k = 1 << max(int(count.max()) - 1, 0).bit_length()
            cfg = RasterConfig(pairs_per_gaussian=max(k, MIN_PAIRS))
            image = rasterize_tiled(proj, None, bg, h, w, cfg)["render"]
            padded = np.zeros((n, FAST_MAX_BLOBS), np.float32)
            padded[:, :n_blobs] = onehot
            cov = rasterize_tiled(proj, f32(padded), bg, h, w, cfg,
                                  with_color=False)["feats"][:n_blobs]
        else:
            out = rasterize_reference(proj, f32(onehot), bg, h, w)
            image, cov = out["render"], out["feats"]
    masks = cov.cpu().numpy() > 0.3
    return image.cpu().numpy(), masks


def write_synthetic_dataset(
    path: str,
    n_train: int = 10,
    n_test: int = 2,
    image_size: int = 64,
    n_blobs: int = 3,
    pts_per_blob: int = 48,
    radius: float = 3.0,
    seed: int = 0,
    fast_gt: bool = False,
    n_times: int = 0,
    device="cuda",
):
    """Write a complete Blender-format dataset dir; returns the scene.

    fast_gt: render the GT with the tiled compositor (on the card, the
    CUDA kernel) instead of the all-pairs oracle, for 1K-class images.

    n_times: 0 = monocular ring (time == angle, one view per timestep);
    > 0 = Neu3D-style multi-view rig (n//n_times fixed cameras x n_times
    timestamps per split, test cameras at held-out angles, so novel-view
    PSNR measures reconstruction)."""
    from PIL import Image

    from .masks import save_mask_file
    from .ply import write_point_cloud

    scene = make_blob_scene(n_blobs, pts_per_blob, seed)
    h = w = image_size
    fov = 0.8
    os.makedirs(os.path.join(path, "images"), exist_ok=True)
    # the Blender reader resolves masks at <path>/<subdir>/masks/<name>
    os.makedirs(os.path.join(path, "images", "masks"), exist_ok=True)

    def write_split(split: str, n: int, offset: float):
        if n_times > 0:
            n_cams = max(n // n_times, 1)
            views = [(ci / n_cams + offset, ti / max(n_times - 1, 1))
                     for ci in range(n_cams) for ti in range(n_times)]
        else:
            views = [(i / n + offset, i / max(n - 1, 1)) for i in range(n)]
        frames = []
        for i, (frac, t) in enumerate(views):
            theta = 2 * np.pi * frac
            eye = radius * np.array(
                [np.sin(theta), 0.3, np.cos(theta)], np.float64)
            R_w2c, T = _look_at(eye, np.zeros(3))
            img, masks = render_gt(scene, t, R_w2c, T, fov, fov, h, w,
                                   fast=fast_gt, device=device)
            # the basename ends in 4 digits (the reader parses a frame
            # index from its last 4 characters for end_frame)
            name = f"{split}_{i:04d}"
            arr = (np.clip(img.transpose(1, 2, 0), 0, 1) * 255).astype(
                np.uint8)
            Image.fromarray(arr).save(
                os.path.join(path, "images", f"{name}.png"))
            save_mask_file(
                os.path.join(path, "images", "masks", f"{name}.npz"), masks)
            c2w = np.eye(4)
            c2w[:3, :3] = R_w2c.T
            c2w[:3, 3] = -R_w2c.T @ T
            c2w[:3, 1:3] *= -1  # Blender axes (the readers flip back)
            frames.append({
                "file_path": f"images/{name}",
                "time": t,
                "transform_matrix": c2w.tolist(),
            })
        with open(os.path.join(path, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": fov, "frames": frames}, f, indent=1)

    write_split("train", n_train, 0.0)
    write_split("test", n_test, 0.031)

    # init point cloud: GT positions + noise (so training has work to do)
    rng = np.random.default_rng(seed + 1)
    pts = scene["xyz"] + rng.normal(0, 0.05, scene["xyz"].shape)
    cols = np.clip(
        scene["rgb"] + rng.normal(0, 0.1, scene["rgb"].shape), 0, 1)
    write_point_cloud(os.path.join(path, "points3d.ply"),
                      pts.astype(np.float32), cols * 255.0)
    return scene
