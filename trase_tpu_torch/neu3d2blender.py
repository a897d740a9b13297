"""Neu3D (DyNeRF / Plenoptic Video) -> Blender-style multiview dataset.

Behavioral contract: neu3d2blender.py in the reference — per-camera
mp4s -> images/<cam>_%04d.png, LLFF poses_bounds.npy -> NeRF-convention
poses recentered/rescaled (colmap2nerf), camera 00 = test split,
time = frame/30, shared intrinsics in the transforms header; initial
point cloud via known-pose COLMAP triangulation (the reference runs the
full dense MVS; --dense enables that, the default keeps the sparse
triangulated cloud — the standard 3DGS init).

The port's CLI (counterpart of the repository root's neu3d2blender.py,
the same flags and outputs), host numpy and cv2 only:

    python -m trase_tpu_torch.neu3d2blender --path <scene> [--scale 2]
        [--random_points | --dense] [--extract_image_only]
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil

import numpy as np


def main(argv=None):
    from .tools import convert as C

    ap = argparse.ArgumentParser()
    ap.add_argument("--path", default="", help="scene dir with cam*.mp4")
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--extract_image_only", action="store_true")
    ap.add_argument("--dense", action="store_true",
                    help="full COLMAP MVS for the init cloud (reference "
                         "behavior; slow)")
    ap.add_argument("--random_points", action="store_true",
                    help="skip COLMAP; write a random init cloud")
    args = ap.parse_args(argv)
    path = args.path.rstrip("/") + "/"

    img_dir = os.path.join(
        path, "images" if args.scale == 1 else f"images_{args.scale}x")
    videos = sorted(glob.glob(os.path.join(path, "*.mp4")))
    for v in videos:
        cam = os.path.basename(v).split(".")[0]
        n = C.extract_video_frames(v, img_dir, cam, downscale=args.scale)
        print(f"[neu3d] {cam}: {n} frames")

    if args.extract_image_only:
        return

    rel_dir = os.path.basename(img_dir)
    images = sorted(
        f for f in os.listdir(img_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg")))
    cams = sorted({im.split("_")[0] for im in images})

    poses_bounds = np.load(os.path.join(path, "poses_bounds.npy"))
    assert poses_bounds.shape[0] == len(cams), (
        poses_bounds.shape, len(cams))
    poses, (H, W, fl) = C.llff_to_nerf_poses(poses_bounds, args.scale)
    poses = C.recenter_rescale(poses)
    print(f"[neu3d] H={H} W={W} fl={fl:.2f}; cams={cams}")

    train_frames, test_frames = [], []
    for i, cam in enumerate(cams):
        frames = [{
            "file_path": f"{rel_dir}/{im.split('.')[0]}",
            "transform_matrix": poses[i].tolist(),
            "time": int(im.split(".")[0][-4:]) / 30.0,
        } for im in images if im.startswith(cam + "_")]
        (test_frames if i == 0 else train_frames).extend(frames)

    shared = {"w": W, "h": H, "fl_x": fl, "fl_y": fl,
              "cx": W // 2, "cy": H // 2}
    C.write_transforms(path, train_frames, test_frames, shared)

    out_ply = os.path.join(path, "points3d.ply")
    if args.random_points:
        C.write_random_points(out_ply)
        return

    # known-pose triangulation on the t=0 train frames
    cam_lines = [f"1 PINHOLE {W} {H} {fl} {fl} {W // 2} {H // 2}"]
    image_lines = []
    t0_dir = os.path.join(path, "tmp_t0_images")
    os.makedirs(t0_dir, exist_ok=True)
    idx = 1
    for frame in train_frames:
        if frame["time"] != 0:
            continue
        fname = frame["file_path"].split("/")[-1] + ".png"
        pose = np.array(frame["transform_matrix"]) @ C.BLENDER2OPENCV
        R = np.linalg.inv(pose[:3, :3])
        T = -R @ pose[:3, 3]
        q = C.rotmat2qvec_colmap(R)
        image_lines.append(
            f"{idx} {q[0]} {q[1]} {q[2]} {q[3]} {T[0]} {T[1]} {T[2]} 1 "
            f"{fname}")
        src = os.path.abspath(os.path.join(img_dir, fname))
        dst = os.path.join(t0_dir, fname)
        if not os.path.exists(dst):
            os.symlink(src, dst)
        idx += 1
    ok = C.triangulate_known_poses(path, t0_dir, cam_lines, image_lines,
                                   out_ply, dense=args.dense)
    shutil.rmtree(t0_dir, ignore_errors=True)
    if not ok and not os.path.exists(out_ply):
        C.write_random_points(out_ply)


if __name__ == "__main__":
    main()
