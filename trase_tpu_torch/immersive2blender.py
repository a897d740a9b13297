"""Google Immersive Light Field -> Blender-style multiview dataset.

Behavioral contract: immersive2blender.py in the reference — per-camera
mp4s -> per-camera frame dirs, models.json fisheye calibration ->
cv2.fisheye undistortion into images/camera_XXXX_FFFF.png +
models_new.json with the rectified intrinsics; poses from the
axis-angle `orientation` + `position` (w2c = [R | -R t], stored as-is
in transform_matrix — the reader treats it as w2c for this dataset);
camera 0 = test split, time = frame/30; known scenes 04_Truck / 03_Dog /
06_Goats are truncated to 150 frames.

The port's CLI (counterpart of the repository root's
immersive2blender.py, the same flags and outputs), host numpy, cv2 and
scipy's Rotation only:

    python -m trase_tpu_torch.immersive2blender --path <scene>
        [--start 0 --end 300] [--scale 2] [--random_points]
        [--extract_image_only]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil

import numpy as np


def undistort_all(path: str, frames, scale: int):
    import cv2

    from .tools.convert import compute_undistort_intrinsic

    with open(os.path.join(path, "models.json")) as f:
        meta = json.load(f)
    out_name = "images" if scale == 1 else f"images_{scale}x"
    out_dir = os.path.join(path, out_name)
    os.makedirs(out_dir, exist_ok=True)
    for cam in meta:
        folder = cam["name"] if scale == 1 else f"{cam['name']}_{scale}x"
        w = int(cam["width"] // scale)
        h = int(cam["height"] // scale)
        K = np.array([
            [cam["focal_length"] / scale, 0.0,
             cam["principal_point"][0] / scale],
            [0.0, cam["focal_length"] / scale,
             cam["principal_point"][1] / scale],
            [0.0, 0.0, 1.0]])
        dist = np.zeros(4)
        dist[:2] = np.array(cam["radial_distortion"])[:2]
        new_K = compute_undistort_intrinsic(K, h, w, dist)
        map1, map2 = cv2.fisheye.initUndistortRectifyMap(
            K, dist, np.eye(3), new_K, (w, h), cv2.CV_32FC1)
        cam["focal_length"] = float(new_K[0, 0])
        cam["principal_point"] = [float(new_K[0, 2]), float(new_K[1, 2])]
        cam["height"], cam["width"] = h, w
        for fr in frames:
            src = os.path.join(path, folder, f"{fr}.png")
            dst = os.path.join(out_dir, f"{cam['name']}_{fr:04d}.png")
            if os.path.exists(dst) or not os.path.exists(src):
                continue
            img = cv2.imread(src).astype(np.float32)
            und = cv2.remap(img, map1, map2,
                            interpolation=cv2.INTER_LINEAR,
                            borderMode=cv2.BORDER_REFLECT_101)
            cv2.imwrite(dst, und.clip(0, 255).astype(np.uint8))
    with open(os.path.join(path, "models_new.json"), "w") as f:
        json.dump(meta, f, indent=4)


def main(argv=None):
    from scipy.spatial.transform import Rotation

    from .tools import convert as C

    ap = argparse.ArgumentParser()
    ap.add_argument("--path", default="")
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=300)
    ap.add_argument("--extract_image_only", action="store_true")
    ap.add_argument("--random_points", action="store_true")
    args = ap.parse_args(argv)
    path = args.path.rstrip("/") + "/"
    scene = os.path.basename(path.rstrip("/"))
    if scene in ("04_Truck", "03_Dog", "06_Goats"):
        args.end = min(args.end, 150)

    # mp4 -> per-camera frame dirs named after the camera
    for v in sorted(glob.glob(os.path.join(path, "*.mp4"))):
        cam = os.path.basename(v).split(".")[0]
        folder = os.path.join(
            path, cam if args.scale == 1 else f"{cam}_{args.scale}x")
        if not os.path.isdir(folder):
            os.makedirs(folder, exist_ok=True)
            import cv2

            cap = cv2.VideoCapture(v)
            i = 0
            while i < args.end:
                ok, frame = cap.read()
                if not ok:
                    break
                if i >= args.start:
                    if args.scale > 1:
                        frame = cv2.resize(
                            frame, (frame.shape[1] // args.scale,
                                    frame.shape[0] // args.scale),
                            interpolation=cv2.INTER_AREA)
                    cv2.imwrite(os.path.join(folder, f"{i}.png"), frame)
                i += 1
            cap.release()

    undistort_all(path, range(args.start, args.end), args.scale)
    if args.extract_image_only:
        return

    with open(os.path.join(path, "models_new.json")) as f:
        meta = json.load(f)
    rel_dir = "images" if args.scale == 1 else f"images_{args.scale}x"
    img_dir = os.path.join(path, rel_dir)
    images = sorted(
        f for f in os.listdir(img_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg")))
    cams = sorted({im[:11] for im in images})
    assert len(meta) == len(cams), (len(meta), len(cams))

    poses, infos = [], {}
    for cam in meta:
        R = Rotation.from_rotvec(cam["orientation"]).as_matrix()
        t = np.asarray(cam["position"])[:, None]
        w2c = np.concatenate([R, -R @ t], axis=1)
        poses.append(np.concatenate(
            [w2c, np.array([[0, 0, 0, 1.0]])], axis=0))
        infos[cam["name"]] = {
            "w": cam["width"], "h": cam["height"],
            "fl_x": cam["focal_length"], "fl_y": cam["focal_length"],
            "cx": cam["principal_point"][0],
            "cy": cam["principal_point"][1],
        }

    train_frames, test_frames = [], []
    for i, cam in enumerate(cams):
        frames = [{
            "file_path": f"{rel_dir}/{im.split('.')[0]}",
            "transform_matrix": poses[i].tolist(),
            **infos[cam],
            "time": int(im.split(".")[0][-4:]) / 30.0,
        } for im in images if im.startswith(cam)]
        (test_frames if i == 0 else train_frames).extend(frames)
    C.write_transforms(path, train_frames, test_frames)

    out_ply = os.path.join(path, "points3d.ply")
    if args.random_points:
        C.write_random_points(out_ply)
        return
    cam_lines, image_lines = [], []
    t0_dir = os.path.join(path, "tmp_t0_images")
    os.makedirs(t0_dir, exist_ok=True)
    idx = 1
    for frame in train_frames:
        if frame["time"] != 0:
            continue
        fname = frame["file_path"].split("/")[-1] + ".png"
        w2c = np.array(frame["transform_matrix"])
        q = C.rotmat2qvec_colmap(w2c[:3, :3])
        T = w2c[:3, 3]
        cam_lines.append(
            f"{idx} PINHOLE {frame['w']} {frame['h']} {frame['fl_x']} "
            f"{frame['fl_y']} {frame['cx']} {frame['cy']}")
        image_lines.append(
            f"{idx} {q[0]} {q[1]} {q[2]} {q[3]} {T[0]} {T[1]} {T[2]} "
            f"{idx} {fname}")
        dst = os.path.join(t0_dir, fname)
        if not os.path.exists(dst):
            os.symlink(os.path.abspath(os.path.join(img_dir, fname)), dst)
        idx += 1
    ok = C.triangulate_known_poses(path, t0_dir, cam_lines, image_lines,
                                   out_ply)
    shutil.rmtree(t0_dir, ignore_errors=True)
    if not ok and not os.path.exists(out_ply):
        C.write_random_points(out_ply)


if __name__ == "__main__":
    main()
