"""Technicolor light-field -> Blender-style multiview dataset.

Behavioral contract: technocolor2blender.py in the reference —
pre-undistorted `<Scene>_undist_<frame>_<cam>.png` stills copied to
images/camera_00XX_FFFF.png, per-camera intrinsics + COLMAP-convention
(qvec, tvec) extrinsics parsed from cameras_parameters.txt, per-frame
w2c transform + intrinsics stored in the frames (reader convention:
transform_matrix IS w2c for this dataset), camera 0 = test split,
time = (frame - start)/30; images recentered so the principal point
sits at the image center; init cloud via known-pose COLMAP
triangulation of the first frame.

The port's CLI (counterpart of the repository root's
technocolor2blender.py, the same flags and outputs), host numpy and cv2
only:

    python -m trase_tpu_torch.technocolor2blender --path <Scene>
        [--start F --end F] [--scale 2] [--random_points]
        [--extract_image_only]
"""
from __future__ import annotations

import argparse
import csv
import glob
import os
import shutil

import numpy as np

# frame ranges used by the reference per scene (SCENE_FRAMES)
SCENE_FRAMES = {
    "Birthday": (151, 451),
    "Fabien": (51, 351),
    "Painter": (100, 400),
    "Theater": (51, 351),
    "Train": (151, 451),
}
H_FULL, W_FULL = 1088, 2048


def main(argv=None):
    from .data.colmap import qvec2rotmat
    from .tools import convert as C

    ap = argparse.ArgumentParser()
    ap.add_argument("--path", default="")
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--extract_image_only", action="store_true")
    ap.add_argument("--start", type=int, default=None)
    ap.add_argument("--end", type=int, default=None)
    ap.add_argument("--random_points", action="store_true")
    args = ap.parse_args(argv)
    path = args.path.rstrip("/") + "/"
    scene = os.path.basename(path.rstrip("/"))

    if args.start is None or args.end is None:
        if scene not in SCENE_FRAMES:
            raise SystemExit(
                f"unknown scene {scene!r}; pass --start/--end "
                f"(known: {sorted(SCENE_FRAMES)})")
        start, end = SCENE_FRAMES[scene]
    else:
        start, end = args.start, args.end

    import cv2

    rel_dir = "images" if args.scale == 1 else f"images_{args.scale}x"
    img_dir = os.path.join(path, rel_dir)
    os.makedirs(img_dir, exist_ok=True)
    for i in range(start, end):
        for src in glob.glob(os.path.join(
                path, f"*_undist_{i:05d}_*.png")):
            cam2 = src.split(".")[-2][-2:]
            dst = os.path.join(img_dir, f"camera_00{cam2}_{i:04d}.png")
            frame = cv2.imread(src)
            if args.scale > 1:
                frame = cv2.resize(
                    frame, (frame.shape[1] // args.scale,
                            frame.shape[0] // args.scale),
                    interpolation=cv2.INTER_AREA)
            cv2.imwrite(dst, frame)

    images = sorted(
        f for f in os.listdir(img_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg")))
    cams = sorted({im[:11] for im in images})
    print(f"[technicolor] {len(images)} images from {len(cams)} cameras")

    W = W_FULL // args.scale
    H = H_FULL // args.scale
    poses, cam_infos = [], {}
    with open(os.path.join(path, "cameras_parameters.txt")) as f:
        for idx, row in enumerate(csv.reader(f, delimiter=" ")):
            if idx == 0:
                continue
            row = [float(c) for c in row if c.strip() != ""]
            name = f"camera_{idx - 1:04d}"
            w2c = np.eye(4)
            w2c[:3, :3] = qvec2rotmat(np.array(row[5:9]))
            w2c[:3, 3] = np.array(row[9:12])
            poses.append(w2c)
            cam_infos[name] = {
                "w": W, "h": H,
                "fl_x": row[0] / args.scale, "fl_y": row[0] / args.scale,
                "cx": row[1] / args.scale, "cy": row[2] / args.scale,
            }

    train_frames, test_frames = [], []
    for i, cam in enumerate(cams):
        info = cam_infos[cam]
        frames = [{
            "file_path": f"{rel_dir}/{im.split('.')[0]}",
            "transform_matrix": poses[i].tolist(),
            **info,
            "time": (int(im.split(".")[0][-4:]) - start) / 30.0,
        } for im in images if im.startswith(cam)]
        (test_frames if i == 0 else train_frames).extend(frames)

    # recenter the principal point to the image center by translating
    # pixels (reference technocolor2blender.py:433-470)
    for frames in (train_frames, test_frames):
        for frame in frames:
            cx, cy = frame["cx"], frame["cy"]
            ncx, ncy = frame["w"] / 2.0, frame["h"] / 2.0
            if (cx, cy) == (ncx, ncy):
                continue
            p = os.path.join(path, frame["file_path"] + ".png")
            img = cv2.imread(p)
            M = np.array([[1, 0, ncx - cx], [0, 1, ncy - cy]], np.float32)
            cv2.imwrite(p, cv2.warpAffine(img, M,
                                          (frame["w"], frame["h"])))
            frame["cx"], frame["cy"] = ncx, ncy

    if args.extract_image_only:
        return
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
