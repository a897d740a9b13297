"""Shared dataset-conversion core for the Neu3D / Technicolor /
Google-Immersive converters (the port's copy of trase_tpu/tools/convert.py).

Behavioral contract: the pose math, recentring, split conventions and
COLMAP workflow of the reference's neu3d2blender.py /
technocolor2blender.py / immersive2blender.py (one core + thin
per-dataset CLIs: trase_tpu_torch/neu3d2blender.py,
technocolor2blender.py, immersive2blender.py). All functions are
host-side float64 numpy with trase_tpu's operations in trase_tpu's
order, so both packages write the same files; cv2 (frames, fisheye
undistortion) is imported where it is used, and COLMAP is an optional
external binary, skipped with a message when absent.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import sqlite3

import numpy as np

BLENDER2OPENCV = np.array([[1, 0, 0, 0], [0, -1, 0, 0],
                           [0, 0, -1, 0], [0, 0, 0, 1]], np.float64)


def do_system(cmd: str) -> None:
    print(f"== {cmd}")
    err = os.system(cmd)
    if err:
        raise RuntimeError(f"command failed ({err}): {cmd}")


def have_binary(name: str) -> bool:
    return shutil.which(name) is not None


# ------------------------------------------------------------ pose math

def rotmat(a, b):
    """Rotation taking unit vector a to unit vector b (neu3d2blender
    rotmat, itself from instant-ngp's colmap2nerf)."""
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = np.dot(a, b)
    s = np.linalg.norm(v)
    kmat = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + kmat + kmat.dot(kmat) * ((1 - c) / (s ** 2 + 1e-10))


def closest_point_2_lines(oa, da, ob, db):
    """Point closest to both rays + weight (colmap2nerf)."""
    da = da / np.linalg.norm(da)
    db = db / np.linalg.norm(db)
    c = np.cross(da, db)
    denom = np.linalg.norm(c) ** 2
    t = ob - oa
    ta = np.linalg.det([t, db, c]) / (denom + 1e-10)
    tb = np.linalg.det([t, da, c]) / (denom + 1e-10)
    if ta > 0:
        ta = 0
    if tb > 0:
        tb = 0
    return (oa + ta * da + ob + tb * db) * 0.5, denom


def llff_to_nerf_poses(poses_bounds: np.ndarray, scale: int = 1):
    """LLFF poses_bounds.npy -> (N,4,4) NeRF-convention c2w poses +
    (H, W, focal) (neu3d2blender.py main; LLFF column reorder then the
    colmap2nerf axis swaps)."""
    poses = poses_bounds[:, :15].reshape(-1, 3, 5)
    H, W, fl = poses[0, :, -1]
    H, W, fl = round(H / scale), round(W / scale), fl / scale

    poses = np.concatenate(
        [poses[..., 1:2], poses[..., 0:1], -poses[..., 2:3], poses[..., 3:4]],
        -1)
    last = np.tile(np.array([0, 0, 0, 1]), (len(poses), 1, 1))
    poses = np.concatenate([poses, last], axis=1)  # (N,4,4)
    poses[:, 0:3, 1] *= -1
    poses[:, 0:3, 2] *= -1
    poses = poses[:, [1, 0, 2, 3], :]  # swap y and z
    poses[:, 2, :] *= -1  # flip whole world upside down
    return poses, (int(H), int(W), float(fl))


def recenter_rescale(poses: np.ndarray, target_radius: float = 4.0):
    """Rotate up to +z, recenter at the point of closest ray
    convergence, rescale to the target average radius (colmap2nerf via
    neu3d2blender.py)."""
    n = len(poses)
    up = poses[:, 0:3, 1].sum(0)
    up = up / np.linalg.norm(up)
    R = rotmat(up, [0, 0, 1])
    R = np.pad(R, [0, 1])
    R[-1, -1] = 1
    poses = R @ poses

    totw, totp = 0.0, np.zeros(3)
    for i in range(n):
        mf = poses[i, :3, :]
        for j in range(i + 1, n):
            mg = poses[j, :3, :]
            p, w = closest_point_2_lines(mf[:, 3], mf[:, 2],
                                         mg[:, 3], mg[:, 2])
            if w > 0.01:
                totp += p * w
                totw += w
    if totw > 0:
        poses[:, :3, 3] -= totp / totw
    avglen = np.linalg.norm(poses[:, :3, 3], axis=-1).mean()
    poses[:, :3, 3] *= target_radius / max(avglen, 1e-9)
    return poses


def rotmat2qvec_colmap(R: np.ndarray):
    """COLMAP images.txt quaternion from a w2c rotation (the simple
    trace formula the reference converters use)."""
    q0 = 0.5 * math.sqrt(max(1 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12))
    return (q0,
            (R[2, 1] - R[1, 2]) / (4 * q0),
            (R[0, 2] - R[2, 0]) / (4 * q0),
            (R[1, 0] - R[0, 1]) / (4 * q0))


# ---------------------------------------------------------- frame dumps

def extract_video_frames(video_path: str, out_dir: str, prefix: str,
                         downscale: int = 1, start: int = 0,
                         end: int | None = None) -> int:
    """mp4 -> out_dir/<prefix>_%04d.png via cv2 (ffmpeg-free)."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    i = written = 0
    while True:
        ok, frame = cap.read()
        if not ok or (end is not None and i >= end):
            break
        if i >= start:
            if downscale > 1:
                frame = cv2.resize(
                    frame, (frame.shape[1] // downscale,
                            frame.shape[0] // downscale),
                    interpolation=cv2.INTER_AREA)
            cv2.imwrite(os.path.join(out_dir, f"{prefix}_{i:04d}.png"),
                        frame)
            written += 1
        i += 1
    cap.release()
    return written


def compute_undistort_intrinsic(K, height, width, distortion):
    """Fisheye undistortion intrinsics (immersive2blender.py:231-246)."""
    import cv2

    assert len(distortion) == 4
    new_K = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(
        K, distortion, (width, height), np.eye(3), balance=0.0)
    # shrink to guard against black borders (reference heuristic)
    new_K[0, 0] *= 0.95
    new_K[1, 1] *= 0.95
    new_K[0, 2] = width / 2.0
    new_K[1, 2] = height / 2.0
    return new_K


# --------------------------------------------------------------- output

def write_transforms(path: str, train_frames, test_frames,
                     shared: dict | None = None):
    for split, frames in (("train", train_frames), ("test", test_frames)):
        payload = dict(shared or {})
        payload["frames"] = frames
        out = os.path.join(path, f"transforms_{split}.json")
        with open(out, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"[convert] wrote {out} ({len(frames)} frames)")


def write_random_points(path: str, n: int = 100_000, radius: float = 2.6,
                        seed: int = 0):
    """Random init cloud fallback (the reference readers generate the
    same when points3d.ply is missing, dataset_readers.py:403-413)."""
    from ..data.ply import write_point_cloud

    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 3)).astype(np.float32) * 2 - 1) * radius
    rgb = rng.random((n, 3)).astype(np.float32) * 255
    write_point_cloud(path, pts, rgb)
    print(f"[convert] wrote random init cloud {path}")


def colmap_points_to_ply(model_dir: str, out_ply: str) -> bool:
    """COLMAP sparse model (bin or txt) -> points3d.ply."""
    from ..data import colmap as CM
    from ..data.ply import write_point_cloud

    for reader, name in ((CM.read_points3d_binary, "points3D.bin"),
                         (CM.read_points3d_text, "points3D.txt")):
        p = os.path.join(model_dir, name)
        if os.path.exists(p):
            xyz, rgb, _ = reader(p)
            write_point_cloud(out_ply, xyz, rgb)
            print(f"[convert] wrote {out_ply} ({len(xyz)} points)")
            return True
    return False


# ------------------------------------------------- COLMAP triangulation

def _cameras_to_database(cameras_txt: str, db_path: str):
    """Update COLMAP's auto-created camera rows with the known
    intrinsics (reference camTodatabase, neu3d2blender.py:149-207)."""
    model_ids = {"SIMPLE_PINHOLE": 0, "PINHOLE": 1, "SIMPLE_RADIAL": 2}
    db = sqlite3.connect(db_path)
    with open(cameras_txt) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            model = model_ids[parts[1]]
            w, h = int(parts[2]), int(parts[3])
            params = np.array([float(x) for x in parts[4:]], np.float64)
            db.execute(
                "UPDATE cameras SET model=?, width=?, height=?, params=?,"
                " prior_focal_length=1 WHERE camera_id=?",
                (model, w, h, params.tobytes(), cam_id))
    db.commit()
    db.close()


def triangulate_known_poses(path: str, images_dir: str, cam_lines,
                            image_lines, out_ply: str,
                            dense: bool = False) -> bool:
    """Known-pose COLMAP triangulation -> points3d.ply (the reference's
    created/triangulated workspace flow, neu3d2blender.py:374-436).

    cam_lines: cameras.txt body lines; image_lines: images.txt body
    lines (each followed by the empty observations line). Returns False
    (and leaves no ply) when colmap is unavailable.
    """
    if not have_binary("colmap"):
        print("[convert] colmap binary not found — skipping "
              "triangulation (pass --random_points or provide "
              "points3d.ply yourself)")
        return False
    ws = os.path.join(path, "tmp_colmap")
    created = os.path.join(ws, "created", "sparse")
    tri = os.path.join(ws, "triangulated", "sparse")
    os.makedirs(created, exist_ok=True)
    os.makedirs(tri, exist_ok=True)
    with open(os.path.join(created, "cameras.txt"), "w") as f:
        f.write("\n".join(cam_lines) + "\n")
    with open(os.path.join(created, "images.txt"), "w") as f:
        for line in image_lines:
            f.write(line + "\n\n")
    open(os.path.join(created, "points3D.txt"), "w").close()

    db = os.path.join(ws, "database.db")
    do_system(f"colmap feature_extractor --database_path {db} "
              f"--image_path {images_dir}")
    _cameras_to_database(os.path.join(created, "cameras.txt"), db)
    do_system(f"colmap exhaustive_matcher --database_path {db}")
    do_system(f"colmap point_triangulator --database_path {db} "
              f"--image_path {images_dir} --input_path {created} "
              f"--output_path {tri}")
    if dense:
        dense_dir = os.path.join(ws, "dense")
        os.makedirs(dense_dir, exist_ok=True)
        do_system(f"colmap image_undistorter --image_path {images_dir} "
                  f"--input_path {tri} --output_path {dense_dir}")
        do_system(f"colmap patch_match_stereo --workspace_path {dense_dir}")
        do_system(f"colmap stereo_fusion --workspace_path {dense_dir} "
                  f"--output_path {out_ply}")
        if os.path.exists(out_ply + ".vis"):
            os.remove(out_ply + ".vis")
    else:
        colmap_points_to_ply(tri, out_ply)
    shutil.rmtree(ws)
    return True
