"""COLMAP sparse-reconstruction parsers (binary + text, numpy).

Behavioral contract: scene/colmap_loader.py in the reference — reads
cameras/images/points3D from a COLMAP model directory. The binary
format is COLMAP's documented layout (camera_id/model/width/height/
params; image quaternions wxyz + tvec + name + 2D points; 3D points
with RGB + error + track).
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat2qvec(R):
    """The unit quaternion (w, x, y, z), w >= 0, of a rotation matrix:
    the eigenvector of the largest eigenvalue of the symmetric matrix
    built from R (COLMAP's rotmat2qvec)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cam_id, model_id, w, h = _read(f, 24, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * n_params, "d" * n_params))
            cams[cam_id] = ColmapCamera(cam_id, name, w, h, params)
    return cams


def read_cameras_text(path) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            cams[cam_id] = ColmapCamera(
                cam_id, parts[1], int(parts[2]), int(parts[3]),
                np.array([float(p) for p in parts[4:]]),
            )
    return cams


def read_images_binary(path) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            vals = _read(f, 64, "idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, 8, "Q")
            raw = _read(f, 24 * n_pts, "ddq" * n_pts)
            xys = np.array(raw).reshape(-1, 3)[:, :2] if n_pts else np.zeros((0, 2))
            ids = (
                np.array(raw).reshape(-1, 3)[:, 2].astype(np.int64)
                if n_pts else np.zeros((0,), np.int64)
            )
            images[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id, name.decode("utf-8"), xys, ids
            )
    return images


def read_images_text(path) -> dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [
            ln.strip() for ln in f
            if ln.strip() and not ln.strip().startswith("#")
        ]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        image_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        camera_id = int(parts[8])
        name = parts[9]
        elems = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = (
            np.array(elems, dtype=np.float64).reshape(-1, 3)[:, :2]
            if elems else np.zeros((0, 2))
        )
        ids = (
            np.array(elems, dtype=np.float64).reshape(-1, 3)[:, 2].astype(np.int64)
            if elems else np.zeros((0,), np.int64)
        )
        images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name,
                                       xys, ids)
    return images


def read_points3d_binary(path):
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3))
        err = np.empty((num, 1))
        for i in range(num):
            vals = _read(f, 43, "QdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = vals[4:7]
            err[i] = vals[7]
            (track_len,) = _read(f, 8, "Q")
            f.read(8 * track_len)
    return xyz, rgb, err


def read_points3d_text(path):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyz.append([float(p) for p in parts[1:4]])
            rgb.append([float(p) for p in parts[4:7]])
            err.append([float(parts[7])])
    return np.array(xyz), np.array(rgb), np.array(err)


def write_images_binary(images: dict[int, ColmapImage], path):
    """images.bin in COLMAP's binary layout (the dataset converters'
    writer): count, then per image id, qvec, tvec, camera id, the
    NUL-terminated name and its 2D points with their 3D point ids."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for img in images.values():
            f.write(struct.pack("<idddddddi", img.id, *img.qvec, *img.tvec,
                                img.camera_id))
            f.write(img.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(img.xys)))
            for xy, pid in zip(img.xys, img.point3D_ids):
                f.write(struct.pack("<ddq", xy[0], xy[1], pid))


def write_cameras_binary(cams: dict[int, ColmapCamera], path):
    """cameras.bin in COLMAP's binary layout: count, then per camera id,
    model id, width, height and its float64 parameters."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid, _ = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))
