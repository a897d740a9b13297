"""Dataset readers: COLMAP static scenes, multi-view transforms JSON
(Blender / Neu3D / Technicolor / Immersive), and Nerfies/HyperNeRF/
NeRF-DS.

Behavioral contract: scene/dataset_readers.py in the reference — same
sentinel-file detection, pose conventions (R stored transposed), per-
frame fid normalization, end_frame truncation, SAM-mask paths
(masks/<name>.pt|.npz), NeRF++ camera normalization, and the 100k
random-point fallback cloud. Image loading runs on a thread pool.
"""
from __future__ import annotations

import json
import os
from glob import glob
from multiprocessing.pool import ThreadPool
from pathlib import Path
from typing import NamedTuple, Optional, Union

import numpy as np
from PIL import Image

from ..utils.graphics import BasicPointCloud, focal_to_fov, fov_to_focal, world_to_view
from ..utils.sh import sh_to_rgb
from . import colmap
from .cameras import camera_nerfies_from_json
from .masks import decode_mask_file
from .ply import read_point_cloud, write_point_cloud


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray
    T: np.ndarray
    FovY: float
    FovX: float
    image: Optional[Image.Image]
    image_path: str
    image_name: str
    width: int
    height: int
    masks: Union[np.ndarray, None]
    mask_path: Optional[str]
    fid: float


class SceneInfo(NamedTuple):
    point_cloud: Optional[BasicPointCloud]
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict
    ply_path: str


def get_nerfpp_norm(cam_info, apply: bool = False):
    """Camera-centroid translate + diagonal radius (NeRF++ style); with
    apply=True the cameras are normalized in place and unit norm returned."""
    centers = []
    c2ws = []
    for cam in cam_info:
        W2C = world_to_view(cam.R, cam.T)
        C2W = np.linalg.inv(W2C)
        c2ws.append(C2W)
        centers.append(C2W[:3, 3:4])
    centers_m = np.hstack(centers)
    center = centers_m.mean(axis=1, keepdims=True)
    diagonal = np.max(np.linalg.norm(centers_m - center, axis=0))
    translate = -center.flatten()
    radius = diagonal
    if apply:
        c2ws = np.stack(c2ws)
        c2ws[:, :3, -1] += translate
        c2ws[:, :3, -1] /= radius
        w2cs = np.linalg.inv(c2ws)
        for i, cam in enumerate(cam_info):
            cam_info[i] = cam._replace(R=w2cs[i, :3, :3].T, T=w2cs[i, :3, 3])
        return {
            "translate": 0, "radius": 1.0,
            "apply_translate": translate, "apply_radius": radius,
        }
    return {"translate": translate, "radius": radius}


def _find_mask_path(*candidates):
    for c in candidates:
        if c and os.path.exists(c):
            return c
    # prefer the first candidate as the canonical (possibly missing) path
    return candidates[0] if candidates else None


def _load_masks_maybe(mask_path, on_the_fly):
    if on_the_fly or mask_path is None:
        return None
    try:
        return decode_mask_file(mask_path)
    except Exception as e:  # noqa: BLE001
        print(f"[Warning] failed to load masks {mask_path}: {e}")
        return None


def _composite_on_background(image_path: str, white_background: bool):
    """RGBA -> RGB composited on the train background color."""
    with Image.open(image_path) as im:
        im_data = np.array(im.convert("RGBA"))
    bg = np.array([1, 1, 1]) if white_background else np.array([0, 0, 0])
    norm = im_data / 255.0
    arr = norm[:, :, :3] * norm[:, :, 3:4] + bg * (1 - norm[:, :, 3:4])
    if norm[:, :, 3:4].min() < 1:
        arr = np.concatenate([arr, norm[:, :, 3:4]], axis=2)
        return Image.fromarray((arr * 255.0).astype(np.uint8), "RGBA")
    return Image.fromarray((arr * 255.0).astype(np.uint8), "RGB")


# ----------------------------------------------------------- COLMAP -------

def read_colmap_cameras(cam_extrinsics, cam_intrinsics, images_folder,
                        source_path=None, load_image_on_the_fly=False,
                        load_mask_on_the_fly=False):
    cam_infos = []
    num_frames = len(cam_extrinsics)
    for idx, key in enumerate(sorted(cam_extrinsics.keys())):
        extr = cam_extrinsics[key]
        intr = cam_intrinsics[extr.camera_id]
        height, width = intr.height, intr.width
        R = np.transpose(colmap.qvec2rotmat(extr.qvec))
        T = np.array(extr.tvec)

        if intr.model == "SIMPLE_PINHOLE":
            FovY = focal_to_fov(intr.params[0], height)
            FovX = focal_to_fov(intr.params[0], width)
        elif intr.model in ("PINHOLE", "OPENCV", "SIMPLE_RADIAL"):
            FovY = focal_to_fov(intr.params[1], height)
            FovX = focal_to_fov(intr.params[0], width)
        else:
            raise AssertionError(
                "Colmap camera model not handled: only undistorted "
                "(PINHOLE/SIMPLE_PINHOLE) supported"
            )

        image_path = os.path.join(images_folder, os.path.basename(extr.name))
        image_name = os.path.basename(image_path).split(".")[0]
        image = Image.open(image_path) if os.path.exists(image_path) else None
        if image is not None:
            width, height = image.size
        if load_image_on_the_fly:
            image = None

        mask_path = None
        masks = None
        if source_path:
            mask_path = _find_mask_path(
                os.path.join(source_path, "masks", image_name + ".pt"),
                os.path.join(source_path, "masks", image_name + ".npz"),
            )
            masks = _load_masks_maybe(mask_path, load_mask_on_the_fly)
        try:
            fid = int(image_name) / (num_frames - 1)
        except ValueError:
            fid = 0.0

        cam_infos.append(CameraInfo(
            uid=intr.id, R=R, T=T, FovY=FovY, FovX=FovX, image=image,
            image_path=image_path, image_name=image_name,
            width=width, height=height, masks=masks, mask_path=mask_path,
            fid=fid,
        ))
    return cam_infos


def read_colmap_scene_info(path, images=None, eval=False, llffhold=8,
                           load_image_on_the_fly=False,
                           load_mask_on_the_fly=False, **_):
    sparse = os.path.join(path, "sparse/0")
    try:
        cam_extrinsics = colmap.read_images_binary(
            os.path.join(sparse, "images.bin"))
        cam_intrinsics = colmap.read_cameras_binary(
            os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        cam_extrinsics = colmap.read_images_text(
            os.path.join(sparse, "images.txt"))
        cam_intrinsics = colmap.read_cameras_text(
            os.path.join(sparse, "cameras.txt"))

    reading_dir = images if images else "images"
    cam_infos = read_colmap_cameras(
        cam_extrinsics, cam_intrinsics, os.path.join(path, reading_dir),
        source_path=path, load_image_on_the_fly=load_image_on_the_fly,
        load_mask_on_the_fly=load_mask_on_the_fly,
    )
    cam_infos = sorted(cam_infos, key=lambda x: x.image_name)

    if eval:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap.read_points3d_binary(
                os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3d_text(
                os.path.join(sparse, "points3D.txt"))
        write_point_cloud(ply_path, xyz, rgb)
    try:
        pcd = read_point_cloud(ply_path)
    except Exception:  # noqa: BLE001
        pcd = None
    return SceneInfo(pcd, train, test, norm, ply_path)


# ------------------------------------------------- transforms JSON --------

def read_cameras_from_transforms(path, transformsfile, white_background,
                                 extension=".png",
                                 load_image_on_the_fly=False,
                                 load_mask_on_the_fly=False, end_frame=-1):
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)

    if "camera_angle_x" in contents:
        dataset_type = "blender"
        fovx = contents["camera_angle_x"]
        time_duration = None
    elif all(k in contents for k in ("fl_x", "fl_y", "cx", "cy")):
        dataset_type = "neu3d"
        time_duration = 10.0
    elif "technicolor" in path:
        dataset_type = "technicolor"
        time_duration = 10.0 / 6.0
    else:
        dataset_type = "immersive"
        time_duration = 10.0
    print(f"[readers] transforms dataset type: {dataset_type}")

    frames = contents["frames"]

    def frame_read_fn(idx_frame):
        idx, frame = idx_frame
        fid = int(frame["file_path"].split("/")[-1][-4:])
        frame_time = frame["time"]
        if time_duration:
            if end_frame != -1:
                frame_time /= (end_frame / 300.0) * 10.0
                if fid > end_frame:
                    return None
            else:
                frame_time /= time_duration

        cam_name = os.path.join(path, frame["file_path"] + extension)
        if dataset_type in ("immersive", "technicolor"):
            w2c = np.array(frame["transform_matrix"])
        else:
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1  # OpenGL/Blender -> COLMAP axes
            w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]

        image_path = os.path.join(path, cam_name)
        image_name = Path(cam_name).stem

        if not load_image_on_the_fly:
            image = _composite_on_background(image_path, white_background)
            width, height = image.size
        else:
            image = None
            width = frame.get("w", contents.get("w"))
            height = frame.get("h", contents.get("h"))

        base = frame["file_path"].split("/")[-1]
        if dataset_type == "blender":
            sub = frame["file_path"].split("/")[-2]
            mask_path = _find_mask_path(
                os.path.join(path, sub, "masks", base + ".pt"),
                os.path.join(path, sub, "masks", base + ".npz"),
            )
            fovy = focal_to_fov(fov_to_focal(fovx, width), height)
            FovY, FovX = fovy, fovx
        else:
            mask_path = _find_mask_path(
                os.path.join(path, "masks", base + ".pt"),
                os.path.join(path, "masks", base + ".npz"),
            )
            if dataset_type == "neu3d":
                fl_x, fl_y = contents["fl_x"], contents["fl_y"]
            else:
                fl_x, fl_y = frame["fl_x"], frame["fl_y"]
            FovY = focal_to_fov(fl_y, height)
            FovX = focal_to_fov(fl_x, width)

        masks = _load_masks_maybe(mask_path, load_mask_on_the_fly)
        return CameraInfo(
            uid=idx, R=R, T=T, FovY=FovY, FovX=FovX, image=image,
            image_path=image_path, image_name=image_name,
            width=width, height=height, fid=frame_time, masks=masks,
            mask_path=mask_path,
        )

    with ThreadPool() as pool:
        cam_infos = pool.map(frame_read_fn, enumerate(frames))
    cam_infos = [c for c in cam_infos if c is not None]
    print(f"[readers] {len(cam_infos)} images loaded.")
    return cam_infos


def read_multi_view_info(path, white_background=False, eval=False,
                         extension=".png", load_image_on_the_fly=False,
                         load_mask_on_the_fly=False, end_frame=-1, **_):
    train = read_cameras_from_transforms(
        path, "transforms_train.json", white_background, extension,
        load_image_on_the_fly, load_mask_on_the_fly, end_frame)
    test = read_cameras_from_transforms(
        path, "transforms_test.json", white_background, extension,
        load_image_on_the_fly, load_mask_on_the_fly, end_frame)
    if not eval:
        train = train + test
        test = []

    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        print(f"[readers] generating random point cloud ({num_pts})...")
        xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3
        shs = np.random.random((num_pts, 3)) / 255.0
        write_point_cloud(ply_path, xyz,
                          np.asarray(sh_to_rgb(shs)) * 255)
    try:
        pcd = read_point_cloud(ply_path)
    except Exception:  # noqa: BLE001
        pcd = None
    return SceneInfo(pcd, train, test, norm, ply_path)


# ----------------------------------------------------------- nerfies ------

def read_nerfies_cameras(path, load_image_on_the_fly=False,
                         load_mask_on_the_fly=False):
    with open(f"{path}/scene.json") as f:
        scene_json = json.load(f)
    with open(f"{path}/metadata.json") as f:
        meta_json = json.load(f)
    with open(f"{path}/dataset.json") as f:
        dataset_json = json.load(f)

    coord_scale = scene_json["scale"]
    scene_center = scene_json["center"]

    name = path.split("/")[-2] if len(path.split("/")) >= 2 else ""
    if name.startswith("vrig"):
        train_img = dataset_json["train_ids"]
        val_img = dataset_json["val_ids"]
        all_img = train_img + val_img
        ratio = 0.25
    elif name.startswith("NeRF"):
        train_img = dataset_json["train_ids"]
        val_img = dataset_json["val_ids"]
        all_img = train_img + val_img
        ratio = 0.5
    elif name.startswith("interp"):
        all_id = dataset_json["ids"]
        train_img = all_id[::4]
        val_img = all_id[2::4]
        all_img = train_img + val_img
        ratio = 0.5
    else:  # hypernerf misc
        all_id = dataset_json["ids"]
        train_img = all_id[::4]
        val_img = all_id[2::4]
        all_img = train_img + val_img
        ratio = 0.5

    train_num = len(train_img)
    all_time = [meta_json[i]["time_id"] for i in all_img]
    max_time = max(all_time)
    all_time = [t / max_time for t in all_time]

    all_cam_params = []
    for im in all_img:
        camera = camera_nerfies_from_json(f"{path}/camera/{im}.json", ratio)
        camera["position"] = (camera["position"] - scene_center) * coord_scale
        all_cam_params.append(camera)

    img_paths = [f"{path}/rgb/{int(1 / ratio)}x/{i}.png" for i in all_img]

    cam_infos = []
    for idx, image_path in enumerate(img_paths):
        image_name = Path(image_path).stem
        image = Image.open(image_path)
        width, height = image.size
        if load_image_on_the_fly:
            image = None

        mask_path = _find_mask_path(
            os.path.join(path, "masks", image_name + ".pt"),
            os.path.join(path, "masks", image_name + ".npz"),
        )
        masks = _load_masks_maybe(mask_path, load_mask_on_the_fly)

        orientation = all_cam_params[idx]["orientation"].T
        position = -all_cam_params[idx]["position"] @ orientation
        focal = all_cam_params[idx]["focal_length"]

        cam_infos.append(CameraInfo(
            uid=idx, R=orientation, T=position,
            FovY=focal_to_fov(focal, height), FovX=focal_to_fov(focal, width),
            image=image, image_path=image_path, image_name=image_name,
            width=width, height=height, fid=all_time[idx], masks=masks,
            mask_path=mask_path,
        ))
    return cam_infos, train_num, scene_center, coord_scale


def read_nerfies_info(path, eval=False, load_image_on_the_fly=False,
                      load_mask_on_the_fly=False, **_):
    print("[readers] reading Nerfies info")
    cam_infos, train_num, scene_center, scene_scale = read_nerfies_cameras(
        path, load_image_on_the_fly=load_image_on_the_fly,
        load_mask_on_the_fly=load_mask_on_the_fly)

    if eval:
        train = cam_infos[:train_num]
        test = cam_infos[train_num:]
    else:
        train, test = cam_infos, []

    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        print("[readers] generating point cloud from nerfies points.npy...")
        xyz = np.load(os.path.join(path, "points.npy"))
        xyz = (xyz - scene_center) * scene_scale
        shs = np.random.random((xyz.shape[0], 3)) / 255.0
        write_point_cloud(ply_path, xyz, np.asarray(sh_to_rgb(shs)) * 255)
    try:
        pcd = read_point_cloud(ply_path)
    except Exception:  # noqa: BLE001
        pcd = None
    return SceneInfo(pcd, train, test, norm, ply_path)


scene_load_type_callbacks = {
    "Colmap": read_colmap_scene_info,
    "Blender": read_multi_view_info,
    "nerfies": read_nerfies_info,
}
