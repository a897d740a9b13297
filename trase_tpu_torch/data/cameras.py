"""Host-side camera containers and camera-list assembly.

Behavioral contract: scene/cameras.py and utils/camera_utils.py in the
reference — cameras carry pose (R stored transposed, COLMAP style), FoV,
the ground-truth image (CHW float in [0,1]), a normalized timestamp
``fid``, and the SAM-mask reference; the resolution policy divides by
{1,2,4,8} or auto-downscales >1600px widths. Device matrices are built
lazily via ``to_render_camera`` (trase_tpu_torch.renderer.RenderCamera),
on the device the caller names.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from ..utils.graphics import fov_to_focal

_WARNED = False


@dataclass
class Camera:
    uid: int
    colmap_id: int
    R: np.ndarray
    T: np.ndarray
    fovx: float
    fovy: float
    image: Optional[np.ndarray]  # (3,H,W) float32 [0,1] or None (on the fly)
    image_name: str
    image_path: Optional[str]
    image_width: int
    image_height: int
    fid: float
    masks: Any = None  # decoded (N,H,W) bool, raw container, or None
    mask_path: Optional[str] = None
    gt_alpha_mask: Optional[np.ndarray] = None
    znear: float = 0.01
    zfar: float = 100.0
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0
    _render_cameras: dict = field(default_factory=dict)

    def to_render_camera(self, device="cuda"):
        key = str(device)
        if key not in self._render_cameras:
            from ..renderer import make_render_camera

            self._render_cameras[key] = make_render_camera(
                self.R, self.T, self.fovx, self.fovy,
                self.image_height, self.image_width,
                znear=self.znear, zfar=self.zfar,
                trans=self.trans, scale=self.scale, device=device,
            )
        return self._render_cameras[key]


def choose_resolution(orig_w: int, orig_h: int, resolution: int,
                      resolution_scale: float = 1.0):
    """The reference's resolution policy (utils/camera_utils.py:28-48)."""
    global _WARNED
    if resolution in (1, 2, 4, 8):
        return (
            round(orig_w / (resolution_scale * resolution)),
            round(orig_h / (resolution_scale * resolution)),
        )
    if resolution == -1:
        if orig_w > 1600:
            if not _WARNED:
                print(
                    "[ INFO ] Large input images (>1.6K width), rescaling "
                    "to 1.6K. Use --resolution 1 to disable."
                )
                _WARNED = True
            global_down = orig_w / 1600
        else:
            global_down = 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def load_camera(args, uid: int, info, resolution_scale: float) -> Camera:
    """CameraInfo (data.readers) -> Camera with the resolution policy
    applied to the stored image."""
    image = info.image
    width, height = info.width, info.height
    if image is not None:
        from PIL import Image as PILImage

        orig_w, orig_h = image.size
        res = choose_resolution(orig_w, orig_h, args.resolution,
                                resolution_scale)
        resized = np.asarray(image.resize(res)) / 255.0
        if resized.ndim == 2:
            resized = resized[..., None]
        chw = resized.transpose(2, 0, 1).astype(np.float32)
        gt = np.clip(chw[:3], 0.0, 1.0)
        alpha = chw[3:4] if chw.shape[0] == 4 else None
        width, height = res
    else:
        gt = None
        alpha = None

    return Camera(
        uid=uid,
        colmap_id=info.uid,
        R=info.R,
        T=info.T,
        fovx=info.FovX,
        fovy=info.FovY,
        image=gt,
        gt_alpha_mask=alpha,
        image_name=info.image_name,
        image_path=info.image_path,
        image_width=width if gt is not None else info.width,
        image_height=height if gt is not None else info.height,
        fid=info.fid,
        masks=info.masks,
        mask_path=info.mask_path,
    )


def camera_list_from_infos(infos, resolution_scale: float, args):
    return [load_camera(args, i, c, resolution_scale)
            for i, c in enumerate(infos)]


def camera_to_json(uid: int, camera: Camera) -> dict:
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = camera.R.transpose()
    Rt[:3, 3] = camera.T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    return {
        "id": uid,
        "img_name": camera.image_name,
        "width": camera.image_width,
        "height": camera.image_height,
        "position": W2C[:3, 3].tolist(),
        "rotation": [r.tolist() for r in W2C[:3, :3]],
        "fy": fov_to_focal(camera.fovy, camera.image_height),
        "fx": fov_to_focal(camera.fovx, camera.image_width),
    }


def camera_nerfies_from_json(path: str, scale: float) -> dict:
    """Nerfies camera JSON (utils/camera_utils.py:102-122)."""
    with open(path) as fp:
        cj = json.load(fp)
    if "tangential" in cj:
        cj["tangential_distortion"] = cj["tangential"]
    return dict(
        orientation=np.array(cj["orientation"]),
        position=np.array(cj["position"]),
        focal_length=cj["focal_length"] * scale,
        principal_point=np.array(cj["principal_point"]) * scale,
        skew=cj["skew"],
        pixel_aspect_ratio=cj["pixel_aspect_ratio"],
        radial_distortion=np.array(cj["radial_distortion"]),
        tangential_distortion=np.array(cj["tangential_distortion"]),
        image_size=np.array(
            (int(round(cj["image_size"][0] * scale)),
             int(round(cj["image_size"][1] * scale)))
        ),
    )
