"""Scene assembly: dataset detection, cameras, gaussian init / loading.

Behavioral contract: scene/__init__.py in the reference — sentinel-file
dataset detection (sparse/ -> Colmap, transforms_train.json -> multi-
view, dataset.json -> nerfies), input.ply + cameras.json copies,
camera shuffling, resolution-scaled camera lists, loading a trained
snapshot (optionally a saved object for composition), and save().
The gaussian field lands on the device the caller names.
"""
from __future__ import annotations

import json
import os
import random
import shutil
from typing import Optional

from ..models import gaussians as G
from ..models.gaussians_io import load_gaussian_ply, save_gaussian_ply
from ..utils.general import search_for_max_iteration
from .cameras import camera_list_from_infos, camera_to_json
from .readers import scene_load_type_callbacks


class Scene:
    def __init__(self, args, load_iteration: Optional[int] = None,
                 shuffle: bool = True, resolution_scales=(1.0,),
                 load_object: Optional[str] = None, device="cuda"):
        self.model_path = args.model_path
        self.loaded_iter = None

        if load_iteration:
            if load_iteration == -1:
                self.loaded_iter = search_for_max_iteration(
                    os.path.join(self.model_path, "point_cloud"))
            else:
                self.loaded_iter = load_iteration
            print(f"[scene] loading trained model at iteration "
                  f"{self.loaded_iter}")

        src = args.source_path
        if os.path.exists(os.path.join(src, "sparse")):
            scene_info = scene_load_type_callbacks["Colmap"](
                path=src, images=args.images, eval=args.eval,
                load_image_on_the_fly=args.load_image_on_the_fly,
                load_mask_on_the_fly=args.load_mask_on_the_fly)
        elif os.path.exists(os.path.join(src, "transforms_train.json")):
            scene_info = scene_load_type_callbacks["Blender"](
                path=src, white_background=args.white_background,
                eval=args.eval,
                load_image_on_the_fly=args.load_image_on_the_fly,
                load_mask_on_the_fly=args.load_mask_on_the_fly,
                end_frame=args.end_frame)
        elif os.path.exists(os.path.join(src, "dataset.json")):
            scene_info = scene_load_type_callbacks["nerfies"](
                path=src, eval=args.eval,
                load_image_on_the_fly=args.load_image_on_the_fly,
                load_mask_on_the_fly=args.load_mask_on_the_fly)
        else:
            raise AssertionError("Could not recognize scene type!")

        if not self.loaded_iter and self.model_path:
            os.makedirs(self.model_path, exist_ok=True)
            shutil.copyfile(scene_info.ply_path,
                            os.path.join(self.model_path, "input.ply"))
            json_cams = []
            camlist = list(scene_info.test_cameras) + list(
                scene_info.train_cameras)
            for cid, cam in enumerate(camlist):
                json_cams.append({
                    "id": cid, "img_name": cam.image_name,
                    "width": cam.width, "height": cam.height,
                })
            with open(os.path.join(self.model_path, "cameras.json"),
                      "w") as f:
                json.dump(json_cams, f)

        if shuffle:
            random.shuffle(scene_info.train_cameras)
            random.shuffle(scene_info.test_cameras)

        self.cameras_extent = float(scene_info.nerf_normalization["radius"])

        self.train_cameras = {}
        self.test_cameras = {}
        for rs in resolution_scales:
            self.train_cameras[rs] = camera_list_from_infos(
                scene_info.train_cameras, rs, args)
            self.test_cameras[rs] = camera_list_from_infos(
                scene_info.test_cameras, rs, args)

        # write the full camera JSON now that resolution is resolved
        if not self.loaded_iter and self.model_path:
            json_cams = [camera_to_json(i, c)
                         for i, c in enumerate(self.train_cameras[1.0]
                                               + self.test_cameras[1.0])]
            with open(os.path.join(self.model_path, "cameras.json"),
                      "w") as f:
                json.dump(json_cams, f)

        self.point_cloud = scene_info.point_cloud
        self.has_cluster_ids = False

        if self.loaded_iter:
            name = (f"point_cloud_{load_object}.ply" if load_object
                    else "point_cloud.ply")
            ply = os.path.join(self.model_path, "point_cloud",
                               f"iteration_{self.loaded_iter}", name)
            (self.gaussian_params, self.gaussian_aux, self.n_gaussians,
             self.has_cluster_ids) = load_gaussian_ply(
                ply, sh_degree=args.sh_degree, device=device)
        else:
            pcd = scene_info.point_cloud
            assert pcd is not None, "no point cloud available for init"
            self.gaussian_params, self.gaussian_aux = G.from_point_cloud(
                pcd.points, pcd.colors, args.sh_degree, device=device)
            self.n_gaussians = pcd.points.shape[0]

    # spatial_lr_scale: the reference hardcodes 5 (gaussian_model.py:224)
    spatial_lr_scale = 5.0

    def save(self, iteration: int, params: G.GaussianParams,
             alive, smoothed_features=None, with_cluster_ids: bool = False):
        path = os.path.join(self.model_path, "point_cloud",
                            f"iteration_{iteration}", "point_cloud.ply")
        save_gaussian_ply(path, params, alive,
                          smoothed_features=smoothed_features,
                          with_cluster_ids=with_cluster_ids)

    def get_train_cameras(self, scale=1.0):
        return self.train_cameras[scale]

    def get_test_cameras(self, scale=1.0):
        return self.test_cameras[scale]
