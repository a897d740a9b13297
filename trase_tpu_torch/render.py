"""Offline rendering CLI of the port: ``python -m trase_tpu_torch.render``.

Counterpart of the repository's root render.py: loads a model directory
written by the JAX trainer (point_cloud/iteration_N/point_cloud.ply,
deform/iteration_N/deform.pkl, cfg_args.json), runs the deform MLP per
view and renders on the card (``--device cuda``, the default) or on the
CPU (``--device cpu``). Per split it writes the streams

    <model>/<split>/ours_<iter>/renders/      deformed view
    <model>/<split>/ours_<iter>/gt/           ground truth
    <model>/<split>/ours_<iter>/rendered_feats/  PCA of the 3D features
                                                  (+ gaussian_feats3d.npy)
    <model>/<split>/ours_<iter>/canonical/    undeformed first view

at the same paths and names as render.py. Its cluster, segmentation,
--segment_ids, text-prompt, point-cloud and video streams are not ported
yet: they are skipped with a printed note.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import resolve_device
from .config import ModelParams, PipelineParams, get_combined_args

SKIPPED_STREAMS = ("pointcloud, gaussian_feats, gaussian_clusters, "
                   "segmentation, segment_objects, pred_masks, "
                   "text-prompt objects and videos")


@torch.no_grad()
def render_sets(args):
    from .data.scene import Scene
    from .models.deform import deform_step, load_flax_params, make_deform_network
    from .models.gaussians_io import load_checkpoint
    from .ops.rasterize import RasterConfig
    from .renderer import render
    from .viz import AsyncImageWriter, feature3d_to_rgb

    device = resolve_device(args.device)
    dataset = ModelParams.extract(args)
    scene = Scene(dataset, load_iteration=args.iteration, shuffle=False,
                  device=device)
    it = scene.loaded_iter
    params, aux = scene.gaussian_params, scene.gaussian_aux
    n = scene.n_gaussians
    capacity = params.xyz.shape[0]

    print(f"[note] not ported yet, skipped: {SKIPPED_STREAMS}")
    if getattr(args, "segment_ids", None) is not None \
            or args.text_prompt or args.text_prompt_mask:
        print("[note] --segment_ids / --text_prompt / --text_prompt_mask "
              "are not ported yet; ignored")

    deform_net = make_deform_network(
        args.model_type, is_blender=dataset.is_blender,
        is_6dof=dataset.is_6dof, device=device)
    dpath = os.path.join(dataset.model_path, "deform", f"iteration_{it}",
                         "deform.pkl")
    has_deform = os.path.exists(dpath)
    if has_deform:
        load_flax_params(deform_net, load_checkpoint(dpath)["vars"])
    else:
        print(f"[Warning] no deform weights at {dpath}; rendering "
              "canonical only")

    bg = torch.tensor([1.0, 1.0, 1.0] if dataset.white_background
                      else [0.0, 0.0, 0.0], dtype=torch.float32,
                      device=device)
    cfg = RasterConfig(pairs_per_gaussian=args.pairs_per_gaussian,
                       max_per_tile=args.max_per_tile,
                       pack_features=args.pack_features)
    feats = params.gaussian_features
    pca_full = torch.zeros((capacity, 3), dtype=torch.float32, device=device)
    pca_full[:n] = feature3d_to_rgb(feats[:n])

    def render_frame(d, cam, override_color=None):
        return render(cam.to_render_camera(device), params, aux.alive, bg,
                      *d, is_6dof=dataset.is_6dof,
                      sh_degree=dataset.sh_degree,
                      override_color=override_color, with_features=False,
                      raster_cfg=cfg)

    def run_split(name, views):
        if not views:
            return
        base = os.path.join(dataset.model_path, name, f"ours_{it}")
        for s in ("renders", "gt", "rendered_feats", "canonical"):
            os.makedirs(os.path.join(base, s), exist_ok=True)
        writer = AsyncImageWriter(multithread=args.multithread_save)
        np.save(os.path.join(base, "rendered_feats", "gaussian_feats3d.npy"),
                feats[:n].cpu().numpy())
        print(f"Rendering {name}: {len(views)} views")
        for idx, view in enumerate(views):
            if has_deform:
                t = torch.full((capacity, 1), float(np.float32(view.fid)),
                               dtype=torch.float32, device=device)
                if args.model_type == "DeformSemanticNetwork":
                    d = deform_step(deform_net, params.xyz, t,
                                    params.gaussian_features)
                else:
                    d = deform_step(deform_net, params.xyz, t)
            else:
                d = (0.0, 0.0, 0.0)

            out = render_frame(d, view)
            writer.submit(os.path.join(base, "renders", f"{idx:05d}.png"),
                          out["render"])
            rf = render_frame(d, view, override_color=pca_full)
            writer.submit(os.path.join(base, "rendered_feats",
                                       f"{idx:05d}.png"), rf["render"])
            if idx == 0:
                canon = render_frame((0.0, 0.0, 0.0), view)
                writer.submit(os.path.join(base, "canonical",
                                           f"{idx:05d}.png"),
                              canon["render"])
            gt = view.image
            if gt is None and view.image_path:
                from PIL import Image as PILImage

                with PILImage.open(view.image_path) as im:
                    gt = np.asarray(im.convert("RGB"),
                                    np.float32).transpose(2, 0, 1) / 255.0
            if gt is not None:
                writer.submit(os.path.join(base, "gt", f"{idx:05d}.png"), gt)
        writer.close()

    if not args.skip_train:
        run_split("train", scene.get_train_cameras())
    if not args.skip_test:
        run_split("test", scene.get_test_cameras())


def main(argv=None):
    parser = argparse.ArgumentParser(description="Testing script parameters")
    ModelParams.add_to_parser(parser, sentinel=True)
    PipelineParams.add_to_parser(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--model_type", default="DeformNetwork", type=str)
    parser.add_argument("--segment_ids", nargs="+", type=int, default=None)
    parser.add_argument("--text_prompt", type=str, default="")
    parser.add_argument("--text_prompt_mask", type=str, default="")
    parser.add_argument("--threshold", type=int, default=500)
    parser.add_argument("--score_threshold", type=float, default=0.0)
    parser.add_argument("--use_kmeans", action="store_true")
    parser.add_argument("--multithread_save", action="store_true",
                        default=False)
    parser.add_argument("--pack_features", action="store_true")
    parser.add_argument("--max_per_tile", type=int, default=1024)
    parser.add_argument("--pairs_per_gaussian", type=int, default=8)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card, default) or cpu")
    args = get_combined_args(parser, argv)
    # fill defaults the saved cfg may not contain
    for f in ("sh_degree", "white_background", "is_blender", "is_6dof",
              "eval", "load2gpu_on_the_fly", "load_image_on_the_fly",
              "load_mask_on_the_fly", "end_frame", "mask_black_bg",
              "images", "resolution", "data_device"):
        if not hasattr(args, f) or getattr(args, f) is None:
            setattr(args, f, ModelParams.__dataclass_fields__[f].default)
    print("Rendering " + args.model_path)
    render_sets(args)


if __name__ == "__main__":
    main()
