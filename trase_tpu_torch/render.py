"""Offline rendering CLI of the port: ``python -m trase_tpu_torch.render``.

Counterpart of the repository's root render.py: loads a model directory
(point_cloud/iteration_N/point_cloud.ply, deform/iteration_N/deform.pkl,
cfg_args.json and, where the cluster CLI wrote them, clusters.pt /
clusters_kmeans.pt), runs the deform MLP per view and renders on the card
(``--device cuda``, the default) or on the CPU (``--device cpu``). Per
split, at the same paths and names as render.py, it writes under
<model>/<split>/ours_<iter>/

    renders/  gt/  canonical/ (first view, undeformed)
    rendered_feats/ (PCA of the 3D features, + gaussian_feats3d.npy)
    pointcloud/  gaussian_feats/  gaussian_clusters/  (one-pixel splats)
    segmentation/ (cluster colours rendered)
    pred_masks/ + segment_objects/     with --segment_ids (Mask-Benchmark)
    text_prompt_<tag>_objects/         with --text_prompt_mask <png>

and an mp4 of every stream (video_<stream>.mp4). ``--text_prompt``
asks Grounded-SAM (ext/grounded_sam.py, on --device) for the 2D mask;
where groundingdino / segment_anything are not installed it prints
trase_tpu's warning and uses --text_prompt_mask when one is given.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import resolve_device
from .config import ModelParams, PipelineParams, get_combined_args


def load_cluster_table(cdir: str, capacity: int, use_kmeans: bool):
    """(ids (capacity,) int64, -1 past the file's rows; rgb (capacity, 3)
    float32) from clusters.pt, else clusters_kmeans.pt (only the latter
    with `use_kmeans`), or (None, None) without either (render.py:55-71)."""
    from .cluster import load_clusters

    for name in (("clusters_kmeans.pt",) if use_kmeans
                 else ("clusters.pt", "clusters_kmeans.pt")):
        p = os.path.join(cdir, name)
        if os.path.exists(p) or os.path.exists(p + ".npz"):
            ids, rgb = load_clusters(p)
            cluster_ids = np.full(capacity, -1, np.int64)
            cluster_ids[:len(ids)] = ids
            cluster_rgb = np.zeros((capacity, 3), np.float32)
            cluster_rgb[:len(rgb)] = rgb
            print(f"Load clusters from {name}")
            return cluster_ids, cluster_rgb
    print("[Warning] No clusters found...")
    return None, None


def select_gaussians(cluster_ids, feats, ids, score_threshold):
    """Union over `ids` of each cluster's members whose feature lies
    within `score_threshold` cosine of the cluster's mean feature
    (render.py:163-176, 218-226); None when no id has a member."""
    from .cluster import postprocessing

    selected = None
    for sid in ids:
        pre = cluster_ids == sid
        if not pre.any():
            continue
        post = pre & postprocessing(feats, feats[pre].mean(axis=0),
                                    score_threshold=score_threshold)
        selected = post if selected is None else selected | post
    return selected


@torch.no_grad()
def render_sets(args):
    from .data.scene import Scene
    from .models.deform import deform_step, load_flax_params, make_deform_network
    from .models.gaussians_io import load_checkpoint
    from .ops.knn import knn
    from .ops.rasterize import RasterConfig
    from .renderer import render
    from .viz import (AsyncImageWriter, feature3d_to_rgb, point_splat, to8b,
                      write_video)

    device = resolve_device(args.device)
    dataset = ModelParams.extract(args)
    scene = Scene(dataset, load_iteration=args.iteration, shuffle=False,
                  device=device)
    it = scene.loaded_iter
    params, aux = scene.gaussian_params, scene.gaussian_aux
    n = scene.n_gaussians
    capacity = params.xyz.shape[0]

    cluster_ids, cluster_rgb = load_cluster_table(
        os.path.join(dataset.model_path, "point_cloud", f"iteration_{it}"),
        capacity, args.use_kmeans)

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

    white = dataset.white_background
    bg = torch.tensor([1.0, 1.0, 1.0] if white else [0.0, 0.0, 0.0],
                      dtype=torch.float32, device=device)
    cfg = RasterConfig(pairs_per_gaussian=args.pairs_per_gaussian,
                       pack_features=args.pack_features)
    feats = params.gaussian_features
    feats_np = feats.cpu().numpy()
    pca_full = torch.zeros((capacity, 3), dtype=torch.float32, device=device)
    pca_full[:n] = feature3d_to_rgb(feats[:n])
    pca_np = pca_full[:n].cpu().numpy()
    cluster_rgb_t = None
    if cluster_rgb is not None:
        cluster_rgb_t = torch.from_numpy(cluster_rgb).to(device)
    ones = torch.ones((capacity, 3), dtype=torch.float32, device=device)

    def render_frame(d, cam, override_color=None, mask=None, bg_color=None):
        return render(cam.to_render_camera(device), params, aux.alive,
                      bg if bg_color is None else bg_color, *d,
                      is_6dof=dataset.is_6dof, sh_degree=dataset.sh_degree,
                      override_color=override_color, mask=mask,
                      with_features=False, raster_cfg=cfg)

    def binarized(img):
        """(3,H,W) -> 0/1 image and its per-pixel inlier mask
        (render.py:296-299)."""
        buf = img.cpu().numpy().copy()
        buf[buf < 0.5] = 0
        buf[buf != 0] = 1
        return buf, buf.mean(axis=0).astype(bool)

    def run_split(name, views):
        if not views:
            return
        base = os.path.join(dataset.model_path, name, f"ours_{it}")
        streams = ["renders", "gt", "rendered_feats", "canonical",
                   "pointcloud", "gaussian_clusters", "segmentation",
                   "gaussian_feats", "segment_objects", "pred_masks"]
        text_stream = None
        if args.text_prompt or args.text_prompt_mask:
            tag = args.text_prompt or os.path.splitext(
                os.path.basename(args.text_prompt_mask))[0]
            text_stream = f"text_prompt_{tag}_objects"
            streams.append(text_stream)
        for s in streams:
            os.makedirs(os.path.join(base, s), exist_ok=True)
        videos = {s: [] for s in streams}
        writer = AsyncImageWriter(multithread=args.multithread_save)

        def save(stream, idx, img, video=True):
            writer.submit(os.path.join(base, stream, f"{idx:05d}.png"), img)
            if video:
                videos[stream].append(to8b(img))

        np.save(os.path.join(base, "rendered_feats", "gaussian_feats3d.npy"),
                feats_np[:n])
        H, W = views[0].image_height, views[0].image_width

        segmented_mask = None
        # a saved cfg merged by get_combined_args drops unset options
        segment_ids = getattr(args, "segment_ids", None)
        if segment_ids is not None and cluster_ids is not None:
            sel = select_gaussians(cluster_ids, feats_np, segment_ids,
                                   args.score_threshold)
            if sel is not None:
                segmented_mask = torch.from_numpy(sel).to(device)
        text_mask = None
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
            save("renders", idx, out["render"])
            deformed = params.xyz + (d[0] if has_deform else 0.0)

            # text prompt -> 3D cluster lookup on the first frame
            if idx == 0 and (args.text_prompt_mask or args.text_prompt):
                mask2d = _resolve_text_mask(
                    args, out["render"].cpu().numpy(), device)
                if mask2d is not None and cluster_ids is not None:
                    pts3d = _unproject(mask2d, out["depth"][0].cpu().numpy(),
                                       view)
                    _, nn_idx = knn(torch.as_tensor(
                        pts3d, dtype=torch.float32, device=device),
                        deformed, k=1)
                    cls = cluster_ids[nn_idx[:, 0].cpu().numpy()]
                    counts = np.bincount(cls[cls >= 0])
                    text_cls_ids = np.nonzero(
                        counts > args.threshold)[0].tolist()
                    print("Text prompt cls id: ", text_cls_ids)
                    sel = select_gaussians(cluster_ids, feats_np,
                                           text_cls_ids,
                                           args.score_threshold)
                    if sel is not None:
                        text_mask = torch.from_numpy(sel).to(device)

            save("rendered_feats", idx,
                 render_frame(d, view, override_color=pca_full)["render"])

            # point splats of the deformed means
            dn = deformed[:n].cpu().numpy()
            fp = view.to_render_camera(device).buffers.full_proj
            save("pointcloud", idx, point_splat(dn, fp, H, W, None, white))
            save("gaussian_feats", idx,
                 point_splat(dn, fp, H, W, pca_np, white))
            if cluster_rgb is not None:
                save("gaussian_clusters", idx, point_splat(
                    dn, fp, H, W, cluster_rgb[:n], white))
                save("segmentation", idx, render_frame(
                    d, view, override_color=cluster_rgb_t)["render"])

            if idx == 0:
                save("canonical", idx,
                     render_frame((0.0, 0.0, 0.0), view)["render"],
                     video=False)

            gt = view.image
            if gt is None and view.image_path:
                from PIL import Image as PILImage

                with PILImage.open(view.image_path) as im:
                    gt = np.asarray(im.convert("RGB"),
                                    np.float32).transpose(2, 0, 1) / 255.0
            if gt is not None:
                save("gt", idx, gt)

            # --segment_ids -> pred_masks + segment_objects
            # (render.py:289-309)
            if segmented_mask is not None:
                buf, inlier = binarized(render_frame(
                    d, view, override_color=ones, mask=segmented_mask,
                    bg_color=torch.zeros_like(bg))["render"])
                save("pred_masks", idx, buf)
                so = render_frame(d, view, mask=segmented_mask)[
                    "render"].cpu().numpy().copy()
                so[:, ~inlier] = 1.0 if white else 0.0
                save("segment_objects", idx, so)

            # the text-prompt object (render.py:311-328): binarized white
            # render -> inlier mask -> masked RGB on the background colour
            if text_mask is not None and text_stream is not None:
                _, t_inlier = binarized(render_frame(
                    d, view, override_color=ones, mask=text_mask)["render"])
                to_img = render_frame(d, view, mask=text_mask)[
                    "render"].cpu().numpy().copy()
                to_img[:, ~t_inlier] = 1.0 if white else 0.0
                save(text_stream, idx, to_img)

        writer.close()
        for s, frames in videos.items():
            if frames:
                write_video(os.path.join(base, f"video_{s}.mp4"), frames)

    if not args.skip_train:
        run_split("train", scene.get_train_cameras())
    if not args.skip_test:
        run_split("test", scene.get_test_cameras())


def _resolve_text_mask(args, rendering=None, device=None):
    """The 2D text mask: Grounded-SAM (ext/grounded_sam.py) on the
    (3, H, W) `rendering` for --text_prompt, its networks on `device`;
    where those packages are absent it warns as trase_tpu does and falls
    back to the mask PNG of --text_prompt_mask."""
    if args.text_prompt:
        try:
            from .ext.grounded_sam import text_prompt_mask

            return text_prompt_mask(args.text_prompt, rendering, device)
        except ImportError:
            print("[Warning] Grounded-SAM unavailable; pass "
                  "--text_prompt_mask <png> instead")
    if args.text_prompt_mask:
        from PIL import Image as PILImage

        with PILImage.open(args.text_prompt_mask) as im:
            return np.asarray(im.convert("L")) > 127
    return None


def _unproject(mask2d, depth, view):
    """World points of the masked pixels from the rendered depth
    (render.py:360-374), on the host in float64."""
    rc = view.to_render_camera("cpu")
    H, W = view.image_height, view.image_width
    ys, xs = np.nonzero(mask2d)
    d = depth[ys, xs]
    znear, zfar = view.znear, view.zfar
    z = zfar / (zfar - znear) * d - zfar * znear / (zfar - znear)
    uvz = np.stack([((xs - 0.5) / W * 2 - 1) * d,
                    ((ys - 0.5) / H * 2 - 1) * d, z, d], axis=1)
    inv = np.linalg.inv(rc.buffers.full_proj.numpy())
    return (uvz @ inv)[:, :3]


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
    parser.add_argument("--max_per_tile", type=int, default=1024,
                        help="the root CLI's per-tile capacity, accepted; "
                             "the tiled compositor bins every pair, so "
                             "the value goes nowhere")
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
