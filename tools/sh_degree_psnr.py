"""Test-view PSNR of a saved snapshot rendered at each SH degree.

    python tools/sh_degree_psnr.py --data DIR --model DIR --iteration N \
        [--device cuda]

Loads point_cloud/iteration_N/point_cloud.ply and
deform/iteration_N/deform.pkl through the port's loaders and renders
every test view of the dataset DIR as the trainer's evaluate does (the
deform net on, its hidden stack in bf16, no features, clipped to [0, 1]),
at SH degrees 0 up to the snapshot's. Prints one JSON line: for each
degree the mean PSNR and the per-view PSNRs, views in the dataset's
order (unshuffled). A render below the degree a run trained to is what a
post-hoc evaluation gets from a trainer built afresh around a loaded
snapshot: its active degree starts at 0.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from trase_tpu_torch import resolve_device  # noqa: E402
from trase_tpu_torch.config import ModelParams  # noqa: E402
from trase_tpu_torch.data.scene import Scene  # noqa: E402
from trase_tpu_torch.engine import trainer as T  # noqa: E402
from trase_tpu_torch.models.deform import (  # noqa: E402
    load_flax_params, make_deform_network)
from trase_tpu_torch.models.gaussians_io import load_checkpoint  # noqa: E402
from trase_tpu_torch.ops.rasterize import RasterConfig  # noqa: E402
from trase_tpu_torch.renderer import render  # noqa: E402
from trase_tpu_torch.utils.image import psnr  # noqa: E402


@torch.no_grad()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--model", required=True)
    ap.add_argument("--iteration", type=int, required=True)
    ap.add_argument("--pairs_per_gaussian", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ds = ModelParams(source_path=os.path.abspath(args.data),
                     model_path=os.path.abspath(args.model), eval=True,
                     is_blender=True)
    scene = Scene(ds, load_iteration=args.iteration, shuffle=False,
                  device=dev)
    p, alive = scene.gaussian_params, scene.gaussian_aux.alive
    degree = int(round(np.sqrt(p.features_rest.shape[1] + 1))) - 1
    saved = load_checkpoint(os.path.join(
        ds.model_path, "deform", f"iteration_{args.iteration}", "deform.pkl"))
    net = make_deform_network(saved.get("type", "DeformNetwork"),
                              is_blender=True, device=dev)
    load_flax_params(net, saved["vars"])
    deform = T.deform_tensors(net)
    bg = torch.zeros(3, device=dev)
    cfg = RasterConfig(pairs_per_gaussian=args.pairs_per_gaussian)
    out = {"iteration": args.iteration, "n": scene.n_gaussians,
           "views": [c.image_name for c in scene.get_test_cameras()]}
    for sh in range(degree + 1):
        views = []
        for cam in scene.get_test_cameras():
            d = T.apply_deform(net, deform, p.xyz, cam.fid, 0.0, True,
                               p.gaussian_features)
            img = render(cam.to_render_camera(dev), p, alive, bg, *d,
                         sh_degree=sh, with_features=False,
                         raster_cfg=cfg)["render"]
            gt = torch.as_tensor(np.asarray(cam.image, np.float32),
                                 device=dev)
            views.append(float(psnr(torch.clamp(img, 0, 1)[None],
                                    torch.clamp(gt, 0, 1)[None]).mean()))
        out[f"sh{sh}"] = {"mean": float(np.mean(views)), "per_view": views}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
