"""NNFM style-transfer fine-tuning CLI of the port:
``python -m trase_tpu_torch.train_style_transfer_nnfm``.

Counterpart of the root train_style_transfer_nnfm.py, flag for flag with
its defaults, plus ``--device`` (cuda, the default, or cpu). It loads a
trained scene (``--load_iteration N``: point_cloud/iteration_N, the
deform net from deform/iteration_N/deform.pkl and the segmentation from
point_cloud/iteration_N/clusters.pt), selects the gaussians of
``--segment_ids`` (the whole scene, with a warning, when the ids match
none), and optimizes only their SH colours (features_dc, features_rest)
against ``--reference_img_path`` with the NNFM loss on VGG16 conv4_1
features (engine/trainer.py: style_phase_step). The views are drawn from
``np.random.default_rng(0)`` popping a view stack, as the root CLI
draws them. Snapshots at ``--save_iterations`` and at the last
iteration are what render.py (root and port) reads.

As in the root CLI, the densification statistics accumulate and nothing
reads them: the loop does not densify. ``--vgg_weights`` takes a
torchvision VGG16 .pth or an .npz; without it the seeded random VGG16 of
models/vgg.py is used (both packages draw the same one).
``--detect_anomaly`` (or ``--debug_from 0``) turns on
``torch.autograd.set_detect_anomaly``; ``--debug_from N`` from iteration
N + 1 on.
"""
from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np
import torch

from .config import ModelParams, OptimizationParams, PipelineParams, save_cfg

FX_KEY = "conv4_1"


def make_parser() -> argparse.ArgumentParser:
    """The root train_style_transfer_nnfm.py's parser (:24-49), flag for
    flag and default for default, plus --device."""
    parser = argparse.ArgumentParser(
        description="Style transfer training parameters")
    ModelParams.add_to_parser(parser)
    OptimizationParams.add_to_parser(parser)
    PipelineParams.add_to_parser(parser)
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[1_000, 7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[1_000, 7_000, 30_000, 60_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--load_iteration", type=int, default=-1)
    parser.add_argument("--segment_ids", type=int, nargs="+", default=[-1])
    parser.add_argument("--reference_img_path", type=str, required=True)
    parser.add_argument("--vgg_weights", type=str, default=None)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true",
                        default=False)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card, default) or cpu")
    return parser


def style_mask_from_clusters(cl_path: str, capacity: int, segment_ids,
                             alive: torch.Tensor) -> torch.Tensor:
    """(capacity,) bool on alive's device: the gaussians whose cluster id
    is one of `segment_ids` (gaussian_model.py:146-153); every alive
    gaussian, with a warning, when none matches."""
    from .cluster import load_clusters

    ids, _rgb = load_clusters(cl_path)
    full_ids = np.full(capacity, -999, np.int64)
    full_ids[: len(ids)] = ids
    mask = np.zeros(capacity, bool)
    for sid in segment_ids:
        mask |= full_ids == sid
    if not mask.any():
        print("[style] WARNING: selected segment_ids match no gaussians; "
              "styling the whole scene")
        return alive.clone()
    return torch.from_numpy(mask).to(alive.device)


def main(argv=None):
    parser = make_parser()
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    args.save_iterations.append(args.iterations)

    if args.load_iteration == -1:
        print("[ERROR] Please load a pretrained scene!!!")
        return None

    # the reference's safe_state: the camera shuffle (python's random)
    # repeats from run to run
    random.seed(0)
    np.random.seed(0)
    torch.manual_seed(0)

    from . import resolve_device

    device = resolve_device(args.device)
    dataset = ModelParams.extract(args)
    opt = OptimizationParams.extract(args)
    pipe = PipelineParams.extract(args)
    save_cfg(dataset.model_path, args)

    from PIL import Image

    from .data.scene import Scene
    from .engine import trainer as T
    from .engine.loop import Trainer
    from .models.deform import load_flax_params
    from .models.gaussians_io import load_checkpoint
    from .models.vgg import make_vgg16_extractor
    from .ops.rasterize import RasterConfig

    scene = Scene(dataset, load_iteration=args.load_iteration, shuffle=True,
                  device=device)
    trainer = Trainer(dataset, opt, pipe, scene, raster_cfg=RasterConfig(),
                      device=device)

    # deform weights from the trained snapshot
    deform_path = os.path.join(dataset.model_path, "deform",
                               f"iteration_{scene.loaded_iter}",
                               "deform.pkl")
    if os.path.exists(deform_path):
        load_flax_params(trainer.deform_net,
                         load_checkpoint(deform_path)["vars"])
        trainer.state = trainer.state._replace(
            deform=T.deform_tensors(trainer.deform_net))

    state = trainer.state
    style_mask = style_mask_from_clusters(
        os.path.join(dataset.model_path, "point_cloud",
                     f"iteration_{scene.loaded_iter}", "clusters.pt"),
        state.params.xyz.shape[0], args.segment_ids, state.aux.alive)

    # the style image's features, computed once; normalized outside the
    # extractor and inside it, as the reference does
    vgg = make_vgg16_extractor([FX_KEY], args.vgg_weights, device=device)
    with Image.open(args.reference_img_path) as im:
        ref = np.asarray(im.convert("RGB"), np.float32) / 255.0
    with torch.no_grad():
        ref_chw = torch.from_numpy(ref.transpose(2, 0, 1).copy()).to(device)
        ref_feats = vgg(vgg.normalize(ref_chw))[FX_KEY][0]
        ref_feats = ref_feats.reshape(ref_feats.shape[0], -1)

    trainer.active_sh_degree = trainer.max_sh_degree
    train_cams = scene.get_train_cameras()
    np_rng = np.random.default_rng(0)
    stack = []
    save_at = set(args.save_iterations)

    first_iter = args.load_iteration
    bar = None
    if not args.quiet:
        try:
            from tqdm import tqdm

            bar = tqdm(range(first_iter, opt.iterations),
                       desc="Style transfer")
        except ImportError:
            pass
    # the loss EMA stays on the device; the host reads it every 10 steps
    ema = torch.zeros((), device=device)
    anomaly = torch.is_anomaly_enabled()
    if args.detect_anomaly or args.debug_from == 0:
        torch.autograd.set_detect_anomaly(True)
    try:
        for iteration in range(first_iter + 1, opt.iterations + 1):
            if iteration - 1 == args.debug_from and args.debug_from > 0:
                torch.autograd.set_detect_anomaly(True)
            if not stack:
                stack = list(train_cams)
            cam = stack.pop(int(np_rng.integers(0, len(stack))))
            trainer.state, metrics = T.style_phase_step(
                trainer.state, cam.to_render_camera(device), ref_feats,
                style_mask, cam.fid, trainer.lr_at(iteration),
                trainer.bg_color, deform_net=trainer.deform_net,
                vgg_ext=vgg, sh_degree=trainer.active_sh_degree,
                use_deform=True, is_6dof=dataset.is_6dof, fx_key=FX_KEY,
                raster_cfg=trainer.raster_cfg)
            ema = torch.where(metrics["finite"],
                              0.4 * metrics["loss"] + 0.6 * ema, ema)
            if iteration % 10 == 0 and bar is not None:
                bar.set_postfix({"Loss": f"{float(ema):.3f}"})
                bar.update(10)
            if iteration in save_at:
                trainer.save_snapshot(iteration)
    finally:
        torch.autograd.set_detect_anomaly(anomaly)
        if bar is not None:
            bar.close()
    trainer.ema_loss = float(ema)
    print("\nTraining complete.")
    return trainer


if __name__ == "__main__":
    main()
