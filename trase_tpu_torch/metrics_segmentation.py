"""Segmentation metrics CLI of the port (Mask-Benchmark evaluation):
``python -m trase_tpu_torch.metrics_segmentation``.

Counterpart of the repository's root metrics_segmentation.py: per scene
and method, mIoU and mAcc of <model>/test/<method>/pred_masks against
<benchmark>/gt_masks and, unless --no_psnr, SSIM (ops/ssim.py) and PSNR
(utils/image.py) of segment_objects against gt_masks_object, on
``--device`` (cuda, the default, or cpu); writes <model>/results.json and
<model>/per_view.json as render.py's counterpart does.

LPIPS needs pretrained VGG weights and a VGG network, which the port does
not have yet: without --vgg_weights the LPIPS column is null (the "LPIPS
skipped" line, as trase_tpu prints it); with them it raises rather than
report results that differ from trase_tpu's.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch

from . import resolve_device


def compute_acc(pred: np.ndarray, gt: np.ndarray) -> float:
    return float(np.sum(pred == gt) / gt.size)


def compute_iou(pred: np.ndarray, gt: np.ndarray) -> float:
    inter = np.sum(np.logical_and(pred, gt))
    union = np.sum(np.logical_or(pred, gt))
    return float(inter / union) if union else 0.0


def read_masks(pred_dir: Path, gt_dir: Path):
    from PIL import Image

    preds, gts, names = [], [], []
    for fname in sorted(os.listdir(gt_dir)):
        try:
            with Image.open(pred_dir / fname) as pm:
                arr = np.asarray(pm)
            if arr.ndim == 3:
                arr = arr.mean(axis=-1)
            preds.append((arr / 255).astype(bool))
            with Image.open(gt_dir / fname) as gm:
                gt = np.asarray(gm)
            if gt.ndim == 3:
                gt = gt.mean(axis=-1) > 127
            else:
                gt = gt > 127 if gt.dtype == np.uint8 else gt.astype(bool)
            gts.append(gt)
            names.append(fname)
        except Exception as e:  # noqa: BLE001 — a view without its pair
            print(e)
    return preds, gts, names


def read_images(renders_dir: Path, gt_dir: Path):
    from PIL import Image

    renders, gts, names = [], [], []
    for fname in sorted(os.listdir(gt_dir)):
        try:
            with Image.open(renders_dir / fname) as r:
                renders.append(np.asarray(r.convert("RGB"), np.float32)
                               .transpose(2, 0, 1) / 255.0)
            with Image.open(gt_dir / fname) as g:
                gts.append(np.asarray(g.convert("RGB"), np.float32)
                           .transpose(2, 0, 1) / 255.0)
            names.append(fname)
        except Exception as e:  # noqa: BLE001 — a view without its pair
            print(e)
    return renders, gts, names


def evaluate(model_paths, no_psnr: bool, benchmark_path: str,
             vgg_weights: str | None = None,
             lpips_weights: str | None = None, device="cuda"):
    from .ops.ssim import ssim
    from .utils.image import psnr

    dev = resolve_device(device)
    if not no_psnr:
        if vgg_weights:
            raise NotImplementedError(
                "LPIPS is not ported yet (ROADMAP Queue 1 item 11: "
                "losses/lpips.py, models/vgg.py); run without --vgg_weights "
                "or with the root metrics_segmentation.py")
        print("[metrics] LPIPS skipped: no pretrained VGG weights "
              "(--vgg_weights)")

    full_dict, per_view = {}, {}
    for scene_dir in model_paths:
        print("Scene:", scene_dir)
        print("Benchmark:", benchmark_path)
        full_dict[scene_dir], per_view[scene_dir] = {}, {}
        test_dir = Path(scene_dir) / "test"
        benchmark_dir = Path(benchmark_path)
        for method in sorted(os.listdir(test_dir)):
            try:
                print("Method:", method)
                method_dir = test_dir / method
                preds, gts, names = read_masks(method_dir / "pred_masks",
                                               benchmark_dir / "gt_masks")
                accs = [compute_acc(p, g) for p, g in zip(preds, gts)]
                ious = [compute_iou(p, g) for p, g in zip(preds, gts)]
                print("  mIOU : {:>12.4f}".format(np.mean(ious)))
                print("  mACC : {:>12.4f}".format(np.mean(accs)))
                entry = {"mIOU": float(np.mean(ious)),
                         "mACC": float(np.mean(accs))}
                pv = {"IOU": dict(zip(names, ious)),
                      "ACC": dict(zip(names, accs))}
                if not no_psnr:
                    renders, rgts, rnames = read_images(
                        method_dir / "segment_objects",
                        benchmark_dir / "gt_masks_object")
                    ssims, psnrs = [], []
                    for r, g in zip(renders, rgts):
                        rt = torch.from_numpy(r).to(dev)
                        gt = torch.from_numpy(g).to(dev)
                        ssims.append(float(ssim(rt, gt)))
                        psnrs.append(float(psnr(rt[None], gt[None]).mean()))
                    print("  SSIM : {:>12.4f}".format(np.mean(ssims)))
                    print("  PSNR : {:>12.4f}".format(np.mean(psnrs)))
                    entry.update({
                        "SSIM": float(np.mean(ssims)) if ssims else None,
                        "PSNR": float(np.mean(psnrs)) if psnrs else None,
                        "LPIPS": None})
                    pv.update({"SSIM": dict(zip(rnames, ssims)),
                               "PSNR": dict(zip(rnames, psnrs)),
                               "LPIPS": {}})
                full_dict[scene_dir][method] = entry
                per_view[scene_dir][method] = pv
            except Exception as e:  # noqa: BLE001 — as the root CLI: report
                print(e)            # the method and go on to the next
                print("Unable to compute metrics for", method)

        with open(os.path.join(scene_dir, "results.json"), "w") as fp:
            json.dump(full_dict[scene_dir], fp, indent=True)
        with open(os.path.join(scene_dir, "per_view.json"), "w") as fp:
            json.dump(per_view[scene_dir], fp, indent=True)
    return full_dict


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Segmentation metrics parameters")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+",
                        type=str, default=[])
    parser.add_argument("--no_psnr", action="store_true")
    parser.add_argument("--benchmark_path", type=str)
    parser.add_argument("--vgg_weights", type=str, default=None)
    parser.add_argument("--lpips_weights", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card, default) or cpu")
    args = parser.parse_args(argv)
    return evaluate(args.model_paths, args.no_psnr, args.benchmark_path,
                    args.vgg_weights, args.lpips_weights, args.device)


if __name__ == "__main__":
    main()
