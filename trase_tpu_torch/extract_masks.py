"""SAM mask extraction CLI.

Behavioral contract: extract_masks.py in the reference —
SamAutomaticMaskGenerator (points_per_side=32, pred_iou_thresh=0.88,
box_nms_thresh=0.7, stability_score_thresh=0.95, min_mask_region_area=
100, reference :51-60) over every image in --img_path, masks saved per
image under <output>/masks/ (:87-99).

segment_anything is an optional import (absent, the SAM path exits with
a message naming the two other paths). Two extra ingestion paths keep
the tool usable without it:

- --from_dir <dir>: convert per-image mask stacks that already exist
  (PNG label maps where each gray level is one object, or per-image
  subdirectories of binary PNGs) into the native format;
- --from_pt <dir>: convert reference bitarray-dict .pt masks.

Output formats: native bit-packed .npz (default; data/masks.py) or the
reference's torch .pt bitarray dict with --save_pt (needs torch +
bitarray; falls back to a tensor payload without bitarray).

The port's CLI (counterpart of the repository root's extract_masks.py,
the same flags and outputs; the SAM network runs on --device, the card
unless the caller asks for the CPU):

    python -m trase_tpu_torch.extract_masks --output <scene> \
        (--from_dir <dir> | --from_pt <dir> | --img_path <images>)
        [--save_pt | --save_to_tensor] [--device cuda]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def _iter_images(img_path):
    exts = (".png", ".jpg", ".jpeg", ".bmp")
    for name in sorted(os.listdir(img_path)):
        if name.lower().endswith(exts):
            yield name


def extract_sam(args, out_dir):
    from segment_anything import (
        SamAutomaticMaskGenerator, sam_model_registry,
    )

    from . import resolve_device

    device = resolve_device(args.device)
    sam = sam_model_registry[args.sam_arch](
        checkpoint=args.sam_checkpoint_path).to(device)
    gen = SamAutomaticMaskGenerator(
        model=sam,
        points_per_side=32,
        pred_iou_thresh=args.iou_th,
        box_nms_thresh=0.7,
        stability_score_thresh=args.stability_score_th,
        crop_n_layers=0,
        crop_n_points_downscale_factor=1,
        min_mask_region_area=100,
    )
    from PIL import Image
    from tqdm import tqdm

    for name in tqdm(list(_iter_images(args.img_path))):
        stem = name.split(".")[0]
        with Image.open(os.path.join(args.img_path, name)) as im:
            img = np.asarray(im.convert("RGB"))
        if args.downsample_mask != 1:
            d = args.downsample_mask
            img = np.asarray(Image.fromarray(img).resize(
                (img.shape[1] // d, img.shape[0] // d)))
        raw = gen.generate(img)
        stack = [m["segmentation"] for m in raw
                 if np.unique(m["segmentation"]).size >= 2]
        if not stack:
            print(f"[warn] no masks for {name}")
            continue
        _save(np.stack(stack).astype(bool), out_dir, stem, args)


def convert_from_dir(args, out_dir):
    """PNG label maps (or subdirs of binary PNGs) -> native masks."""
    from PIL import Image

    src = args.from_dir
    for name in sorted(os.listdir(src)):
        p = os.path.join(src, name)
        stem = name.split(".")[0]
        if os.path.isdir(p):
            stack = []
            for f in sorted(os.listdir(p)):
                with Image.open(os.path.join(p, f)) as im:
                    stack.append(np.asarray(im.convert("L")) > 127)
            if stack:
                _save(np.stack(stack), out_dir, stem, args)
        elif name.lower().endswith(".png"):
            with Image.open(p) as im:
                label = np.asarray(im.convert("L"))
            vals = [v for v in np.unique(label) if v != 0]
            if not vals:
                continue
            _save(np.stack([label == v for v in vals]), out_dir, stem,
                  args)


def convert_from_pt(args, out_dir):
    """Reference bitarray-dict .pt -> native .npz."""
    from .data.masks import decode_mask_file

    for name in sorted(os.listdir(args.from_pt)):
        if not name.endswith(".pt"):
            continue
        masks = decode_mask_file(os.path.join(args.from_pt, name))
        if masks is not None:
            _save(masks, out_dir, name[:-3], args)


def _save(masks: np.ndarray, out_dir: str, stem: str, args):
    from .data.masks import save_mask_file

    if args.save_pt or args.save_to_tensor:
        import torch

        n, h, w = masks.shape
        if args.save_to_tensor:
            # reference extract_masks.py:87-89: raw bool (N,H,W) tensor
            payload = torch.from_numpy(masks.astype(bool))
            torch.save(payload, os.path.join(out_dir, stem + ".pt"))
            return
        try:
            from bitarray import bitarray

            payload = {"masks": bitarray(
                masks.reshape(-1).astype(np.uint8).tolist()),
                "N": n, "H": h, "W": w}
        except ImportError:
            payload = {"masks": torch.from_numpy(
                masks.reshape(-1).astype(np.uint8)), "N": n, "H": h,
                "W": w}
        torch.save(payload, os.path.join(out_dir, stem + ".pt"))
    else:
        save_mask_file(os.path.join(out_dir, stem + ".npz"), masks)


def main(argv=None):
    p = argparse.ArgumentParser(description="Extract / convert SAM masks")
    p.add_argument("--img_path", type=str, default=None)
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--sam_checkpoint_path", type=str,
                   default="dependency/sam_vit_h_4b8939.pth")
    p.add_argument("--sam_arch", type=str, default="vit_h")
    p.add_argument("--iou_th", type=float, default=0.88)
    p.add_argument("--stability_score_th", type=float, default=0.95)
    p.add_argument("--downsample_mask", type=int, default=1)
    p.add_argument("--save_pt", action="store_true",
                   help="write reference-format .pt instead of .npz")
    p.add_argument("--save_to_tensor", action="store_true",
                   default=False,
                   help="raw bool tensor .pt (reference "
                        "extract_masks.py:43,87-89) instead of the "
                        "bitarray dict")
    p.add_argument("--from_dir", type=str, default=None,
                   help="convert existing PNG masks instead of running SAM")
    p.add_argument("--from_pt", type=str, default=None,
                   help="convert reference .pt masks to native .npz")
    p.add_argument("--device", type=str, default="cuda",
                   help="where SAM runs (cuda, or cpu when asked for)")
    args = p.parse_args(argv)

    out_dir = os.path.join(args.output, "masks")
    os.makedirs(out_dir, exist_ok=True)

    if args.from_dir:
        convert_from_dir(args, out_dir)
    elif args.from_pt:
        convert_from_pt(args, out_dir)
    else:
        if args.img_path is None:
            raise SystemExit("--img_path required for SAM extraction")
        try:
            extract_sam(args, out_dir)
        except ImportError as e:
            raise SystemExit(
                f"segment_anything unavailable ({e}); use --from_dir / "
                "--from_pt to convert precomputed masks") from e
    print(f"masks written to {out_dir}")


if __name__ == "__main__":
    main()
