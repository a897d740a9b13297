"""Grounded-SAM text-prompt bridge (optional external networks).

Behavioral contract: ext/grounded_sam.py in the reference — given a
text phrase and an RGB render, GroundingDINO predicts boxes for the
phrase (box_threshold=0.3, text_threshold=0.45), SAM segments each box,
and the union of masks is returned as one boolean (H, W) mask
(reference :59-100). `select_obj_ioa` picks the classes whose
intersection-over-area with that mask exceeds a threshold (:103-116).

GroundingDINO / segment-anything are torch packages with their own
CUDA ops, optional here: everything is imported where it is used, and a
call raises ImportError naming the missing package when they are absent.
The port's callers (render.py's --text_prompt, the viewer's
text_select) then fall back to precomputed mask files or raise. The
networks run on the device the caller passes; nothing here picks the
CPU on its own.
"""
from __future__ import annotations

import numpy as np

_CKPT_REPO = "ShilongLiu/GroundingDINO"
_CKPT_FILE = "groundingdino_swinb_cogcoor.pth"
_CKPT_CONFIG = "GroundingDINO_SwinB.cfg.py"

_models: dict = {}


def _load_models(sam_checkpoint: str | None, device):
    """HF-hub GroundingDINO + SAM load (reference :29-41) onto `device`.
    Cached per (checkpoint, device): trase_tpu's single cache returns the
    first call's models whatever a later call asks for."""
    device = str(device)
    key = (sam_checkpoint, device)
    if key in _models:
        return _models[key]
    import torch
    from groundingdino.models import build_model
    from groundingdino.util.slconfig import SLConfig
    from groundingdino.util.utils import clean_state_dict
    from huggingface_hub import hf_hub_download
    from segment_anything import SamPredictor, build_sam

    cfg_path = hf_hub_download(repo_id=_CKPT_REPO, filename=_CKPT_CONFIG)
    gd_args = SLConfig.fromfile(cfg_path)
    gd_args.device = device
    model = build_model(gd_args)
    ckpt_path = hf_hub_download(repo_id=_CKPT_REPO, filename=_CKPT_FILE)
    ckpt = torch.load(ckpt_path, map_location="cpu")
    model.load_state_dict(clean_state_dict(ckpt["model"]), strict=False)
    model.eval()

    sam_checkpoint = sam_checkpoint or "dependency/sam_vit_h_4b8939.pth"
    sam = SamPredictor(build_sam(checkpoint=sam_checkpoint).to(device))
    _models[key] = (model, sam, device)
    return _models[key]


def grounded_sam_mask(
    text: str,
    image_chw: np.ndarray,
    box_threshold: float = 0.3,
    text_threshold: float = 0.45,
    sam_checkpoint: str | None = None,
    *,
    device,
) -> np.ndarray:
    """Text phrase + (3, H, W) float image in [0,1] -> (H, W) bool mask.

    Union of SAM masks over all GroundingDINO boxes for the phrase
    (reference grouned_sam_output, :59-100), the networks on `device`
    (the caller's: "cuda" or "cpu").
    """
    import torch
    from groundingdino.util import box_ops
    from groundingdino.util.inference import predict
    import groundingdino.datasets.transforms as T
    from PIL import Image

    model, sam, dev = _load_models(sam_checkpoint, device)

    img_hwc = (np.clip(np.asarray(image_chw), 0, 1) * 255).astype(
        np.uint8).transpose(1, 2, 0)
    transform = T.Compose([
        T.RandomResize([800], max_size=1333),
        T.ToTensor(),
        T.Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
    ])
    timg, _ = transform(Image.fromarray(img_hwc), None)
    boxes, logits, phrases = predict(
        model=model, image=timg, caption=text,
        box_threshold=box_threshold, text_threshold=text_threshold,
        device=dev,
    )
    H, W, _ = img_hwc.shape
    sam.set_image(img_hwc)
    boxes_xyxy = box_ops.box_cxcywh_to_xyxy(boxes) * torch.tensor(
        [W, H, W, H], dtype=boxes.dtype)
    if len(boxes_xyxy) == 0:
        return np.zeros((H, W), bool)
    tb = sam.transform.apply_boxes_torch(boxes_xyxy, (H, W)).to(dev)
    masks, _, _ = sam.predict_torch(
        point_coords=None, point_labels=None, boxes=tb,
        multimask_output=False,
    )
    return np.asarray(masks.sum(dim=0).squeeze(0).cpu().numpy()) > 0


def text_prompt_mask(text: str, image_chw: np.ndarray, device) -> np.ndarray:
    """render.py's entry: grounded_sam_mask with its default thresholds."""
    return grounded_sam_mask(text, image_chw, device=device)


def select_obj_ioa(classification_map: np.ndarray, mask: np.ndarray,
                   ioa_thresh: float = 0.7) -> list:
    """Class ids whose intersection-over-area with `mask` exceeds the
    threshold (reference :103-116). Pure numpy."""
    out = []
    cm = np.asarray(classification_map)
    m = np.asarray(mask).astype(np.int64)
    for cid in np.unique(cm):
        cls_mask = (cm == cid).astype(np.int64)
        area = cls_mask.sum()
        if area == 0:
            continue
        if (cls_mask * m).sum() / area > ioa_thresh:
            out.append(int(cid))
    return out
