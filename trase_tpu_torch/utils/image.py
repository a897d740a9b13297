"""Image metrics and the bilinear resize as two matrix products.

Counterpart of trase_tpu/utils/image.py: ``mse`` / ``psnr`` (:13-19,
reference utils/image_utils.py: per image, flattened over pixels,
keeping the batch dimension) and, at :54-87, ``_lerp_matrix`` /
``bilinear_resize_mm``, the FEATURE loss's resample:
torch.nn.functional.interpolate(mode="bilinear", align_corners=False,
antialias=False), the reference's feature-image resample (train.py:284),
written as two contractions against static 2-tap lerp matrices, so that
its gradient is two dense products too.
float32 products with TF32 off (trase_tpu_torch turns it off at import).
"""
from __future__ import annotations

import numpy as np
import torch


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    return ((img1 - img2) ** 2).reshape(img1.shape[0], -1).mean(
        1, keepdim=True)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    return 20 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))


def _lerp_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out_size, in_size) matrix with the two bilinear taps per row
    (align_corners=False, no antialias): W @ x is the 1-D resample."""
    dst = np.arange(out_size, dtype=np.float64)
    src = np.clip((dst + 0.5) * (in_size / out_size) - 0.5,
                  0.0, in_size - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, in_size - 1)
    f = (src - i0).astype(np.float32)
    m = np.zeros((out_size, in_size), np.float32)
    m[np.arange(out_size), i0] += 1.0 - f
    m[np.arange(out_size), i1] += f
    return m


def bilinear_resize_mm(img: torch.Tensor, out_h: int,
                       out_w: int) -> torch.Tensor:
    """(H, W, C) -> (out_h, out_w, C), channels last."""
    h, w = img.shape[:2]
    wh = torch.from_numpy(_lerp_matrix(out_h, h)).to(img.device)
    ww = torch.from_numpy(_lerp_matrix(out_w, w)).to(img.device)
    rows = torch.einsum("oh,hwc->owc", wh, img)
    return torch.einsum("pw,owc->opc", ww, rows)
