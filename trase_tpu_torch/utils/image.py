"""Image metrics and the bilinear resize as two matrix products.

Counterpart of trase_tpu/utils/image.py: ``mse`` / ``psnr`` (:13-19,
reference utils/image_utils.py: per image, flattened over pixels,
keeping the batch dimension) and, at :54-87, ``_lerp_matrix`` /
``bilinear_resize_mm``, the FEATURE loss's resample:
torch.nn.functional.interpolate(mode="bilinear", align_corners=False,
antialias=False), the reference's feature-image resample (train.py:284),
written as two contractions against static 2-tap lerp matrices, so that
its gradient is two dense products too. ``bilinear_sample_flat``
(:90-123) gathers the same resample's four taps at sampled pixels only,
as the multi-device FEATURE step reads it (parallel/sharded.py).
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


def _bilinear_taps(dst: torch.Tensor, in_size: int, out_size: int):
    """Source taps (i0, i1, frac) for output coordinates `dst` under the
    align_corners=False convention (the same formula as _lerp_matrix, in
    float32 as trase_tpu computes it)."""
    src = torch.clamp((dst.to(torch.float32) + 0.5) * (in_size / out_size)
                      - 0.5, 0.0, in_size - 1)
    i0 = torch.floor(src).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=in_size - 1)
    return i0, i1, src - i0


def bilinear_sample_flat(img: torch.Tensor, pixel_idx: torch.Tensor,
                         out_h: int, out_w: int) -> torch.Tensor:
    """Rows `pixel_idx` of ``bilinear_resize_mm(img, out_h, out_w)
    .reshape(-1, C)`` without the resized image: the four taps of each
    sampled pixel, lerped in the same association. img: (H, W, C);
    pixel_idx: (P,) flat indices into the (out_h, out_w) grid. Returns
    (P, C)."""
    h, w = img.shape[:2]
    y0, y1, wy = _bilinear_taps(torch.div(pixel_idx, out_w,
                                          rounding_mode="floor"), h, out_h)
    x0, x1, wx = _bilinear_taps(pixel_idx % out_w, w, out_w)
    wy = wy[:, None]
    wx = wx[:, None]
    r0 = img[y0, x0] * (1.0 - wy) + img[y1, x0] * wy
    r1 = img[y0, x1] * (1.0 - wy) + img[y1, x1] * wy
    return r0 * (1.0 - wx) + r1 * wx
