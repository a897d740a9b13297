"""SAM-mask contrastive feature losses of the FEATURE step.

Counterpart of trase_tpu/losses/contrastive.py (reference
utils/feature_utils.py and utils/loss_utils.py:274-406): a fixed-size
sample of pixels drawn from the union of the SAM masks and of masks, the
(P, P) pixel-mask correspondence matrix, the cosine gram of the rendered
features at the sampled pixels, mask-size pixel-pair weights, and the
hard / all / soft positive and negative pair losses. Every (P, P)
quantity carries the pair-validity mask, so padded sample slots count
nowhere.

The sample is drawn from a ``torch.Generator``; its numbers differ from
trase_tpu's jax.random draw by design, so a test injects trase_tpu's
sample (``PixelSample``) instead.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class PixelSample(NamedTuple):
    pixel_idx: torch.Tensor  # (P,) int64 flat indices into H*W
    pixel_valid: torch.Tensor  # (P,) bool
    mask_sel: torch.Tensor  # (M,) bool: which SAM masks participate


def sample_pixels_and_masks(generator: torch.Generator,
                            sam_masks: torch.Tensor,
                            mask_valid: torch.Tensor,
                            num_sampled_pixels: int,
                            num_sampled_masks: int) -> PixelSample:
    """Exactly `num_sampled_pixels` pixels drawn uniformly without
    replacement from the union of the masks (random-score top-k; slots
    past the union's size are invalid), and each real mask selected with
    probability num_sampled_masks / #masks (get_sample_pixel_and_mask,
    utils/feature_utils.py:17-26). sam_masks: (M, H, W), padding masks
    all zero; mask_valid: (M,) bool."""
    m, h, w = sam_masks.shape
    dev = sam_masks.device
    in_any = (sam_masks.sum(dim=0) > 0).reshape(-1)
    scores = torch.rand(h * w, generator=generator, device=dev)
    scores = torch.where(in_any, scores,
                         torch.full_like(scores, float("inf")))
    neg_top, pixel_idx = torch.topk(-scores, num_sampled_pixels)
    mask_rate = num_sampled_masks / torch.clamp(mask_valid.sum(), min=1)
    mask_sel = (torch.rand(m, generator=generator, device=dev)
                < mask_rate) & mask_valid
    return PixelSample(pixel_idx=pixel_idx,
                       pixel_valid=torch.isfinite(-neg_top),
                       mask_sel=mask_sel)


def pixel_mask_correspondence_matrix(sam_masks: torch.Tensor,
                                     sample: PixelSample) -> torch.Tensor:
    """C[h, j] = 1 iff some selected mask holds both sampled pixels
    (utils/feature_utils.py:40-48)."""
    m = sam_masks.shape[0]
    v = sam_masks.reshape(m, -1)[:, sample.pixel_idx].to(torch.float32)
    v = v * sample.mask_sel[:, None].to(torch.float32)
    return ((v.T @ v) != 0).to(torch.float32)


def cosine_gram(s: torch.Tensor) -> torch.Tensor:
    """Cosine gram of the (P, F) features at the sampled pixels, the
    features correspondence matrix (utils/feature_utils.py:50-56)."""
    # safe normalize: sample slots can land on zero-feature background
    n = torch.sqrt(torch.sum(s * s, dim=-1, keepdim=True) + 1e-12)
    s = s / n
    return s @ s.T


def pixel_weights(sam_masks: torch.Tensor,
                  sample: PixelSample) -> torch.Tensor:
    """Mask-size-balanced per-pair weights in [1, 10]
    (utils/feature_utils.py:28-38)."""
    m = sam_masks.shape[0]
    flat = sam_masks.to(torch.float32).reshape(m, -1)
    sizes = flat.sum(dim=1)
    per_pixel_size_sum = (flat * sizes[:, None]).sum(dim=0)
    per_pixel_count = flat.sum(dim=0)
    mean_size = (per_pixel_size_sum / (per_pixel_count + 1e-9))[
        sample.pixel_idx]
    ptp = mean_size[None, :] * mean_size[:, None]
    ptp_max = ptp.max()
    ptp = torch.where(ptp == 0, torch.full_like(ptp, 1e10), ptp)
    wgt = torch.clamp(ptp_max / ptp, min=1.0)
    return (wgt - wgt.min()) / (wgt.max() - wgt.min() + 1e-12) * 9.0 + 1.0


def _pair_masks(C: torch.Tensor, sample: PixelSample) -> torch.Tensor:
    """Valid pairs above the diagonal."""
    valid = sample.pixel_valid
    triu = torch.ones(C.shape, dtype=torch.bool, device=C.device).triu(1)
    return valid[:, None] & valid[None, :] & triu


def _masked_loss(values, select, count, weights, mode_mean: bool):
    """Sum of values over `select`, over |select| ("hard") or |count|
    ("all", "soft": the reference's number_of_all_pixel_pair); 0 when
    nothing is selected."""
    if weights is not None:
        values = values * weights
    num = torch.where(select, values, torch.zeros_like(values)).sum()
    denom = select.sum() if mode_mean else count.sum()
    loss = num / torch.clamp(denom, min=1)
    return torch.where(select.sum() == 0, torch.zeros_like(loss), loss)


def positive_loss_all(C, C_F, sample, positive_th=0.75, weights=None):
    count = _pair_masks(C, sample) & torch.any(C == 1, dim=0)[None, :]
    return _masked_loss(-C_F, count & (C == 1), count, weights, False)


def negative_loss_all(C, C_F, sample, negative_th=0.5, weights=None):
    count = _pair_masks(C, sample) & torch.any(C == 0, dim=0)[None, :]
    return _masked_loss(torch.relu(C_F), count & (C == 0), count, weights,
                        False)


def positive_loss_soft(C, C_F, sample, positive_th=0.75, weights=None):
    col = torch.any((C_F < positive_th) & (C == 1), dim=0)
    count = _pair_masks(C, sample) & col[None, :]
    return _masked_loss(-C_F, count & (C == 1), count, weights, False)


def negative_loss_soft(C, C_F, sample, negative_th=0.5, weights=None):
    col = torch.any((C_F > negative_th) & (C == 0), dim=0)
    count = _pair_masks(C, sample) & col[None, :]
    return _masked_loss(torch.relu(C_F), count & (C == 0), count, weights,
                        False)


def positive_loss_hard(C, C_F, sample, positive_th=0.75, weights=None):
    select = _pair_masks(C, sample) & (C_F < positive_th) & (C == 1)
    return _masked_loss(-C_F, select, select, weights, True)


def negative_loss_hard(C, C_F, sample, negative_th=0.5, weights=None):
    select = _pair_masks(C, sample) & (C_F > negative_th) & (C == 0)
    return _masked_loss(torch.relu(C_F), select, select, weights, True)


positive_pixel_pair_loss = {
    "hard": positive_loss_hard,
    "all": positive_loss_all,
    "soft": positive_loss_soft,
}

negative_pixel_pair_loss = {
    "hard": negative_loss_hard,
    "all": negative_loss_all,
    "soft": negative_loss_soft,
}
