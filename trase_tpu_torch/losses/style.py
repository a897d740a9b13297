"""Style-transfer losses.

Counterpart of trase_tpu/losses/style.py (reference
utils/loss_utils.py:223-272): nearest-neighbour feature matching (NNFM)
on VGG feature maps, and the gram / AdaIN / MSE content losses.
"""
from __future__ import annotations

import torch


def loss_nnfm_style(feat1: torch.Tensor, feat2: torch.Tensor) -> torch.Tensor:
    """For each column of feat1 the least cosine distance to any column
    of feat2, averaged. feat1 / feat2: (C, N1) / (C, N2).

    The column max is `amax`, whose gradient splits evenly between tied
    entries as jnp.max's does (`.max(dim=)` gives it all to one): a style
    image with flat regions has identical feature columns."""
    f1 = feat1 / (torch.linalg.vector_norm(feat1, dim=0, keepdim=True)
                  + 1e-12)
    f2 = feat2 / (torch.linalg.vector_norm(feat2, dim=0, keepdim=True)
                  + 1e-12)
    sim = torch.matmul(f1.T, f2)  # (N1, N2)
    return (1.0 - sim.amax(dim=1)).mean()


def _mean_std(x, eps=1e-8):
    """Channel-wise instance stats of (N, C, ...), the std with ddof 1."""
    flat = x.reshape(x.shape[0], x.shape[1], -1)
    mean = flat.mean(-1, keepdim=True)
    std = flat.std(-1, correction=1, keepdim=True) + eps
    return mean, std


def gram_matrix(t: torch.Tensor) -> torch.Tensor:
    b, d, h, w = t.shape
    flat = t.reshape(d, h * w)
    return flat @ flat.T


def adain_style_loss(x, y):
    xm, xs = _mean_std(x)
    ym, ys = _mean_std(y)
    return ((xm - ym) ** 2).mean() + ((xs - ys) ** 2).mean()


def style_loss_gram(target, style, weight):
    _, d, h, w = target.shape
    tg, sg = gram_matrix(target), gram_matrix(style)
    return weight * ((tg - sg) ** 2).mean() / (d * h * w)


def mse_content_loss(x, y):
    return ((x - y) ** 2).mean()
