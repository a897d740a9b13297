"""Windowed SSIM in torch.

Counterpart of trase_tpu/ops/ssim.py (reference utils/loss_utils.py:
46-86): 11x11 gaussian window, sigma 1.5, SAME zero padding,
C1 = 0.01^2, C2 = 0.03^2. On the card the window is one depthwise
``F.conv2d`` (cuDNN), which trase_tpu_torch/__init__.py keeps out of
TF32; trase_tpu applies the same window as separable shifted adds, so
the two agree up to float association.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def gaussian_window(window_size: int = 11, sigma: float = 1.5,
                    device=None) -> torch.Tensor:
    g = torch.tensor([math.exp(-((x - window_size // 2) ** 2)
                               / (2 * sigma ** 2))
                      for x in range(window_size)], dtype=torch.float64)
    g = (g / g.sum()).to(torch.float32)
    return torch.outer(g, g).to(device)


def _depthwise_conv(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    c = img.shape[0]
    k = window.shape[0]
    w = window.expand(c, 1, k, k)
    return F.conv2d(img[None], w, padding=k // 2, groups=c)[0]


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """SSIM over (C,H,W) images in [0,1]."""
    window = gaussian_window(window_size, device=img1.device)
    mu1 = _depthwise_conv(img1, window)
    mu2 = _depthwise_conv(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_conv(img1 * img1, window) - mu1_sq
    sigma2_sq = _depthwise_conv(img2 * img2, window) - mu2_sq
    sigma12 = _depthwise_conv(img1 * img2, window) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.reshape(ssim_map.shape[0], -1).mean(1)
