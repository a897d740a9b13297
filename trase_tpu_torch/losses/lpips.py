"""LPIPS perceptual metric (VGG16 backbone).

Counterpart of trase_tpu/losses/lpips.py (reference lpipsPyTorch/, LPIPS
v0.1): VGG16 activations at relu{1_2,2_2,3_3,4_3,5_3} of the input
scaled by the LPIPS shift and scale (not the ImageNet stats), each unit-
normalized over channels with eps outside the sqrt, squared differences
weighted by non-negative 1x1 linear heads, the spatial mean, summed over
layers.

``make_lpips`` needs a VGG weight file (torchvision vgg16 state_dict or
.npz); without one it returns None and callers skip the metric. The
linear heads come from the official LPIPS ``vgg.pth`` (``lin{i}`` or
``lins.{i}`` keys) or an .npz of ``lin0``..``lin4``; without them the
heads are uniform and a warning says the values are not calibrated LPIPS.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from ..models.vgg import VGG16_BLOCKS, VGGFeatureExtractor, load_vgg_weights

# post-ReLU activations of conv{1_2,2_2,3_3,4_3,5_3} (the reference's
# 1-based feature-module indices [4, 9, 16, 23, 30])
_LPIPS_LAYERS = ["relu1_2", "relu2_2", "relu3_3", "relu4_3", "relu5_3"]
_LPIPS_CHANNELS = [64, 128, 256, 512, 512]

# LPIPS v0.1 scaling layer (reference networks.py:41-44), applied to the
# [0, 1] inputs as given
_LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def load_lin_weights(path: str | None):
    """LPIPS linear-head weights as 5 float32 vectors: official .pth
    ('lin{i}.model.1.weight' or 'lins.{i}.model.1.weight') or .npz
    ('lin0'..'lin4'); None when missing or incomplete."""
    if not path or not os.path.exists(path):
        return None
    if path.endswith(".npz"):
        z = np.load(path)
        if not all(f"lin{i}" in z.files for i in range(5)):
            return None
        return [np.asarray(z[f"lin{i}"], np.float32) for i in range(5)]
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = []
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in sd:
                out.append(np.asarray(sd[key], np.float32)[:, :, 0, 0][0])
                break
        else:
            return None
    return out


def make_lpips(vgg_weights: str | None, lin_weights: str | None = None,
               device="cuda"):
    """lpips(img1, img2) -> 0-d tensor on `device`, or None without VGG
    weights. img1 / img2: (3, H, W) or (N, 3, H, W) in [0, 1]."""
    weights = load_vgg_weights(vgg_weights) if vgg_weights else None
    if weights is None:
        return None
    dev = resolve_device(device)
    fx = VGGFeatureExtractor(_LPIPS_LAYERS, VGG16_BLOCKS, weights,
                             normalization=(_LPIPS_SHIFT, _LPIPS_SCALE),
                             device=dev)
    lins = load_lin_weights(lin_weights)
    if lins is None:
        print("[lpips] WARNING: no linear-head weights — using uniform "
              "heads. Reported values are a VGG perceptual distance, "
              "NOT calibrated LPIPS v0.1; do not compare against "
              "published LPIPS numbers (pass --lpips_weights).")
        lins = [np.full(c, 1.0 / c, np.float32) for c in _LPIPS_CHANNELS]
    lins = [torch.tensor(w, device=dev) for w in lins]

    def lpips(img1, img2):
        f1 = fx(img1)
        f2 = fx(img2)
        total = 0.0
        for name, w in zip(_LPIPS_LAYERS, lins):
            a, b = f1[name], f2[name]
            # reference normalize_activation: eps OUTSIDE the sqrt
            a = a / (torch.sqrt(torch.sum(a * a, 1, keepdim=True)) + 1e-10)
            b = b / (torch.sqrt(torch.sum(b * b, 1, keepdim=True)) + 1e-10)
            d = (a - b) ** 2  # (N, C, H, W)
            total = total + torch.einsum("nchw,c->n", d, w) / (
                d.shape[2] * d.shape[3])
        return total.mean()

    return lpips
