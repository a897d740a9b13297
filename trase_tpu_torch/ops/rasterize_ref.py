"""Slow-but-obvious reference compositor: O(N * H * W), plain torch.

Counterpart of trase_tpu/ops/rasterize_ref.py — the correctness oracle
for the tiled compositor, for tests at small sizes. Per pixel, gaussians
sorted front-to-back by view depth, alpha = min(0.99, opacity *
exp(-0.5 d^T conic d)), contributions skipped below 1/255, termination
when transmittance would drop below 1e-4, background blended with the
residual transmittance (RGB only). Pixel centres are the integer (x, y).
"""
from __future__ import annotations

import torch

from .projection import ALPHA_EPS, ProjectedGaussians

T_EPS = 1e-4
ALPHA_MAX = 0.99


def composite_weights(alphas: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Front-to-back compositing weights from per-sample alphas ordered
    along `dim`: w_i = alpha_i * prod_{j<i}(1 - alpha_j), with samples
    below 1/255 skipped and a sticky stop once T * (1 - alpha) < 1e-4."""
    alphas = torch.where(alphas < ALPHA_EPS, torch.zeros_like(alphas), alphas)
    one_minus = 1.0 - alphas
    T = torch.cumprod(one_minus, dim=dim)
    T = torch.cat([torch.ones_like(T.narrow(dim, 0, 1)),
                   T.narrow(dim, 0, T.shape[dim] - 1)], dim=dim)
    done = (T * one_minus < T_EPS) & (alphas > 0.0)
    sticky_done = torch.cumsum(done.to(torch.int32), dim=dim) > 0
    return torch.where(sticky_done, torch.zeros_like(alphas), alphas * T)


def rasterize_reference(
    proj: ProjectedGaussians,
    extra_channels: torch.Tensor | None,
    bg_color: torch.Tensor,
    image_height: int,
    image_width: int,
):
    """Composite all gaussians against every pixel. Returns render
    (3,H,W), depth (1,H,W), alpha (1,H,W) and feats (F,H,W) when
    extra_channels (N, F) is given (no background on features)."""
    inf = torch.full_like(proj.depth, float("inf"))
    order = torch.argsort(torch.where(proj.valid, proj.depth, inf),
                          stable=True)
    mean2d = proj.mean2d[order]
    conic = proj.conic[order]
    opacity = torch.where(proj.valid, proj.opacity,
                          torch.zeros_like(proj.opacity))[order]
    color = proj.color[order]
    depth = proj.depth[order]

    ys = torch.arange(image_height, dtype=mean2d.dtype, device=mean2d.device)
    xs = torch.arange(image_width, dtype=mean2d.dtype, device=mean2d.device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)
    pix = torch.stack([px.reshape(-1), py.reshape(-1)], dim=1)  # (P, 2)

    d = mean2d[:, None, :] - pix[None, :, :]  # (N, P, 2)
    power = (
        -0.5 * (conic[:, 0, None] * d[..., 0] ** 2
                + conic[:, 2, None] * d[..., 1] ** 2)
        - conic[:, 1, None] * d[..., 0] * d[..., 1]
    )
    alpha = torch.clamp(
        opacity[:, None] * torch.exp(torch.clamp(power, max=0.0)),
        max=ALPHA_MAX)
    alpha = torch.where(power > 0.0, torch.zeros_like(alpha), alpha)

    w = composite_weights(alpha, dim=0)  # (N, P)
    acc = w.sum(dim=0)
    rgb = w.T @ color + (1.0 - acc)[:, None] * bg_color[None, :]
    out_depth = w.T @ depth[:, None]

    H, W = image_height, image_width
    result = {
        "render": rgb.T.reshape(3, H, W),
        "depth": out_depth.T.reshape(1, H, W),
        "alpha": acc.reshape(1, H, W),
    }
    if extra_channels is not None:
        feats = w.T @ extra_channels[order]
        result["feats"] = feats.T.reshape(-1, H, W)
    return result
