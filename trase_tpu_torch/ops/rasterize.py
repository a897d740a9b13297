"""Rasterizer configuration and the per-gaussian tile-rect math.

Counterpart of trase_tpu/ops/rasterize.py:42-132: ``RasterConfig`` (the
fields the tiled compositor reads, with the same defaults), the tile grid, the covered tile rectangle (CUDA
getRect semantics over the exact-support AABB) and the aspect-balanced
clamp of oversized rects to the K-pair budget. Integer math is int32 and
the clamp's sqrt is float32, as in JAX, so both packages choose the same
sub-rects. The dense XLA backend is not ported: on the CPU the
compositor's plain PyTorch version takes its place
(ops/rasterize_cuda.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .projection import ProjectedGaussians

TILE = 16


class RasterConfig(NamedTuple):
    """Rasterizer capacities and switches: trase_tpu's, less the dense
    backend's per-tile capacities (the tiled compositor bins every pair)."""

    # Per-gaussian (tile, gaussian) pair budget. Rects larger than this
    # shrink to an aspect-balanced sub-rect around the projected mean
    # (dropped count reported as `overflow`).
    pairs_per_gaussian: int = 8
    # Drop (gaussian, tile) pairs whose best-case alpha over the tile is
    # below the 1/255 cutoff (exact: the compositor zeroes them anyway).
    alpha_cull: bool = False
    # Composite an even feature count at bf16 precision (round to
    # nearest even); geometry, rgb and depth stay float32.
    pack_features: bool = True


def _tile_grid(image_height: int, image_width: int):
    tw = -(-image_width // TILE)
    th = -(-image_height // TILE)
    return th, tw


def _tile_rects(proj: ProjectedGaussians, th: int, tw: int):
    """Per-gaussian covered tile rectangle (tx0, ty0, width, count)."""
    x, y = proj.mean2d[:, 0], proj.mean2d[:, 1]
    if proj.extent is not None:
        rx, ry = proj.extent[:, 0], proj.extent[:, 1]
    else:
        rx = ry = proj.radius
    i32 = torch.int32
    tx0 = torch.clamp(torch.floor((x - rx) / TILE), 0, tw).to(i32)
    ty0 = torch.clamp(torch.floor((y - ry) / TILE), 0, th).to(i32)
    tx1 = torch.clamp(torch.floor((x + rx) / TILE) + 1, 0, tw).to(i32)
    ty1 = torch.clamp(torch.floor((y + ry) / TILE) + 1, 0, th).to(i32)
    w = torch.clamp(tx1 - tx0, min=0)
    h = torch.clamp(ty1 - ty0, min=0)
    covered = proj.valid & (proj.radius > 0) & (rx > 0) & (ry > 0)
    count = torch.where(covered, w * h, torch.zeros_like(w))
    return tx0, ty0, w, count


def clamp_rect_to_budget(tx0, ty0, rect_w, count, mean2d, K: int):
    """Aspect-balanced truncation of oversized tile rects: rects larger
    than K tiles shrink to a <= K-tile sub-rect centred on the projected
    mean, so the dropped tiles are the farthest (weakest) ones. Returns
    (x0, y0, w2, count2) with count2 <= K."""
    one = torch.ones_like(rect_w)
    zero = torch.zeros_like(rect_w)
    rect_h = torch.div(count, torch.maximum(rect_w, one), rounding_mode="floor")
    w_f = torch.maximum(rect_w, one).to(torch.float32)
    h_f = torch.maximum(rect_h, one).to(torch.float32)
    ideal_w = torch.sqrt(K * w_f / h_f)
    w2 = torch.round(ideal_w).to(torch.int32)  # half-to-even, as jnp.round
    w2 = torch.minimum(torch.maximum(w2, one), torch.clamp(rect_w, max=K))
    w2 = torch.maximum(w2, one)
    h2 = torch.div(torch.full_like(w2, K), w2, rounding_mode="floor")
    h2 = torch.minimum(torch.maximum(h2, one), torch.maximum(rect_h, one))
    count2 = torch.where(count > 0, w2 * h2, zero)
    ct_x = torch.floor(mean2d[:, 0] / TILE).to(torch.int32)
    ct_y = torch.floor(mean2d[:, 1] / TILE).to(torch.int32)
    ct_x = torch.minimum(torch.maximum(ct_x, tx0),
                         tx0 + torch.maximum(rect_w - 1, zero))
    ct_y = torch.minimum(torch.maximum(ct_y, ty0),
                         ty0 + torch.maximum(rect_h - 1, zero))
    x0 = torch.minimum(torch.maximum(ct_x - torch.div(
        w2, 2, rounding_mode="floor"), tx0),
        tx0 + torch.maximum(rect_w - w2, zero))
    y0 = torch.minimum(torch.maximum(ct_y - torch.div(
        h2, 2, rounding_mode="floor"), ty0),
        ty0 + torch.maximum(rect_h - h2, zero))
    return x0, y0, w2, count2
