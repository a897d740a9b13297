"""What a style cell makes from the seed beside the scene: the style
image and each live gaussian's object.

Nothing here imports the port.
"""
from __future__ import annotations

import numpy as np
import torch

from . import generate as SG

# the style image's numpy stream, apart from the VGG weights' (which
# np.random.default_rng(seed) draws)
S_STYLE = 11
BACKGROUND_ID = -1


def style_image(style: dict, seed: int) -> np.ndarray:
    """A (3, H, W) float32 style image in [0, 1]: flat tiles over the
    left half (identical VGG columns there: ties in the NNFM max, as a
    painting's flat regions give), a striped texture with noise over the
    right half."""
    h, w, n = style["height"], style["width"], style["tiles"]
    rng = np.random.default_rng([int(seed), S_STYLE])
    img = np.empty((3, h, w), np.float32)
    half = w // 2
    tiles = rng.uniform(size=(3, n, n)).astype(np.float32)
    img[:, :, :half] = np.repeat(np.repeat(tiles, -(-h // n), axis=1),
                                 -(-half // n), axis=2)[:, :h, :half]
    yy, xx = np.mgrid[0:h, 0:w - half].astype(np.float32)
    tex = 0.5 + 0.3 * np.sin(xx / 7.0)[None] * np.cos(yy / 11.0)[None]
    img[:, :, half:] = np.clip(
        tex + 0.15 * rng.normal(size=(3, h, w - half)), 0, 1)
    return img


def object_ids(scene: dict, n_alive: int, seed: int, device) -> torch.Tensor:
    """(n_alive,) int64: the object each live gaussian of
    generate.make_gaussians was drawn around (the same draws from the
    same generator), BACKGROUND_ID for the background shell."""
    obj, bg = scene["objects"], scene["background"]
    n_bg = int(round(n_alive * bg["share"]))
    n_obj = n_alive - n_bg
    g = SG.generator(seed, SG.S_POSITIONS, device)
    torch.rand((obj["count"], 3), generator=g, device=device)  # the centres
    which = torch.randint(0, obj["count"], (n_obj,), generator=g,
                          device=device)
    return torch.cat([which, torch.full((n_bg,), BACKGROUND_ID,
                                        dtype=which.dtype, device=device)])
