"""VGG16 / VGG19 feature extractor (torch.nn): the style-transfer loss's
and LPIPS's backbone.

Counterpart of trase_tpu/models/vgg.py (reference style_transfer/fx.py):
the same layer-name API ('convI_J' is the pre-ReLU output of the J-th
conv of block I, 'reluI_J' its activation, 'convI' / 'reluI' every conv
of block I concatenated along channels; 1-based) over a channel-
normalized input, on torchvision's VGG layer indexing. The convolutions
and 2x2 max-pools are cuDNN calls on the card (F.conv2d, F.max_pool2d),
as trase_tpu's are XLA's conv and reduce_window; float32 with TF32 off
(the package sets it). The weights are buffers: a backward through the
extractor computes the input's gradient alone. The forward stops after
the last layer the requested names need.

Weights: a torchvision ``vgg16-*.pth`` state_dict (``features.<idx>``,
read with ``torch.load(weights_only=True)``) or an .npz of
``{bi}_{ci}.w`` / ``.b`` arrays. Without a file the extractor draws
trase_tpu's seeded He init from ``np.random.default_rng(seed)`` in the
same order, so both packages compute the same features; a warning says
the features are not pretrained ones. ``load_numpy_weights`` copies
trase_tpu's ``{(block, conv): (w, b)}`` dict into an extractor.
"""
from __future__ import annotations

import os
import re
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device

# channels per conv layer, per block (vgg16 / vgg19)
VGG16_BLOCKS = [[64, 64], [128, 128], [256, 256, 256],
                [512, 512, 512], [512, 512, 512]]
VGG19_BLOCKS = [[64, 64], [128, 128], [256, 256, 256, 256],
                [512, 512, 512, 512], [512, 512, 512, 512]]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_NAME = re.compile(r"(conv|relu)([1-5])(?:_([1-4]))?")


def parse_layer_names(layer_names: Sequence[str], blocks) -> set:
    """{(op, block, conv)} (0-based) that `layer_names` need; raises
    trase_tpu's ValueError on a name that is not a layer of `blocks`."""
    needed = set()
    for name in layer_names:
        m = _NAME.fullmatch(name)
        if not m:
            raise ValueError(f"Invalid layer name: {name}")
        op, b, j = m.group(1), int(m.group(2)) - 1, m.group(3)
        if j is not None:
            if int(j) - 1 >= len(blocks[b]):
                raise ValueError(
                    f"Invalid layer name: {name} (block "
                    f"{b + 1} has only {len(blocks[b])} convs)")
            needed.add((op, b, int(j) - 1))
        else:
            needed.update((op, b, jj) for jj in range(len(blocks[b])))
    return needed


def seeded_weights(blocks, seed: int = 0, upto=None) -> dict:
    """trase_tpu's fallback weights: He-normal kernels drawn from
    np.random.default_rng(seed) block by block, zero biases. `upto`
    (block, conv) stops after that layer: the draws before it are the
    same whether or not later layers are drawn."""
    rng = np.random.default_rng(seed)
    weights = {}
    in_c = 3
    for bi, block in enumerate(blocks):
        for ci, out_c in enumerate(block):
            w = rng.normal(0, np.sqrt(2.0 / (in_c * 9)),
                           size=(out_c, in_c, 3, 3)).astype(np.float32)
            weights[(bi, ci)] = (w, np.zeros(out_c, np.float32))
            in_c = out_c
            if (bi, ci) == upto:
                return weights
    return weights


class VGGFeatureExtractor(nn.Module):
    """forward(image in [0, 1], (3, H, W) or (N, 3, H, W)) ->
    {name: (N, C, h, w)}, trase_tpu's __call__. `normalization`: the
    (mean, std) channel stats applied inside the forward, ImageNet's by
    default (LPIPS passes its shift and scale)."""

    def __init__(self, layer_names: Sequence[str], blocks,
                 weights: dict | None = None, seed: int = 0,
                 normalization: tuple | None = None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.blocks = [list(b) for b in blocks]
        self.layer_names = list(layer_names)
        self.needed = parse_layer_names(self.layer_names, self.blocks)
        # the last conv the names need: the forward stops there
        self.last = max((b, c) for _, b, c in self.needed)
        if normalization is None:
            normalization = (IMAGENET_MEAN, IMAGENET_STD)
        self.register_buffer("norm_mean", torch.tensor(
            np.asarray(normalization[0], np.float32), device=dev))
        self.register_buffer("norm_std", torch.tensor(
            np.asarray(normalization[1], np.float32), device=dev))
        in_c = 3
        for bi, block in enumerate(self.blocks):
            for ci, out_c in enumerate(block):
                if (bi, ci) <= self.last:
                    self.register_buffer(
                        f"w{bi}_{ci}", torch.zeros(
                            (out_c, in_c, 3, 3), device=dev))
                    self.register_buffer(f"b{bi}_{ci}", torch.zeros(
                        out_c, device=dev))
                in_c = out_c
        if weights is None:
            weights = seeded_weights(self.blocks, seed, self.last)
        load_numpy_weights(self, weights)

    def layer(self, bi: int, ci: int):
        return getattr(self, f"w{bi}_{ci}"), getattr(self, f"b{bi}_{ci}")

    def normalize(self, image: torch.Tensor) -> torch.Tensor:
        """Channel-normalize an image outside the extractor (fx.py's
        public `.normalize`). The forward normalizes too: the style
        trainer calls both, so its features are of a twice-normalized
        image (trase_tpu/models/vgg.py:106-118)."""
        shape = (1, 3, 1, 1) if image.ndim == 4 else (3, 1, 1)
        return (image - self.norm_mean.view(shape)) / self.norm_std.view(
            shape)

    def forward(self, image: torch.Tensor, detach: bool = False) -> dict:
        x = image if image.ndim == 4 else image[None]
        x = (x - self.norm_mean.view(1, 3, 1, 1)) / self.norm_std.view(
            1, 3, 1, 1)
        acts = {}
        for bi, block in enumerate(self.blocks[: self.last[0] + 1]):
            if bi:
                x = F.max_pool2d(x, 2, 2)
            for ci in range(len(block)):
                if (bi, ci) > self.last:
                    break
                pre = F.conv2d(x, *self.layer(bi, ci), padding=1)
                x = F.relu(pre)
                if ("conv", bi, ci) in self.needed:
                    acts[("conv", bi, ci)] = pre
                if ("relu", bi, ci) in self.needed:
                    acts[("relu", bi, ci)] = x
        out = {}
        for name in self.layer_names:
            op, b, j = _NAME.fullmatch(name).groups()
            b = int(b) - 1
            if j is not None:
                v = acts[(op, b, int(j) - 1)]
            else:
                v = torch.cat([acts[(op, b, jj)]
                               for jj in range(len(self.blocks[b]))], dim=1)
            out[name] = v.detach() if detach else v
        return out


@torch.no_grad()
def load_numpy_weights(extractor: VGGFeatureExtractor,
                       weights: dict) -> VGGFeatureExtractor:
    """Copy a {(block, conv): (w (O, I, 3, 3), b (O,))} dict of arrays
    (trase_tpu's VGGFeatureExtractor.weights as numpy, or what
    load_vgg_weights returns) into the layers `extractor` holds.
    Returns the extractor."""
    for bi, block in enumerate(extractor.blocks):
        for ci in range(len(block)):
            if (bi, ci) > extractor.last:
                return extractor
            w, b = extractor.layer(bi, ci)
            src_w, src_b = weights[(bi, ci)]
            src_w = torch.tensor(np.asarray(src_w, np.float32))
            if tuple(src_w.shape) != tuple(w.shape):
                raise ValueError(f"VGG layer ({bi}, {ci}): weight "
                                 f"{tuple(src_w.shape)}, expected "
                                 f"{tuple(w.shape)}")
            w.copy_(src_w)
            b.copy_(torch.tensor(np.asarray(src_b, np.float32)))
    return extractor


def _weights_from_torch_state_dict(sd, blocks) -> dict:
    """torchvision vgg state_dict ('features.<idx>.weight') -> our keys."""
    idx = 0
    out = {}
    for bi, block in enumerate(blocks):
        for ci in range(len(block)):
            out[(bi, ci)] = (
                np.asarray(sd[f"features.{idx}.weight"], np.float32),
                np.asarray(sd[f"features.{idx}.bias"], np.float32))
            idx += 2  # conv + relu
        idx += 1  # maxpool
    return out


def load_vgg_weights(path: str, blocks=VGG16_BLOCKS) -> dict | None:
    """VGG weights from a .pth (torch state_dict) or an .npz, as numpy;
    None when the file is missing."""
    if not path or not os.path.exists(path):
        return None
    if path.endswith(".npz"):
        z = np.load(path)
        out = {}
        for k in z.files:
            if k.endswith(".w"):
                bi, ci = map(int, k[:-2].split("_"))
                out[(bi, ci)] = (z[k], z[f"{bi}_{ci}.b"])
        return out
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return _weights_from_torch_state_dict(sd, blocks)


def make_vgg16_extractor(layer_names: Sequence[str],
                         weights_path: str | None = None, device="cuda"):
    """VGG16FeatureExtractor equivalent (fx.py:89-91)."""
    weights = load_vgg_weights(weights_path) if weights_path else None
    if weights_path and weights is None:
        print(f"[vgg] WARNING: weights not found at {weights_path}")
    if weights is None:
        print("[vgg] WARNING: using seeded random VGG16 weights "
              "(no pretrained file; style fidelity will be limited)")
    return VGGFeatureExtractor(layer_names, VGG16_BLOCKS, weights,
                               device=device)


def make_vgg19_extractor(layer_names: Sequence[str],
                         weights_path: str | None = None, device="cuda"):
    weights = (load_vgg_weights(weights_path, VGG19_BLOCKS)
               if weights_path else None)
    if weights is None:
        print("[vgg] WARNING: using seeded random VGG19 weights")
    return VGGFeatureExtractor(layer_names, VGG19_BLOCKS, weights,
                               device=device)
