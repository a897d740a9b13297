"""The style step's counted work: VGG16's convolutions through conv4_1,
the NNFM's products, and the whole step's operations at the card's
peaks (bounds.py's peaks and compositor counts).

Operations, not bytes: the convolutions and the NNFM products are bound
by operations at these sizes (the least bytes, each input read once and
each output written once, take a small share of the operations' time).
"""
from __future__ import annotations

from ..reference.style_step import VGG16_TO_CONV4_1
from . import bounds as B


def vgg_macs(height: int, width: int) -> float:
    """Multiply-adds of the forward through conv4_1 on one (3, H, W)
    image: 9 C_in C_out per output pixel of each conv (padding 1), each
    pool halving both sides."""
    h, w, macs = height, width, 0.0
    for layer in VGG16_TO_CONV4_1:
        if layer == "pool":
            h, w = h // 2, w // 2
        else:
            macs += 9.0 * layer[0] * layer[1] * h * w
    return macs


def vgg_step_flops(height: int, width: int) -> float:
    """The step's VGG operations: the forward and the input gradient
    (the same multiply-adds again; the weights take no gradient)."""
    return 2 * 2 * vgg_macs(height, width)


def nnfm_flops(calls: dict) -> float:
    """The NNFM's operations over the calls the counter ``nnfm`` counted
    ({(N1, N2, C): calls}): the N1 x N2 similarity forward and its
    product with the style features backward, 2 N1 N2 C each."""
    return sum(4.0 * n1 * n2 * c * k for (n1, n2, c), k in calls.items())


def peak_s(bf16_flops: float, f32_flops: float) -> float:
    """The least time of the counted operations at each precision's
    peak."""
    return bf16_flops / B.BF16_FLOPS_PER_S + f32_flops / B.F32_FLOPS_PER_S
