"""The fused deformation MLP (inference) and its plain PyTorch version.

Counterpart of trase_tpu/ops/mlp_pallas.py. The standard DeformNetwork's
8 x 256 ReLU stack, the skip folded into layer 5 (concat(inp, h) @ W5 =
inp @ Ws_in + h @ Ws_h) and the three heads packed into one (256, 10)
block, in one kernel (``csrc/deform_mlp.cu``, see its header for the
design and its bound on the card): bf16 operands, float32 accumulation,
float32 biases added before each bf16 rounding, float32 heads.

``fused_deform_mlp`` launches the kernel on CUDA tensors and raises for
anything else; ``fused_deform_mlp_plain`` is the same function in plain
PyTorch (float32 products of the bf16-rounded operands, TF32 off), the
CPU path. Neither falls back to the other. Launches are counted in
``rasterize_cuda.LAYOUT_LAUNCHES`` under the key ``("deform_mlp",)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import rasterize_cuda as RC

HIDDEN = 7  # W1..W4, Ws_h, W6, W7


def fused_available(model) -> bool:
    """The architectures the kernel computes, the same gate as
    trase_tpu's (mlp_pallas.py:35-38): no 6-DoF head, no blender
    time-net, no feature input, depth 8, width 256. It routes by
    architecture; it is not a fallback for a kernel that failed."""
    return (not model.is_6dof and not model.is_blender
            and model.feature_dim == 0 and model.depth == 8
            and model.width == 256)


class FusedWeights(NamedTuple):
    w0: torch.Tensor  # (256, kin) bf16, zero columns past in_dim
    ws_in: torch.Tensor  # (256, kin) bf16: linear[5]'s input columns
    w_hidden: torch.Tensor  # (7, 256, 256) bf16: W1..W4, Ws_h, W6, W7
    bias: torch.Tensor  # (8, 256) float32
    wh: torch.Tensor  # (256, 10) float32: [d_xyz | d_rot | d_scale] heads
    bh: torch.Tensor  # (10,) float32
    in_dim: int


def _kin(in_dim: int) -> int:
    """The input width rounded up to a multiple of 16 (the tensor cores'
    bf16 depth); the zero padding is exact."""
    return -(-in_dim // 16) * 16


@torch.no_grad()
def pack_fused_weights(model) -> FusedWeights:
    """The kernel's weights from the network's nn.Linear layers (weight
    (out, in), the transpose of a flax kernel): linear[5] split into its
    input columns [:, :in_dim] and hidden columns [:, in_dim:] (the skip is
    cat([inp, h])), the three heads concatenated, hidden weights cast to
    bf16 and every bias kept float32."""
    if not fused_available(model):
        raise ValueError("the fused deform MLP takes the standard "
                         "DeformNetwork only (see fused_available)")
    lin = model.linear
    in_dim = lin[0].weight.shape[1]
    pad = _kin(in_dim) - in_dim

    def cols(w):
        return torch.nn.functional.pad(w, (0, pad)).to(torch.bfloat16)

    w5 = lin[5].weight
    hidden = [lin[i].weight for i in (1, 2, 3, 4)] + [w5[:, in_dim:]] \
        + [lin[i].weight for i in (6, 7)]
    heads = (model.gaussian_warp, model.gaussian_rotation,
             model.gaussian_scaling)
    return FusedWeights(
        w0=cols(lin[0].weight).contiguous(),
        ws_in=cols(w5[:, :in_dim]).contiguous(),
        w_hidden=torch.stack(hidden).to(torch.bfloat16).contiguous(),
        bias=torch.stack([l.bias for l in lin]).float().contiguous(),
        wh=torch.cat([h.weight for h in heads]).T.float().contiguous(),
        bh=torch.cat([h.bias for h in heads]).float().contiguous(),
        in_dim=in_dim)


def _split(out: torch.Tensor):
    return out[:, 0:3], out[:, 3:7], out[:, 7:10]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """bf16 rounding (nearest even), kept in float32."""
    return x.to(torch.bfloat16).float()


@torch.no_grad()
def deform_mlp_plain(weights: FusedWeights, emb: torch.Tensor):
    """Plain PyTorch version of the kernel on packed weights: each layer
    is a float32 product of bf16-rounded operands, plus the float32 bias,
    ReLU, then the bf16 rounding; the heads in float32. Returns (d_xyz
    (N,3), d_rot (N,4), d_scale (N,3)) float32."""
    w = weights
    d = w.in_dim
    inp = _bf16(emb.float())

    def dense(h, wt, b):
        return _bf16(torch.relu(h @ wt.float().T + b))

    h = dense(inp, w.w0[:, :d], w.bias[0])
    for i in range(4):
        h = dense(h, w.w_hidden[i], w.bias[1 + i])
    w5 = torch.cat([w.ws_in[:, :d], w.w_hidden[4]], dim=1)
    h = dense(torch.cat([inp, h], dim=1), w5, w.bias[5])
    for i, l in ((5, 6), (6, 7)):
        h = dense(h, w.w_hidden[i], w.bias[l])
    return _split(h @ w.wh + w.bh)


def deform_mlp_cuda(weights: FusedWeights, emb: torch.Tensor):
    """Launch the kernel on CUDA tensors: (d_xyz, d_rot, d_scale) as
    deform_mlp_plain returns them. Raises for CPU tensors, for shapes the
    kernel does not take and when the launch fails."""
    w = weights
    RC._require_cuda("deform_mlp", "deform_mlp_plain", emb=emb, w0=w.w0,
                     ws_in=w.ws_in, w_hidden=w.w_hidden, bias=w.bias,
                     wh=w.wh, bh=w.bh)
    kin = _kin(w.in_dim)
    n = emb.shape[0]
    if emb.dtype != torch.float32 or emb.dim() != 2 or \
            emb.shape[1] != w.in_dim:
        raise ValueError(f"emb must be float32 (N, {w.in_dim})")
    shapes = {"w0": (256, kin), "ws_in": (256, kin),
              "w_hidden": (HIDDEN, 256, 256), "bias": (8, 256),
              "wh": (256, 10), "bh": (10,)}
    for name, shape in shapes.items():
        t = getattr(w, name)
        want = torch.bfloat16 if name in ("w0", "ws_in", "w_hidden") \
            else torch.float32
        if tuple(t.shape) != shape or t.dtype != want:
            raise ValueError(f"{name} must be {want} {shape} (the layout "
                             "pack_fused_weights writes)")
    if n == 0:
        raise ValueError("emb has no rows")
    lib = RC._library("deform_mlp")
    dev = emb.device
    outs = [torch.empty((n, c), dtype=torch.float32, device=dev)
            for c in (3, 4, 3)]
    with torch.cuda.device(dev):
        rc = lib.trase_deform_mlp(
            emb.data_ptr(), n, w.in_dim, kin, w.w0.data_ptr(),
            w.ws_in.data_ptr(), w.w_hidden.data_ptr(), w.bias.data_ptr(),
            w.wh.data_ptr(), w.bh.data_ptr(), *[o.data_ptr() for o in outs],
            RC._stream(dev))
    if rc != 0:
        raise RuntimeError(f"deform_mlp launch failed: cudaError {rc}")
    RC._count_layout(("deform_mlp",))
    return tuple(outs)


def fused_deform_mlp(model, emb: torch.Tensor):
    """The kernel on a standard DeformNetwork's weights (CUDA tensors)."""
    return deform_mlp_cuda(pack_fused_weights(model), emb.contiguous())


def fused_deform_mlp_plain(model, emb: torch.Tensor):
    """The plain PyTorch version on a standard DeformNetwork's weights."""
    return deform_mlp_plain(pack_fused_weights(model), emb)
