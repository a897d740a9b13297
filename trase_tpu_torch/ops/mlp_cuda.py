"""The fused deformation MLP (inference) and its plain PyTorch version.

Counterpart of trase_tpu/ops/mlp_pallas.py. The standard DeformNetwork's
8 x 256 ReLU stack, the skip folded into layer 5 (concat(inp, h) @ W5 =
inp @ Ws_in + h @ Ws_h) and the three heads packed into one (256, 10)
block, in one kernel (``csrc/deform_mlp.cu``, see its header for the
design and its bound on the card): bf16 operands, float32 accumulation,
float32 biases added before each bf16 rounding, float32 heads.

``pack_fused_weights`` gives the logical layout (``FusedWeights``) that
the plain version reads; ``device_layout`` lays it out as the kernel
streams it (32 swizzled chunks of 256 x 64 bf16), and ``fused_weights``
caches that on the network until a parameter changes.

``fused_deform_mlp`` launches the kernel on CUDA tensors and raises for
anything else; ``fused_deform_mlp_plain`` is the same function in plain
PyTorch (float32 products of the bf16-rounded operands, TF32 off), the
CPU path. Neither falls back to the other. Launches are counted in
``cuda_lib.LAYOUT_LAUNCHES`` under the key ``("deform_mlp",)``.
"""
from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import torch

from . import cuda_lib

HIDDEN = 7  # W1..W4, Ws_h, W6, W7
# the kernel's weight chunks: 256 output rows x CHUNK_K inputs, bf16, in
# the 128-byte swizzled order (64 bf16 a row, 16-byte groups permuted by
# row % 8); the input's K padded to KIN
WIDTH, CHUNK_K, KIN = 256, 64, 128
N_CHUNKS = 2 * (KIN // CHUNK_K) + HIDDEN * (WIDTH // CHUNK_K)  # 32
# the C entry point of csrc/deform_mlp.cu
SIGNATURES = {"trase_deform_mlp": [ctypes.c_void_p] + [ctypes.c_int] * 2
              + [ctypes.c_void_p] * 8}


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


class DeviceWeights(NamedTuple):
    chunks: torch.Tensor  # (32, 256, 64) bf16, swizzled: see device_layout
    bias: torch.Tensor  # (8, 256) float32
    wh: torch.Tensor  # (256, 10) float32
    bh: torch.Tensor  # (10,) float32
    in_dim: int


def _swizzle128(w: torch.Tensor) -> torch.Tensor:
    """(rows, 64) bf16 -> the same shape in the 128-byte swizzled order
    wgmma reads: row r's 16-byte group p holds group p ^ (r % 8) of the
    row. Its own inverse."""
    rows = w.shape[0]
    perm = (torch.arange(8, device=w.device)[None, :]
            ^ (torch.arange(rows, device=w.device) % 8)[:, None])
    g = w.reshape(rows, 8, 8)
    return torch.gather(g, 1, perm[:, :, None].expand(rows, 8, 8)).reshape(
        rows, CHUNK_K)


@torch.no_grad()
def device_layout(weights: FusedWeights) -> DeviceWeights:
    """The kernel's layout of packed weights, in the order the kernel
    consumes them: W0 and Ws_in zero-padded to KIN input columns (2
    chunks each), the hidden (256, 256) matrices 4 chunks each; chunk i
    of a matrix is its input columns [64 i, 64 i + 64), swizzled. Order:
    W0, W1..W4, Ws_in, Ws_h, W6, W7."""
    w = weights
    if w.in_dim > KIN:
        raise ValueError(f"the fused kernel takes in_dim <= {KIN}")

    def pad(m):
        return torch.nn.functional.pad(m, (0, KIN - m.shape[1]))

    mats = ([pad(w.w0)] + [w.w_hidden[i] for i in range(4)]
            + [pad(w.ws_in), w.w_hidden[4], w.w_hidden[5], w.w_hidden[6]])
    chunks = [_swizzle128(m[:, k:k + CHUNK_K].contiguous())
              for m in mats for k in range(0, m.shape[1], CHUNK_K)]
    return DeviceWeights(torch.stack(chunks).contiguous(), w.bias, w.wh,
                         w.bh, w.in_dim)


# network -> (key, DeviceWeights); the key is every parameter's storage
# and version counter, so an in-place update or load_flax_params repacks
_CACHE: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _params_key(model) -> tuple:
    return tuple((p.data_ptr(), p._version) for p in model.parameters())


def fused_weights(model) -> DeviceWeights:
    """device_layout(pack_fused_weights(model)), cached on the network
    while no parameter has been replaced or changed in place."""
    key = _params_key(model)
    hit = _CACHE.get(model)
    if hit is not None and hit[0] == key:
        return hit[1]
    dw = device_layout(pack_fused_weights(model))
    _CACHE[model] = (key, dw)
    return dw


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


def deform_mlp_cuda(weights: DeviceWeights, emb: torch.Tensor):
    """Launch the kernel on CUDA tensors: (d_xyz, d_rot, d_scale) as
    deform_mlp_plain returns them. Raises for CPU tensors, for shapes the
    kernel does not take and when the launch fails."""
    w = weights
    cuda_lib.require_cuda("deform_mlp", "deform_mlp_plain", emb=emb,
                          chunks=w.chunks, bias=w.bias, wh=w.wh, bh=w.bh)
    n = emb.shape[0]
    if emb.dtype != torch.float32 or emb.dim() != 2 or \
            emb.shape[1] != w.in_dim:
        raise ValueError(f"emb must be float32 (N, {w.in_dim})")
    shapes = {"chunks": ((N_CHUNKS, WIDTH, CHUNK_K), torch.bfloat16),
              "bias": ((8, 256), torch.float32),
              "wh": ((256, 10), torch.float32),
              "bh": ((10,), torch.float32)}
    for name, (shape, dtype) in shapes.items():
        t = getattr(w, name)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape} (the layout "
                             "device_layout writes)")
    if n == 0:
        raise ValueError("emb has no rows")
    outs = tuple(torch.empty((n, c), dtype=torch.float32, device=emb.device)
                 for c in (3, 4, 3))
    cuda_lib.launch(
        cuda_lib.library("deform_mlp", SIGNATURES).trase_deform_mlp,
        ("deform_mlp",), emb.device, emb, n, w.in_dim, w.chunks, w.bias, w.wh,
        w.bh, *outs)
    return outs


def fused_deform_mlp(model, emb: torch.Tensor):
    """The kernel on a standard DeformNetwork's weights (CUDA tensors)."""
    return deform_mlp_cuda(fused_weights(model), emb.contiguous())


def fused_deform_mlp_plain(model, emb: torch.Tensor):
    """The plain PyTorch version on a standard DeformNetwork's weights."""
    return deform_mlp_plain(pack_fused_weights(model), emb)
