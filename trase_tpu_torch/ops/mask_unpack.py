"""A SAM mask stack's packed bits -> the FEATURE step's padded float32
stack, on the card (``csrc/mask_unpack.cu``) or in plain PyTorch.

Replaces no Pallas kernel: trase_tpu, and the port's host path, expand the
bits on the host (``native.unpack_masks_padded``) and upload float32. The
training loop uploads a mask file's bits instead, a 32nd of the bytes, and
expands them here on its device (engine/loop.py: ``_upload_masks``).

``unpack_masks`` launches the kernel on CUDA tensors and takes
``unpack_masks_plain`` on CPU tensors; neither falls back to the other.
Launches are counted in ``cuda_lib.LAYOUT_LAUNCHES`` under the key
``("mask_unpack",)``.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib

# the C entry point of csrc/mask_unpack.cu
SIGNATURES = {"trase_unpack_masks": [ctypes.c_void_p] + [ctypes.c_int64] * 3
              + [ctypes.c_void_p] * 2}


def _check(bits: torch.Tensor, n: int, h: int, w: int, m_max: int):
    if bits.dtype != torch.uint8 or bits.dim() != 1:
        raise ValueError(f"bits must be a flat uint8 tensor, got "
                         f"{bits.dtype} {tuple(bits.shape)}")
    if min(n, h, w, m_max) < 0:
        raise ValueError(f"negative size in {(n, h, w)}, m_max {m_max}")
    if bits.numel() * 8 < n * h * w:
        raise ValueError(f"{bits.numel()} packed bytes hold fewer than the "
                         f"{n}x{h}x{w} bits asked for")


def unpack_masks(bits: torch.Tensor, n: int, h: int, w: int,
                 m_max: int) -> torch.Tensor:
    """(m_max, h, w) float32 on `bits`' device from the np.packbits bits
    (most significant first) of an (n, h, w) stack: its first min(n,
    m_max) masks as 0 / 1, zero rows after."""
    if bits.device.type == "cpu":
        return unpack_masks_plain(bits, n, h, w, m_max)
    _check(bits, n, h, w, m_max)
    cuda_lib.require_cuda("mask_unpack", "unpack_masks_plain", bits=bits)
    out = torch.empty((m_max, h, w), dtype=torch.float32, device=bits.device)
    cuda_lib.launch(
        cuda_lib.library("mask_unpack", SIGNATURES).trase_unpack_masks,
        ("mask_unpack",), bits.device, bits, n, h * w, m_max, out)
    return out


def unpack_masks_plain(bits: torch.Tensor, n: int, h: int, w: int,
                       m_max: int) -> torch.Tensor:
    """The same function in plain PyTorch."""
    _check(bits, n, h, w, m_max)
    k = min(n, m_max)
    out = torch.zeros((m_max, h, w), dtype=torch.float32, device=bits.device)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    flat = ((bits[:, None] >> shifts) & 1).reshape(-1)[:k * h * w]
    out[:k] = flat.reshape(k, h, w)
    return out
