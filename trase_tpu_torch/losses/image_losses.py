"""RGB losses (torch).

Counterpart of trase_tpu/losses/image_losses.py (reference
utils/loss_utils.py:30-87): the L1 and windowed SSIM terms of the
GAUSSIAN phase's photometric loss.
"""
from __future__ import annotations

import torch

from ..ops.ssim import ssim  # noqa: F401  (same call surface)


def l1_loss(output: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.abs(output - gt).mean()
