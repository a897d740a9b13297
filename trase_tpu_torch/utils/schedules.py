"""Learning-rate and noise schedules (host-side, pure python/numpy).

A copy of trase_tpu/utils/schedules.py (reference
utils/general_utils.py:30-106): the Plenoxels log-lerp decay with an
optional delayed warm-up, and the linear-lerp variant used for the AST
time-jitter amplitude.
"""
from __future__ import annotations

import numpy as np


def _delay_rate(step, lr_delay_steps, lr_delay_mult):
    if lr_delay_steps > 0:
        return lr_delay_mult + (1 - lr_delay_mult) * np.sin(
            0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1))
    return 1.0


def expon_lr_func(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
                  max_steps=1000000):
    """Log-linear interpolation from lr_init to lr_final over max_steps,
    optionally eased in over lr_delay_steps with a reverse-cosine ramp."""

    def helper(step):
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        t = np.clip(step / max_steps, 0, 1)
        log_lerp = np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t)
        return _delay_rate(step, lr_delay_steps, lr_delay_mult) * log_lerp

    return helper


def linear_noise_func(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
                      max_steps=1000000):
    """Linear interpolation variant; used for the AST time-jitter scale."""

    def helper(step):
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        t = np.clip(step / max_steps, 0, 1)
        return _delay_rate(step, lr_delay_steps, lr_delay_mult) * (
            lr_init * (1 - t) + lr_final * t)

    return helper
