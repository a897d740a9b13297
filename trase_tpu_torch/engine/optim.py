"""Row-masked Adam with torch.optim.Adam's update rule.

Counterpart of trase_tpu/engine/optim.py. Optimizer state is tensors
shaped like the fixed-capacity parameters, so the reference's optimizer
surgery on densify / prune (scene/gaussian_model.py:457-635) reduces to
masked row writes in the densification ops.

    m <- b1 m + (1-b1) g;  v <- b2 v + (1-b2) g^2
    p <- p - lr * (m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + eps)

with one step count per tensor. Functional: the inputs are not
modified; the trainer commits the returned tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdamState(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor
    step: torch.Tensor  # 0-d int32


def adam_init(param: torch.Tensor) -> AdamState:
    return AdamState(mu=torch.zeros_like(param), nu=torch.zeros_like(param),
                     step=torch.zeros((), dtype=torch.int32,
                                      device=param.device))


def _rows(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (ndim - 1))


def adam_update(param: torch.Tensor, grad: torch.Tensor, state: AdamState,
                lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-15, row_mask: torch.Tensor | None = None):
    """One Adam step -> (new param, new state). `row_mask` (bool, leading
    dim) freezes masked-out rows entirely (their m / v / params are
    untouched): rows that the reference's optimizer does not hold."""
    zero = torch.zeros((), dtype=grad.dtype, device=grad.device)
    if row_mask is not None:
        grad = torch.where(_rows(row_mask, grad.ndim), grad, zero)
    step = state.step + 1
    mu = b1 * state.mu + (1 - b1) * grad
    nu = b2 * state.nu + (1 - b2) * grad * grad
    t = step.to(param.dtype)
    mu_hat = mu / (1 - b1 ** t)
    nu_hat = nu / (1 - b2 ** t)
    update = lr * mu_hat / (torch.sqrt(nu_hat) + eps)
    if row_mask is not None:
        m = _rows(row_mask, param.ndim)
        new_param = torch.where(m, param - update, param)
        mu = torch.where(m, mu, state.mu)
        nu = torch.where(m, nu, state.nu)
    else:
        new_param = param - update
    return new_param, AdamState(mu=mu, nu=nu, step=step)


def adam_update_list(params, grads, states, lr: float, eps: float = 1e-15):
    """Adam over matching lists with one shared lr (the deform MLP's
    tensors in flax Dense_i order, kernel before bias)."""
    new_p, new_s = [], []
    for p, g, s in zip(params, grads, states):
        np_, ns_ = adam_update(p, g, s, lr, eps=eps)
        new_p.append(np_)
        new_s.append(ns_)
    return new_p, new_s
