"""The training steps' update tail on the card (``csrc/update_tail.cu``):
Adam over every tensor a step trains, the densification statistics and the
NaN guard's finiteness reduction in one launch, the guard's commit in a
second.

Replaces no Pallas kernel: trase_tpu leaves the tail to XLA's fusion. Its
plain version is engine/trainer.py: ``_update_plain`` (engine/optim.py:
``adam_update``, models/gaussians.py: ``add_densification_stats``, one
``isfinite`` and one ``torch.where`` a tensor), the CPU path and the
reference that this one equals bit for bit on the card; engine/trainer.py:
``_update`` takes this one for CUDA tensors.

``tail_table`` lays a step's tensors out in the kernel's table (``Table``
mirrors the C struct) with fresh output buffers, ``update_tail`` launches
the first kernel over it and ``update_commit`` the second. Launches are
counted in ``cuda_lib.LAYOUT_LAUNCHES`` under ``("update_tail", segments)``
(Adam, densify and check segments of the table) and ``("update_commit",)``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_lib

# the table's capacities and a block's elements (rows), as csrc/update_tail.cu:
# the largest deform net the port builds (Blender's time net and the 6-DoF
# heads, 28 tensors) trained with the six fields is 34 Adam segments; its
# GAUSSIAN step before the deform net checks 89 tensors
MAX_ADAM, MAX_CHECK, CHUNK = 36, 96, 2048
# Adam's constants, engine/optim.py: adam_update's defaults (every step's)
B1, B2, EPS = 0.9, 0.999, 1e-15

_P, _I, _F = ctypes.c_void_p, ctypes.c_int32, ctypes.c_float


class _AdamSeg(ctypes.Structure):
    _fields_ = [("p", _P), ("g", _P), ("m", _P), ("v", _P), ("step", _P),
                ("p_out", _P), ("m_out", _P), ("v_out", _P),
                ("step_out", _P), ("n", _I), ("row_width", _I), ("lr", _F),
                ("block_begin", _I)]


class _CheckSeg(ctypes.Structure):
    _fields_ = [("x", _P), ("n", _I), ("block_begin", _I)]


class _DensifySeg(ctypes.Structure):
    _fields_ = [("g_off", _P), ("visible", _P), ("alive", _P), ("radii", _P),
                ("accum", _P), ("denom", _P), ("max_radii", _P),
                ("accum_out", _P), ("denom_out", _P), ("max_radii_out", _P),
                ("n", _I), ("half_w", _F), ("half_h", _F),
                ("block_begin", _I)]


class Table(ctypes.Structure):
    _fields_ = [("adam", _AdamSeg * MAX_ADAM), ("check", _CheckSeg * MAX_CHECK),
                ("densify", _DensifySeg), ("row_mask", _P), ("flag", _P),
                ("b1", _F), ("b2", _F), ("one_minus_b1", _F),
                ("one_minus_b2", _F), ("eps", _F), ("n_adam", _I),
                ("n_check", _I), ("adam_end", _I), ("densify_end", _I),
                ("n_blocks", _I)]


# the C entry points: (table, its size in bytes, [agreed,] stream)
SIGNATURES = {"trase_update_tail": [_P, ctypes.c_int64, _P],
              "trase_update_commit": [_P, ctypes.c_int64, _P, _P]}


class AdamSegment(NamedTuple):
    """A tensor the step trains, with its Adam moments and int32 step
    count: Adam at `lr`; with `masked`, the rows outside the tail's row
    mask keep their param and moments."""

    param: torch.Tensor
    grad: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    step: torch.Tensor
    lr: float
    masked: bool


class DensifySegment(NamedTuple):
    """The densification statistics' inputs (add_densification_stats)."""

    g_off: torch.Tensor  # (C, 2) screen-space gradient
    visible: torch.Tensor  # (C,) bool
    alive: torch.Tensor  # (C,) bool
    radii: torch.Tensor  # (C,)
    accum: torch.Tensor  # aux.xyz_gradient_accum
    denom: torch.Tensor
    max_radii2d: torch.Tensor
    height: int
    width: int


class Tail(NamedTuple):
    """The first launch's results: per AdamSegment its new (param, mu,
    nu, step); the new (accum, denom, max_radii2d) or None; the guard's
    flag, not yet agreed; the table, for update_commit."""

    adam: list
    densify: tuple | None
    finite: torch.Tensor
    table: Table


def _blocks(n: int) -> int:
    return -(-n // CHUNK)


def _floats(name: str, device, *tensors):
    for t in tensors:
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"{name}: the update tail takes contiguous "
                             f"float32 tensors on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name}: {t.numel()} elements, over int32")


def tail_table(adam: list, densify: DensifySegment | None, checks: list,
               row_mask: torch.Tensor | None) -> Tail:
    """The kernel's table for one step, with its output buffers and flag
    allocated (``torch.empty_like``, nothing launched): AdamSegments, the
    densification statistics (or None) and the tensors only checked for
    finiteness. Raises ValueError on a tensor the kernel does not take,
    or on more than MAX_ADAM or MAX_CHECK segments."""
    if len(adam) > MAX_ADAM or len(checks) > MAX_CHECK:
        raise ValueError(f"{len(adam)} Adam and {len(checks)} check "
                         f"segments: a table holds {MAX_ADAM} and "
                         f"{MAX_CHECK}")
    dev = (adam[0].param if adam else checks[0]).device
    flag = torch.empty((), dtype=torch.bool, device=dev)
    for k, a in enumerate(adam):
        _floats(f"adam segment {k}", dev, a.param, a.grad, a.mu, a.nu)
        if not (a.param.shape == a.grad.shape == a.mu.shape
                == a.nu.shape) or a.step.dtype != torch.int32:
            raise ValueError(f"adam segment {k}: param, grad and moments "
                             "differ in shape, or the step is not int32")
        if a.masked and (row_mask is None or a.param.dim() == 0
                         or row_mask.shape != a.param.shape[:1]):
            raise ValueError(f"adam segment {k}: no row mask of its rows")
    for k, x in enumerate(checks):
        _floats(f"check segment {k}", dev, x)
    if row_mask is not None and (row_mask.dtype != torch.bool
                                 or not row_mask.is_contiguous()):
        raise ValueError("the row mask must be a contiguous bool tensor")
    if densify is not None:
        d = densify
        _floats("densify", dev, d.g_off, d.radii, d.accum, d.denom,
                d.max_radii2d)
        n = d.accum.shape[0]
        if (d.g_off.shape != (n, 2) or d.visible.shape != (n,)
                or d.alive.shape != (n,) or d.visible.dtype != torch.bool
                or d.alive.dtype != torch.bool
                or not d.visible.is_contiguous()
                or not d.alive.is_contiguous()
                or not d.radii.shape == d.denom.shape
                == d.max_radii2d.shape == (n,)):
            raise ValueError("densify: inputs of other shapes or types than "
                             "(C, 2) float32 gradients and (C,) rows")

    tab = Table(row_mask=row_mask.data_ptr() if row_mask is not None
                else None, flag=flag.data_ptr(), b1=B1, b2=B2,
                one_minus_b1=1 - B1, one_minus_b2=1 - B2, eps=EPS,
                n_adam=len(adam), n_check=len(checks))
    outs, blocks = [], 0
    for j, a in enumerate(adam):
        out = tuple(torch.empty_like(x) for x in (a.param, a.mu, a.nu,
                                                  a.step))
        n = a.param.numel()
        tab.adam[j] = _AdamSeg(
            *(x.data_ptr() for x in (a.param, a.grad, a.mu, a.nu, a.step)),
            *(x.data_ptr() for x in out), n,
            n // a.param.shape[0] if a.masked and n else 0, a.lr, blocks)
        outs.append(out)
        blocks += max(1, _blocks(n))  # a block writes the step count
    tab.adam_end = blocks
    stats = None
    if densify is not None:
        d = densify
        stats = tuple(torch.empty_like(x)
                      for x in (d.accum, d.denom, d.max_radii2d))
        tab.densify = _DensifySeg(
            d.g_off.data_ptr(), d.visible.data_ptr(), d.alive.data_ptr(),
            d.radii.data_ptr(), d.accum.data_ptr(), d.denom.data_ptr(),
            d.max_radii2d.data_ptr(), *(x.data_ptr() for x in stats),
            d.accum.shape[0], d.width / 2.0, d.height / 2.0, blocks)
        blocks += _blocks(d.accum.shape[0])
    tab.densify_end = blocks
    for j, x in enumerate(checks):
        tab.check[j] = _CheckSeg(x.data_ptr(), x.numel(), blocks)
        blocks += _blocks(x.numel())
    tab.n_blocks = blocks
    return Tail(outs, stats, flag, tab)


def _library():
    return cuda_lib.library("update_tail", SIGNATURES)


def segments(tab: Table) -> int:
    """A table's segments: Adam, densify and check."""
    return tab.n_adam + tab.n_check + (tab.densify_end > tab.adam_end)


def update_tail(adam: list, densify: DensifySegment | None, checks: list,
                row_mask: torch.Tensor | None) -> Tail:
    """tail_table's table launched on the card: the new tensors and the
    flag that every element written and checked is finite. CUDA tensors
    only; the CPU path is engine/trainer.py: _update_plain."""
    lead = adam[0].param if adam else checks[0]
    cuda_lib.require_cuda("update_tail", "engine/trainer.py: _update_plain",
                          lead=lead)
    tail = tail_table(adam, densify, checks, row_mask)
    tab = tail.table
    cuda_lib.launch(_library().trase_update_tail,
                    ("update_tail", segments(tab)), lead.device,
                    ctypes.addressof(tab), ctypes.sizeof(tab))
    return tail


def update_commit(tail: Tail, agreed: torch.Tensor) -> None:
    """Where `agreed` (a 0-d bool on the card) is false, copy every leaf
    the tail wrote back from its input: torch.where(agreed, new, old)."""
    tab = tail.table
    if tab.densify_end:
        cuda_lib.launch(_library().trase_update_commit, ("update_commit",),
                        agreed.device, ctypes.addressof(tab),
                        ctypes.sizeof(tab), agreed)
