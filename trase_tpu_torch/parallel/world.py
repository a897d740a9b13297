"""The world of ranks the multi-device steps run in, and its collectives.

Counterpart of trase_tpu/parallel/sharded.py: make_mesh (:41-46) and the
collectives its shard_map bodies call. PyTorch runs one process per rank:
rank r holds block r of the gaussian rows on ``cuda:r`` and talks to the
other ranks over NCCL, or over gloo on the CPU (the tests' worlds). The
rendezvous goes through a ``file://`` store in a directory the caller
names, or through torchrun's environment (``env://``).

The collectives under autograd are ``torch.autograd.Function``s whose
backward is the transpose of a loss computed replicated on every rank
(the steps gather the whole image on each rank and take the loss there):

- ``gather_rows``: all-gather of per-gaussian rows; each rank's slab of
  the image gives a partial gradient for every row, so the backward sums
  the partials over the ranks and keeps the rank's own rows;
- ``gather_slab``: all-gather of the ranks' image slabs; every rank's
  cotangent of the image is the same, so the backward keeps the rank's
  own slab and sums nothing (trase_tpu's shard_map transposes this
  gather into a psum_scatter, which scales every gradient by the world
  size: ROADMAP.md, Queue 3);
- ``sum_replicated``: all-reduce of a partial sum whose result the loss
  reads on every rank; the backward is the identity.

``all_reduce`` (no autograd) serves the steps' deform-net gradients (SUM),
the NaN guard's agreement (MIN) and the densify counts (SUM);
``gather_to_root`` / ``scatter_from_root`` move the state's rows between
the ranks' devices and rank 0's host (saves, capacity growth).
"""
from __future__ import annotations

import datetime
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import resolve_device

# how long a collective may wait for the other ranks before it raises
TIMEOUT_S = 300


class World(NamedTuple):
    rank: int
    size: int
    device: torch.device
    backend: str  # "nccl" (CUDA) or "gloo" (CPU)
    group: object = None  # the process group (None: the default one)


def check_devices(size: int) -> None:
    """Raise before any rank starts when a world of `size` ranks cannot
    have a card each: NCCL cannot put two ranks on one device."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if size > have:
        raise RuntimeError(
            f"a world of {size} ranks on CUDA needs {size} devices, and "
            f"this machine has {have}: NCCL cannot put two ranks on one "
            "device (train on the CPU with --device cpu, or with --mesh "
            f"{have} or fewer)")


def init_world(size: int, rank: int, device="cuda",
               store_dir: str | None = None,
               timeout_s: float = TIMEOUT_S) -> World:
    """Join a world of `size` ranks as `rank`: NCCL with rank r on
    ``cuda:r`` (``cuda:LOCAL_RANK`` under torchrun), gloo on the CPU. The
    rendezvous is a file store in `store_dir` (which every rank of this
    world names, and no earlier world used), or with store_dir None
    torchrun's environment. Raises when a CUDA world is larger than the
    machine's device count; never falls back to gloo or to the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        check_devices(size)
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    if store_dir is None:
        init_method = "env://"
    else:
        os.makedirs(store_dir, exist_ok=True)
        init_method = "file://" + os.path.abspath(
            os.path.join(store_dir, "store"))
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=init_method, world_size=size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return World(rank, size, dev, backend, dist.group.WORLD)


def close_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------- collectives


def all_gather(x: torch.Tensor, world: World) -> torch.Tensor:
    """The ranks' equal-shaped blocks of x, concatenated along dim 0."""
    if x.dtype == torch.bool:
        return all_gather(x.to(torch.uint8), world).to(torch.bool)
    x = x.contiguous()
    if world.backend == "nccl":
        out = torch.empty((world.size * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=world.group)
        return out
    parts = [torch.empty_like(x) for _ in range(world.size)]
    dist.all_gather(parts, x, group=world.group)
    return torch.cat(parts, dim=0)


def all_reduce(x: torch.Tensor, world: World,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of x (SUM, MIN, ...) over the world."""
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=world.group)
    return out


def all_reduce_list(tensors: list, world: World,
                    op=dist.ReduceOp.SUM) -> list:
    """all_reduce of several float tensors in one collective."""
    if not tensors:
        return []
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), world,
                      op)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


def _wire(x: torch.Tensor) -> torch.Tensor:
    # bool travels as uint8
    x = x.to(torch.uint8) if x.dtype == torch.bool else x
    return x.contiguous()


def gather_to_root(x: torch.Tensor, world: World):
    """The ranks' equal-shaped blocks of x concatenated along dim 0 on rank
    0's host; None on the other ranks. Rank 0 takes one block at a time
    through its device, so no device holds more than its own block and
    one other."""
    wire = _wire(x)
    if world.rank:
        dist.send(wire, dst=0, group=world.group)
        return None
    parts = [wire.to("cpu", copy=True)]
    buf = torch.empty_like(wire)
    for r in range(1, world.size):
        dist.recv(buf, src=r, group=world.group)
        parts.append(buf.to("cpu", copy=True))
    return torch.cat(parts).to(x.dtype)


def scatter_from_root(x, rows: int, like: torch.Tensor,
                      world: World) -> torch.Tensor:
    """Rows [r rows, (r + 1) rows) of x, which rank 0 holds (on its host;
    the other ranks pass None), on rank r's device: gather_to_root's
    inverse. `like` gives the dtype and the trailing shape."""
    if world.rank == 0:
        for r in range(1, world.size):
            dist.send(_wire(x[r * rows:(r + 1) * rows]).to(world.device),
                      dst=r, group=world.group)
        return x[:rows].to(world.device, copy=True)
    dtype = torch.uint8 if like.dtype == torch.bool else like.dtype
    out = torch.empty((rows,) + tuple(like.shape[1:]), dtype=dtype,
                      device=world.device)
    dist.recv(out, src=0, group=world.group)
    return out.to(like.dtype)


def own_block(x: torch.Tensor, world: World) -> torch.Tensor:
    n = x.shape[0] // world.size
    return x[world.rank * n:(world.rank + 1) * n]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        return all_gather(x, world)

    @staticmethod
    def backward(ctx, g):
        return own_block(all_reduce(g, ctx.world), ctx.world), None


class _GatherSlab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        return all_gather(x, world)

    @staticmethod
    def backward(ctx, g):
        return own_block(g, ctx.world), None


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world):
        return all_reduce(x, world)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_rows(x: torch.Tensor, world: World) -> torch.Tensor:
    """All-gather of per-gaussian rows; backward: the partial gradients
    summed over the ranks, the rank's own rows kept."""
    return _GatherRows.apply(x, world)


def gather_slab(x: torch.Tensor, world: World) -> torch.Tensor:
    """All-gather of image slabs; backward: the rank's own slab of the
    (replicated) image cotangent, not summed."""
    return _GatherSlab.apply(x, world)


def sum_replicated(x: torch.Tensor, world: World) -> torch.Tensor:
    """All-reduce SUM whose result every rank's loss reads; backward: the
    identity (each rank's partial sum gets the loss's gradient once)."""
    return _SumReplicated.apply(x, world)
