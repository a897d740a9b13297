"""K-nearest-neighbour ops: chunked dense distances + top-k.

Counterpart of trase_tpu/ops/knn.py (the reference's simple_knn distCUDA2
and pytorch3d knn_points): ``knn``, ``mean_dist3_sq`` for gaussian
initialisation, and the FEATURE step's feature smoothing
(``build_feature_smooth_map``, ``smooth_features``). Chunked
(chunk x N) distance matrices keep memory bounded; the distances are
||q||^2 + ||p||^2 - 2 q.p, a float32 matrix product (TF32 is off).

The smoothing's gradient is a reduce over the neighbour map's transpose
(``transpose_smooth_map``, built once with the map: a ``SmoothMap``), each
destination row summed by itself in a fixed order and a hub row (more than
``SMOOTH_CHUNK`` entries: tied dead slots all name the same few rows) cut
into chunks whose sums are added in chunk order: deterministic, no atomics.
``smooth_rows_bwd`` launches ``csrc/smooth_rows_bwd.cu`` on CUDA tensors and
takes ``smooth_rows_bwd_plain``, the same sums in the same order, on CPU
tensors; neither falls back to the other. Launches are counted in
``cuda_lib.LAYOUT_LAUNCHES`` under ``("smooth_rows_bwd",)``; the counter
``smooth_map`` holds the transposes built (``("transpose",)``: the FEATURE
steps' maps and each snapshot's) and the largest in-degree seen
(``("max_in_degree",)``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils import trace
from . import cuda_lib

# share of the neighbour slots a FEATURE step's smoothing averages over
# (trase_tpu's loop passes smooth_dropout=0.5)
SMOOTH_DROPOUT = 0.5
# entries of the transpose one warp sums; a row with more is split. At the
# n3v benchmark's map on an H100 the kernel took 0.224, 0.171, 0.145,
# 0.132 and 0.145 ms at 64, 128, 256, 512 and 1024
SMOOTH_CHUNK = 512
SMOOTH_MAP: dict = trace.counter("smooth_map")
# the C entry point of csrc/smooth_rows_bwd.cu
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"trase_smooth_rows_bwd": [_P] + [_I] * 2 + [_P] * 3 + [_I]
              + [_P] * 2 + [_I] + [_P] * 2 + [_I] + [_P, _I, ctypes.c_float]
              + [_P] * 3}


def knn(queries: torch.Tensor, points: torch.Tensor, k: int,
        chunk: int = 4096):
    """Exact KNN: for each query, the k nearest points. Returns
    (dists2 (Q, k), idx (Q, k) int64), ascending by squared distance.
    Points at equal distance may come in another order than
    jax.lax.top_k gives them."""
    sq = (points * points).sum(dim=1)
    dists, idx = [], []
    for lo in range(0, queries.shape[0], chunk):
        q = queries[lo:lo + chunk]
        d2 = (q * q).sum(dim=1, keepdim=True) + sq[None, :] \
            - 2.0 * (q @ points.T)
        d2 = torch.clamp(d2, min=0.0)
        top = torch.topk(d2, k=k, dim=1, largest=False)
        dists.append(top.values)
        idx.append(top.indices)
    return torch.cat(dists), torch.cat(idx)


def mean_dist3_sq(points: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """Mean squared distance to the 3 nearest neighbours (excluding
    self). points: (N,3) -> (N,)."""
    d2, _ = knn(points, points, k=min(4, points.shape[0]), chunk=chunk)
    return d2[:, 1:].mean(dim=1)


def build_feature_smooth_map(xyz: torch.Tensor, k: int,
                             chunk: int = 4096) -> torch.Tensor:
    """Neighbour index map for feature smoothing (self included, as
    knn_points with query == ref): (N, k) int64."""
    return knn(xyz, xyz, k=k, chunk=chunk)[1]


class SmoothMap(NamedTuple):
    """A neighbour map and its transpose, CSR over the destination rows:
    row j's entries are the (source row i, slot s) with idx[i, s] == j, in
    ascending (i, s). Rows with more than `chunk` entries (hubs) are cut
    into chunks of `chunk` entries (the last one shorter)."""
    idx: torch.Tensor  # (C, K) int64 neighbour map
    rev_ptr: torch.Tensor  # (n_dst + 1,) int32 each row's first entry
    rev_src: torch.Tensor  # (C K,) int32 each entry's source row
    rev_slot: torch.Tensor  # (C K,) uint8 each entry's slot
    part_begin: torch.Tensor  # (P,) int32 each hub chunk's first entry
    part_end: torch.Tensor  # (P,) int32 and its end
    hub_rows: torch.Tensor  # (H,) int32 the hub rows
    hub_part_ptr: torch.Tensor  # (H + 1,) int32 each hub's first chunk
    chunk: int
    max_in_degree: int


def transpose_smooth_map(idx: torch.Tensor, n_dst: int | None = None,
                         chunk: int = SMOOTH_CHUNK) -> SmoothMap:
    """The SmoothMap of a (C, K) neighbour map into `n_dst` rows (C by
    default; a rank's rows name the gathered rows of every rank), on the
    map's device: one stable sort of the C K entries by destination. Reads
    the hub count and the largest in-degree back to the host."""
    c, k = idx.shape
    n_dst = c if n_dst is None else int(n_dst)
    if not 1 <= k <= 64 or c * k >= 2 ** 31 or chunk < 1:
        raise ValueError(f"a ({c}, {k}) map with chunk {chunk}: the "
                         "transpose takes 1 to 64 slots, fewer than 2**31 "
                         "entries and a positive chunk")
    dev = idx.device
    flat = idx.reshape(-1)
    deg = torch.bincount(flat, minlength=n_dst)  # raises below 0
    if deg.numel() > n_dst:
        raise ValueError(f"the map names rows outside [0, {n_dst})")
    entry = torch.sort(flat, stable=True).indices
    ptr = torch.zeros(n_dst + 1, dtype=torch.int64, device=dev)
    torch.cumsum(deg, 0, out=ptr[1:])
    n_part = (deg + chunk - 1) // chunk
    hub_rows = torch.nonzero(n_part > 1).reshape(-1)
    hub_n = n_part[hub_rows]
    hub_part_ptr = torch.zeros(hub_rows.numel() + 1, dtype=torch.int64,
                               device=dev)
    torch.cumsum(hub_n, 0, out=hub_part_ptr[1:])
    n_parts, max_in_degree = torch.stack(
        [hub_part_ptr[-1], deg.max() if n_dst else deg.new_zeros(())]).tolist()
    part_hub = torch.repeat_interleave(
        torch.arange(hub_rows.numel(), device=dev), hub_n,
        output_size=n_parts)
    part_begin = ptr[hub_rows][part_hub] + chunk * (
        torch.arange(n_parts, device=dev) - hub_part_ptr[part_hub])
    part_end = torch.minimum(part_begin + chunk, ptr[hub_rows + 1][part_hub])
    trace.bump(SMOOTH_MAP, ("transpose",))
    SMOOTH_MAP[("max_in_degree",)] = max(
        SMOOTH_MAP.get(("max_in_degree",), 0), max_in_degree)
    i32 = torch.int32
    return SmoothMap(idx, ptr.to(i32), (entry // k).to(i32),
                     (entry % k).to(torch.uint8), part_begin.to(i32),
                     part_end.to(i32), hub_rows.to(i32),
                     hub_part_ptr.to(i32), chunk, max_in_degree)


def smooth_features(features: torch.Tensor, smooth_map: SmoothMap,
                    perm: torch.Tensor | None = None,
                    generator: torch.Generator | None = None
                    ) -> torch.Tensor:
    """KNN-smoothed, L2-normalized gaussian features
    (GaussianModel.get_smoothed_gaussian_features): normalize each row,
    average it over a subset of its neighbour slots shared by all
    gaussians. The subset is `perm` (slot indices) when given, else the
    first max(int(K * SMOOTH_DROPOUT), 1) slots of a permutation drawn
    from `generator`, else every slot. trase_tpu draws
    the permutation from a jax key; a test passes that one as `perm`.

    features: (N, F); smooth_map: the SmoothMap of an (N, K) map.
    Returns (N, F)."""
    # safe norm: dead slots are all-zero
    normed = features / torch.sqrt(
        torch.sum(features * features, dim=-1, keepdim=True) + 1e-12)
    return smooth_rows(normed, smooth_map, smooth_slots(
        smooth_map.idx.shape[1], perm, generator))


def smooth_slots(k: int, perm: torch.Tensor | None = None,
                 generator: torch.Generator | None = None):
    """The neighbour slots a smoothing averages over: `perm` when given,
    else the first max(int(k * SMOOTH_DROPOUT), 1) slots of a permutation
    drawn from `generator`, else None (every slot)."""
    if perm is None and generator is not None:
        n_sel = max(int(k * SMOOTH_DROPOUT), 1)
        perm = torch.randperm(k, generator=generator,
                              device=generator.device)[:n_sel]
    return perm


def smooth_rows(normed: torch.Tensor, smooth_map: SmoothMap,
                slots: torch.Tensor | None) -> torch.Tensor:
    """Each row of the neighbour map's mean of the `normed` rows it names,
    over the distinct neighbour `slots` (None: every slot); the gradient
    walks the map's transpose, which `smooth_map` carries."""
    if slots is not None:
        slots = slots.to(smooth_map.idx.device)
    if not (torch.is_grad_enabled() and normed.requires_grad):
        return _gather_mean(normed, smooth_map.idx, slots)
    n_dst = smooth_map.rev_ptr.numel() - 1
    if n_dst != normed.shape[0]:
        raise ValueError(f"the map's transpose has {n_dst} rows, normed "
                         f"{normed.shape[0]}")
    return _SmoothRows.apply(normed, smooth_map, slots)


def _gather_mean(normed, idx, slots):
    sel = idx if slots is None else idx[:, slots]
    return normed[sel].mean(dim=1)


class _SmoothRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, normed, smooth_map, slots):
        ctx.smooth_map, ctx.slots = smooth_map, slots
        return _gather_mean(normed, smooth_map.idx, slots)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return (smooth_rows_bwd(grad.contiguous(), ctx.smooth_map, ctx.slots),
                None, None)


def _check_bwd(g: torch.Tensor, smooth_map: SmoothMap):
    c = smooth_map.idx.shape[0]
    if g.dtype != torch.float32 or g.dim() != 2 or g.shape[0] != c:
        raise ValueError(f"g must be ({c}, F) float32, got {g.dtype} "
                         f"{tuple(g.shape)}")


def _slot_on(slots, k: int, dtype, device):
    """k flags of the drawn slots, or None for every slot."""
    if slots is None:
        return None
    return torch.zeros(k, dtype=dtype, device=device).index_fill_(
        0, slots.to(device=device, dtype=torch.int64), 1)


def smooth_rows_bwd(g: torch.Tensor, smooth_map: SmoothMap,
                    slots: torch.Tensor | None) -> torch.Tensor:
    """smooth_rows' gradient in its input rows, (n_dst, F), from the
    smoothed rows' gradient g (C, F): row j gets the sum of g[i] over the
    entries (i, s) of j whose slot s is drawn, divided by the number
    drawn. The kernel on CUDA tensors, the plain version on CPU ones."""
    if g.device.type == "cpu":
        return smooth_rows_bwd_plain(g, smooth_map, slots)
    _check_bwd(g, smooth_map)
    m = smooth_map
    cuda_lib.require_cuda("smooth_rows_bwd", "smooth_rows_bwd_plain", g=g,
                          rev_ptr=m.rev_ptr, rev_src=m.rev_src,
                          rev_slot=m.rev_slot)
    dev = g.device
    k, f = m.idx.shape[1], g.shape[1]
    n_dst = m.rev_ptr.numel() - 1
    on = _slot_on(slots, k, torch.uint8, dev)
    n_sel = k if slots is None else slots.numel()
    grad = torch.empty((n_dst, f), dtype=torch.float32, device=dev)
    partial = torch.empty((m.part_begin.numel(), f), dtype=torch.float32,
                          device=dev)
    cuda_lib.launch(
        cuda_lib.library("smooth_rows_bwd", SIGNATURES).trase_smooth_rows_bwd,
        ("smooth_rows_bwd",), dev, g, n_dst, f, m.rev_ptr, m.rev_src,
        m.rev_slot, m.chunk, m.part_begin, m.part_end, m.part_begin.numel(),
        m.hub_rows, m.hub_part_ptr, m.hub_rows.numel(), on, k, float(n_sel),
        partial, grad)
    return grad


def smooth_rows_bwd_plain(g: torch.Tensor, smooth_map: SmoothMap,
                          slots: torch.Tensor | None) -> torch.Tensor:
    """The same function in plain PyTorch, summed as the kernel sums: each
    row that is no hub, and each hub chunk, in entry order; each hub's
    chunk sums in chunk order."""
    _check_bwd(g, smooth_map)
    m, dev = smooth_map, g.device
    k = m.idx.shape[1]
    on = _slot_on(slots, k, torch.bool, dev)
    take = (torch.ones(k, dtype=torch.bool, device=dev) if on is None
            else on)[m.rev_slot.long()]
    n_sel = k if slots is None else slots.numel()
    ptr = m.rev_ptr.long()
    direct_end = torch.where(ptr[1:] - ptr[:-1] > m.chunk, ptr[:-1], ptr[1:])
    acc = _walk(g, m.rev_src.long(), take,
                torch.cat([m.part_begin.long(), ptr[:-1]]),
                torch.cat([m.part_end.long(), direct_end]),
                min(m.chunk, m.max_in_degree))
    n_parts = m.part_begin.numel()
    grad = acc[n_parts:] / n_sel
    hub_ptr = m.hub_part_ptr.long()
    grad[m.hub_rows.long()] = _walk(
        acc[:n_parts], torch.arange(n_parts, device=dev),
        torch.ones(n_parts, dtype=torch.bool, device=dev), hub_ptr[:-1],
        hub_ptr[1:], -(-m.max_in_degree // m.chunk) if n_parts else 0) / n_sel
    return grad


def _walk(rows, src, take, begin, end, length: int) -> torch.Tensor:
    """For each segment [begin, end) of entries, the sum of rows[src[e]]
    over its entries e with take[e], added in entry order (at most
    `length` entries a segment)."""
    acc = torch.zeros((begin.numel(), rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    for t in range(length):
        e = begin + t
        ok = e < end
        e = torch.where(ok, e, 0)
        ok &= take[e]
        acc = torch.where(ok[:, None], acc + rows[src[e]], acc)
    return acc
