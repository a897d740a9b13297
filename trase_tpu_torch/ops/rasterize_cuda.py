"""Tile binning + the CUDA tile compositor (forward and backward) and the
plain PyTorch version of each kernel.

Counterpart of trase_tpu/ops/rasterize_pallas.py:194-375 (binning) and
:1394-1511 (payload, bf16 feature packing, ``rasterize_tiled_pallas``).
The window / group layout, ``_cumsum_small`` / ``_segment_fill`` and
``slot_of_sorted`` exist for the TPU; here binning yields only the
sorted pair ids and per-tile [start, end) ranges, which equal the JAX
ones exactly: the same int32 rect math, the same composite key
``tile << depth_bits | quantized depth`` sorted stably (as jax.lax.sort
is) with the pair id riding along.

Compositing runs ``csrc/composite_fwd.cu`` (see its header for the
design and its bound on the card) for CUDA tensors, and
``composite_plain`` — the same function in plain PyTorch, tile chunk by
tile chunk — for CPU tensors. Under autograd the forward also keeps its
per-pixel residuals, and the backward runs ``csrc/composite_bwd.cu``:
``composite_bwd`` (pair gradients, counterpart of ``_bwd_group_kernel``)
then ``reduce_pair_grads`` (per-gaussian rows, counterpart of
``_transpose_kernel`` + ``unsort_slot_gradients``), or their plain
versions ``composite_bwd_plain`` / ``reduce_pair_grads_plain`` for CPU
tensors. Nothing falls back from one to the other.

Value layouts: [rgb, features, depth] (``with_color``, the GAUSSIAN step
and serving) or the features alone (``with_color=False``, the FEATURE
step), each with the features unpacked or bf16-packed two per word. The
backward differentiates every layout, also in a values-only mode
(``grad_values_only``): exact zeros for the geometry, the FEATURE step's
after densification ends.

Slab mode (the multi-device steps, trase_tpu_torch/parallel): every
kernel and plain version takes a tile range [t_lo, t_hi) of whole tile
rows, the counterpart of trase_tpu's ``g_lo`` / ``rows_local``. The
forward composites that slab alone, the backward walks it alone and the
reduce sums only its pair range, walking the slab's own pairs, so the
slabs' payload gradients sum to the whole image's. The whole image is the
range of every tile.
``composite_slab`` is the slab entry of ``rasterize_tiled``.

``build_library`` builds every csrc/*.cu source, the fused deform MLP's
(ops/mlp_cuda.py) included, and ``LAYOUT_LAUNCHES`` counts every kernel's
launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch

from ..utils import trace
from .projection import ProjectedGaussians
from .rasterize import TILE, RasterConfig, _tile_grid, _tile_rects, clamp_rect_to_budget
from .rasterize_ref import ALPHA_EPS, ALPHA_MAX, T_EPS

DEPTH_BITS = 19  # depth quantization inside the composite sort key
GEOM_COLS = 6  # mean2d(2) + conic(3) + log opacity(1)
PIX = TILE * TILE

LOG_ALPHA_MAX = float(np.log(ALPHA_MAX))
LOG_ALPHA_EPS = float(np.log(ALPHA_EPS))
LOG_T_EPS = float(np.log(T_EPS))

# (n_val, n_packed, with_color) value layouts the kernels are
# instantiated for: rgb + depth, + 32 features, + 32 bf16-packed features
# (serving), and 32 features alone, unpacked or packed (the FEATURE step);
# each with and without the forward's residuals, and in the backward full
# and values-only, as trase_tpu's backward takes any value layout.
SUPPORTED = frozenset({(4, 0, True), (36, 0, True), (36, 16, True),
                       (32, 0, False), (32, 16, False)})

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {name: os.path.join(_PKG, "csrc", f"{name}.cu")
           for name in ("composite_fwd", "composite_bwd", "deform_mlp")}
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

# Kernel launches made by the wrappers (the CUDA path only), by
# instantiation: one is added where each kernel is launched, nowhere else.
# Keys are (kernel, n_val, n_packed, with_color, residuals or values_only)
# for the compositor kernels, (kernel, words) for the reduce and
# ("deform_mlp",) for the fused deform MLP (ops/mlp_cuda.py); a launch given
# a tile range (slab mode) adds "slab" to its key. The port's counter
# "layout_launches" (utils/trace.py).
LAYOUT_LAUNCHES: dict = trace.counter("layout_launches")

_LIBS: dict = {}


# ------------------------------------------------------------ binning


class TileBins(NamedTuple):
    sorted_pid: torch.Tensor  # (n*K,) int64 pair ids in composite order
    tile_start: torch.Tensor  # (T+1,) int32 first sorted pair of each tile
    overflow: torch.Tensor  # (2,) f32 [dropped at K, would drop at K//2]


def build_tile_bins(proj: ProjectedGaussians, image_height: int,
                    image_width: int, cfg: RasterConfig) -> TileBins:
    """Fixed-K pair expansion, depth-sorted per tile.

    Each gaussian emits up to K = cfg.pairs_per_gaussian (tile, gaussian)
    pairs, row-major over its covered tile rect; rects larger than K
    tiles shrink to an aspect-balanced sub-rect around the projected mean
    and the dropped pairs are counted in `overflow`. Pair p belongs to
    gaussian p // K. Invalid pairs carry the sentinel tile num_tiles and
    sort to the tail, outside every tile's range.
    """
    th, tw = _tile_grid(image_height, image_width)
    num_tiles = th * tw
    K = cfg.pairs_per_gaussian
    dev = proj.mean2d.device

    depth_bits = DEPTH_BITS
    while (num_tiles + 1) > (1 << (32 - depth_bits)):
        depth_bits -= 1
    if depth_bits < 10:
        raise ValueError(
            f"{num_tiles} tiles needs more than 22 key bits; the composite "
            "sort key cannot represent this image size")

    tx0, ty0, rect_w, count = _tile_rects(proj, th, tw)
    x0, y0, w2, count2 = clamp_rect_to_budget(
        tx0, ty0, rect_w, count, proj.mean2d, K)
    _, _, _, count2h = clamp_rect_to_budget(
        tx0, ty0, rect_w, count, proj.mean2d, max(K // 2, 1))
    overflow = torch.stack([
        torch.clamp(count - count2, min=0).sum(),
        torch.clamp(count - count2h, min=0).sum(),
    ]).to(torch.float32)

    ks = torch.arange(K, dtype=torch.int32, device=dev)[None, :]
    tile_x = x0[:, None] + ks % w2[:, None]
    tile_y = y0[:, None] + torch.div(ks, w2[:, None], rounding_mode="floor")
    tile = tile_y * tw + tile_x  # (N, K) int32
    pvalid = ks < count2[:, None]

    if cfg.alpha_cull:
        # a pair whose best-case alpha over the tile is below 1/255 is
        # zeroed by the compositor anyway: alpha <= op exp(-lam_min d^2 / 2)
        # with d the distance from the projected mean to the tile rect
        ca, cb, cc = proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2]
        mid = 0.5 * (ca + cc)
        lam_min = mid - torch.sqrt(torch.clamp(
            (0.5 * (ca - cc)) ** 2 + cb * cb, min=0.0))
        lam_min = torch.clamp(lam_min, min=0.0)[:, None]
        opc = torch.where(proj.valid, proj.opacity,
                          torch.zeros_like(proj.opacity))
        log_opc = torch.log(torch.clamp(opc, min=1e-38))[:, None]
        mx = proj.mean2d[:, 0:1]
        my = proj.mean2d[:, 1:2]
        rx0 = tile_x.to(torch.float32) * TILE
        ry0 = tile_y.to(torch.float32) * TILE
        ddx = torch.minimum(torch.maximum(mx, rx0), rx0 + (TILE - 1)) - mx
        ddy = torch.minimum(torch.maximum(my, ry0), ry0 + (TILE - 1)) - my
        max_alpha_log = log_opc - 0.5 * lam_min * (ddx * ddx + ddy * ddy)
        pvalid = pvalid & (max_alpha_log >= LOG_ALPHA_EPS)

    # Composite key: tile in the high bits, depth quantized over the
    # range of the gaussians that emit pairs in the low bits.
    dvalid = count2 > 0
    depth = proj.depth
    inf = torch.full_like(depth, float("inf"))
    dmin = torch.where(dvalid, depth, inf).min()
    dmax = torch.where(dvalid, depth, -inf).max()
    dmax_q = float((1 << depth_bits) - 1)
    dscale = torch.div(torch.full_like(dmin, dmax_q),
                       torch.clamp(dmax - dmin, min=1e-9))
    dq = torch.clamp((depth - dmin) * dscale, 0.0, dmax_q).to(torch.int64)
    key = (tile.to(torch.int64) << depth_bits) | dq[:, None]
    key = torch.where(pvalid, key,
                      torch.full_like(key, num_tiles << depth_bits))
    sorted_key, sorted_pid = torch.sort(key.reshape(-1), stable=True)
    tile_start = torch.searchsorted(
        sorted_key >> depth_bits,
        torch.arange(num_tiles + 1, dtype=torch.int64, device=dev),
        side="left").to(torch.int32)
    return TileBins(sorted_pid=sorted_pid, tile_start=tile_start,
                    overflow=overflow)


# ------------------------------------------------------------ payload


def build_payload(proj: ProjectedGaussians,
                  extra_channels: torch.Tensor | None,
                  with_color: bool = True):
    """(N, 6 + n_val) per-gaussian float32 table + n_val.

    Row = [mean2d, conic, log opacity | rgb, extra, depth], or with
    with_color=False (the FEATURE step's features-only layout) [mean2d,
    conic, log opacity | extra]. Invalid rows are zeroed (log opacity =
    log 1e-38), so garbage projections never reach exp(). Each pixel's
    depth is sum(w * depth), not normalized.
    """
    if not with_color and extra_channels is None:
        raise ValueError("with_color=False requires extra_channels")
    vmask = proj.valid[:, None]
    opacity = torch.where(proj.valid, proj.opacity,
                          torch.zeros_like(proj.opacity))
    log_op = torch.log(torch.clamp(opacity, min=1e-38))
    geom = torch.cat([proj.mean2d, proj.conic], dim=1)
    cols = [proj.color] if with_color else []
    if extra_channels is not None:
        cols.append(extra_channels)
    if with_color:
        cols.append(proj.depth[:, None])
    vals = torch.cat(cols, dim=1)
    zero = torch.zeros((), dtype=geom.dtype, device=geom.device)
    payload = torch.cat([torch.where(vmask, geom, zero), log_op[:, None],
                         torch.where(vmask, vals, zero)], dim=1)
    return payload.contiguous(), vals.shape[1]


def _plain_words(with_color: bool) -> int:
    """Unpacked value words ahead of the packed ones: rgb + depth."""
    return 4 if with_color else 0


def row_words(n_val: int, n_packed: int, with_color: bool = True) -> int:
    """float32 words per payload row in the kernel's layout."""
    if n_packed:
        return GEOM_COLS + _plain_words(with_color) + n_packed
    return GEOM_COLS + n_val


def pack_feature_words(payload: torch.Tensor, n_val: int, n_packed: int,
                       with_color: bool = True) -> torch.Tensor:
    """[geom 6 | rgb, feats 2P, depth] -> [geom 6 | rgb, depth, P words],
    or features-only [geom 6 | feats 2P] -> [geom 6 | P words]: word r
    carries feats[r] as bf16 (round to nearest even, as JAX's
    astype(bfloat16)) in its low half and feats[r + P] in its high half.
    Not differentiable (bit reinterpretation)."""
    n = payload.shape[0]
    g = GEOM_COLS
    f0 = g + (3 if with_color else 0)  # first feature column
    bf = payload[:, f0:f0 + 2 * n_packed].to(torch.bfloat16)
    words = torch.stack([bf[:, :n_packed], bf[:, n_packed:]], dim=-1)
    words = words.reshape(n, 2 * n_packed).contiguous().view(torch.float32)
    if not with_color:
        return torch.cat([payload[:, :g], words], dim=1).contiguous()
    return torch.cat([payload[:, :g + 3], payload[:, g + n_val - 1:g + n_val],
                      words], dim=1).contiguous()


def unpack_values(payload: torch.Tensor, n_val: int, n_packed: int,
                  with_color: bool = True) -> torch.Tensor:
    """(N, n_val) float32 values ([rgb, feats, depth], or [feats] without
    colour) of a kernel-layout payload (inverse of pack_feature_words on
    the value words)."""
    g = GEOM_COLS
    if not n_packed:
        return payload[:, g:g + n_val]
    w0 = g + _plain_words(with_color)  # first packed word
    bf = payload[:, w0:w0 + n_packed].contiguous().view(torch.bfloat16)
    feats = [bf[:, 0::2].float(), bf[:, 1::2].float()]
    if not with_color:
        return torch.cat(feats, dim=1)
    return torch.cat([payload[:, g:g + 3], *feats, payload[:, g + 3:g + 4]],
                     dim=1)


# --------------------------------------------------------- compositing


def _check_inputs(payload, sorted_gauss, tile_start, image_height,
                  image_width, n_val, n_packed, with_color=True):
    th, tw = _tile_grid(image_height, image_width)
    if payload.dtype != torch.float32 or payload.dim() != 2:
        raise ValueError("payload must be a 2-D float32 tensor")
    words = row_words(n_val, n_packed, with_color)
    if payload.shape[1] != words:
        raise ValueError(f"payload rows have {payload.shape[1]} words, the "
                         f"layout ({n_val}, {n_packed}, with_color="
                         f"{with_color}) needs {words}")
    if sorted_gauss.dtype != torch.int32 or tile_start.dtype != torch.int32:
        raise ValueError("sorted_gauss and tile_start must be int32")
    if tile_start.shape != (th * tw + 1,):
        raise ValueError(f"tile_start has shape {tuple(tile_start.shape)}, "
                         f"the {th}x{tw} tile grid needs ({th * tw + 1},)")
    if n_packed and n_val != _plain_words(with_color) + 2 * n_packed:
        raise ValueError(f"packed layout needs n_val == "
                         f"{_plain_words(with_color)} + 2 * n_packed")
    devs = {payload.device, sorted_gauss.device, tile_start.device}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    return th, tw


def tile_range(th: int, tw: int, image_height: int, t_lo: int = 0,
               t_hi: int | None = None):
    """(t_hi, row0, rows) of the tile range [t_lo, t_hi) of a th x tw
    grid (t_hi None: the last tile): whole tile rows, whose output starts at
    image row row0 and holds `rows` rows inside image_height."""
    t_hi = th * tw if t_hi is None else t_hi
    if not 0 <= t_lo < t_hi <= th * tw or t_lo % tw or t_hi % tw:
        raise ValueError(f"tile range [{t_lo}, {t_hi}) is not whole tile "
                         f"rows of the {th}x{tw} grid")
    row0 = t_lo // tw * TILE
    return t_hi, row0, min(t_hi // tw * TILE, image_height) - row0


def _tile_origins(tiles: torch.Tensor, tw: int):
    ox = ((tiles % tw) * TILE).to(torch.float32)[:, None]
    oy = (torch.div(tiles, tw, rounding_mode="floor")
          * TILE).to(torch.float32)[:, None]
    return ox, oy


def _pixel_coords(dev):
    pix = torch.arange(PIX, device=dev)
    fx = (pix % TILE).to(torch.float32)
    fy = torch.div(pix, TILE, rounding_mode="floor").to(torch.float32)
    return fx, fy


def composite_plain(payload: torch.Tensor, sorted_gauss: torch.Tensor,
                    tile_start: torch.Tensor, image_height: int,
                    image_width: int, n_val: int, n_packed: int = 0,
                    with_color: bool = True, tile_chunk: int = 2048,
                    stats: dict | None = None, residuals: bool = False,
                    t_lo: int = 0, t_hi: int | None = None):
    """Plain PyTorch version of the CUDA compositor: same inputs, same
    output (H, W, 1 + n_val) = [acc, values...], same expressions in the
    same order (log-space T, skip below 1/255, stop before T < 1e-4).
    With a tile range [t_lo, t_hi) of whole tile rows (slab mode), only
    those tiles: (rows, W, 1 + n_val) from image row t_lo // tw * 16, and
    residuals by slab tile.

    Walks the pairs by rank within their tile, all tiles of a chunk at
    once, so memory is bounded by `tile_chunk` x 256 pixels. With
    `stats`, adds the pair-pixel evaluations ("evaluated": pixel not yet
    stopped) and contributions ("contributing") to it. With `residuals`,
    returns (out, logt, stop) as the kernel's residual instantiation
    does: per pixel of the padded tile grid (num_tiles * 256, tile-major,
    pixel y * 16 + x), log T after its last contributing pair (float32)
    and the index within its tile's pair range of the pair that stopped
    it, or the range's length (int32).
    """
    th, tw = _check_inputs(payload, sorted_gauss, tile_start, image_height,
                           image_width, n_val, n_packed, with_color)
    t_hi, _, rows = tile_range(th, tw, image_height, t_lo, t_hi)
    dev = payload.device
    num_tiles = t_hi - t_lo
    geom = payload[:, :GEOM_COLS]
    vals = unpack_values(payload, n_val, n_packed, with_color)
    fx, fy = _pixel_coords(dev)
    starts = tile_start[t_lo:t_hi].long()
    lens = (tile_start[t_lo + 1:t_hi + 1] - tile_start[t_lo:t_hi]).long()
    last = max(sorted_gauss.shape[0] - 1, 0)
    out = torch.zeros((num_tiles, PIX, 1 + n_val), dtype=torch.float32,
                      device=dev)
    res_logt = torch.zeros((num_tiles, PIX), dtype=torch.float32, device=dev)
    res_stop = torch.zeros((num_tiles, PIX), dtype=torch.int32, device=dev)
    evaluated = contributing = 0
    for t0 in range(0, num_tiles, tile_chunk):
        t1 = min(num_tiles, t0 + tile_chunk)
        tiles = torch.arange(t_lo + t0, t_lo + t1, device=dev)
        ln, st = lens[t0:t1], starts[t0:t1]
        ox, oy = _tile_origins(tiles, tw)
        n_t = t1 - t0
        logt = torch.zeros((n_t, PIX), dtype=torch.float32, device=dev)
        acc = torch.zeros_like(logt)
        val = torch.zeros((n_t, PIX, n_val), dtype=torch.float32, device=dev)
        done = torch.zeros((n_t, PIX), dtype=torch.bool, device=dev)
        stop_at = ln[:, None].expand(n_t, PIX).clone()
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        max_len = int(ln.max()) if n_t else 0
        for j in range(max_len):
            active = (j < ln)[:, None]
            g = sorted_gauss[torch.clamp(st + j, max=last)].long()
            row = geom[g]
            dx = (row[:, 0:1] - ox) - fx
            dy = (row[:, 1:2] - oy) - fy
            ca, cb, cc = row[:, 2:3], row[:, 3:4], row[:, 4:5]
            raw = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy \
                + row[:, 5:6]
            alog = torch.clamp(raw, max=LOG_ALPHA_MAX)
            pending = active & ~done
            ok = pending & (alog >= LOG_ALPHA_EPS)
            alpha = torch.where(ok, torch.exp(alog), zero)
            nxt = logt + torch.log1p(-alpha)
            stop = ok & ~(nxt >= LOG_T_EPS)
            live = ok & ~stop
            done = done | stop
            stop_at = torch.where(stop, j, stop_at)
            w = torch.where(live, torch.exp(alog + logt), zero)
            acc = acc + w
            val = val + w[..., None] * vals[g][:, None, :]
            logt = torch.where(live, nxt, logt)
            if stats is not None:
                evaluated += int(pending.sum())
                contributing += int(live.sum())
            if j % 8 == 7 and bool((done | (ln <= j + 1)[:, None]).all()):
                break
        out[t0:t1, :, 0] = acc
        out[t0:t1, :, 1:] = val
        res_logt[t0:t1] = logt
        res_stop[t0:t1] = stop_at.to(torch.int32)
    if stats is not None:
        stats["evaluated"] = stats.get("evaluated", 0) + evaluated
        stats["contributing"] = stats.get("contributing", 0) + contributing
    img = out.reshape(-1, tw, TILE, TILE, 1 + n_val).permute(0, 2, 1, 3, 4)
    img = img.reshape(-1, tw * TILE, 1 + n_val)[:rows, :image_width]
    if residuals:
        return img, res_logt.reshape(-1), res_stop.reshape(-1)
    return img


def _tile_cotangent(grad_out: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """(H, W, C) image (or slab) cotangent -> (th * tw, 256, C), zero
    outside the image."""
    h, w, c = grad_out.shape
    pad = torch.zeros((th * TILE, tw * TILE, c), dtype=grad_out.dtype,
                      device=grad_out.device)
    pad[:h, :w] = grad_out
    return pad.reshape(th, TILE, tw, TILE, c).permute(0, 2, 1, 3, 4).reshape(
        th * tw, PIX, c)


def composite_bwd_plain(payload: torch.Tensor, sorted_gauss: torch.Tensor,
                        tile_start: torch.Tensor, image_height: int,
                        image_width: int, n_val: int, n_packed: int,
                        grad_out: torch.Tensor, res_logt: torch.Tensor,
                        res_stop: torch.Tensor, tile_chunk: int = 2048,
                        stats: dict | None = None, with_color: bool = True,
                        values_only: bool = False, t_lo: int = 0,
                        t_hi: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel (composite_bwd.cu):
    (n_pairs, 6 + n_val) pair gradients [d mean2d, d conic, d log op,
    d values], row i for the pair at sorted position i. Rows of pairs at
    or past a tile's largest stop, and of invalid pairs, are zero. With
    `values_only`, the 6 geometry columns are exactly zero and the value
    columns are the full mode's.

    Same per-pixel expressions in the same order as the kernel, walking
    the ranks in reverse from each tile's largest stop index, all tiles
    of a chunk at once; only the 256-pixel sums associate differently.
    With `stats`, adds the pair-pixel evaluations ("evaluated": below the
    tile's largest stop), counted pair-pixels ("counted") and (pair, warp)
    steps with a counted lane ("warp_steps": the pair's sums the kernel's
    warps take, a warp being 32 consecutive pixels of the tile) to it, and
    sets "logt_first": each pixel's log T reconstructed back to the tile's
    first pair (0 up to rounding).

    With a tile range [t_lo, t_hi) (slab mode): grad_out and the residuals
    are the slab's, as composite_plain returns them for that range, and
    only the rows of the slab's pairs, sorted positions [tile_start[t_lo],
    tile_start[t_hi]), can be non-zero.
    """
    th, tw = _check_inputs(payload, sorted_gauss, tile_start, image_height,
                           image_width, n_val, n_packed, with_color)
    t_hi, _, _ = tile_range(th, tw, image_height, t_lo, t_hi)
    dev = payload.device
    num_tiles = t_hi - t_lo
    words = GEOM_COLS + n_val
    geom = payload[:, :GEOM_COLS]
    vals = unpack_values(payload, n_val, n_packed, with_color)
    fx, fy = _pixel_coords(dev)
    g_all = _tile_cotangent(grad_out, num_tiles // tw, tw)
    logt_all = res_logt.reshape(num_tiles, PIX)
    stop_all = res_stop.reshape(num_tiles, PIX).long()
    starts = tile_start[t_lo:t_hi].long()
    last = max(sorted_gauss.shape[0] - 1, 0)
    dpair = torch.zeros((sorted_gauss.shape[0], words), dtype=torch.float32,
                        device=dev)
    logt_first = torch.zeros((num_tiles, PIX), dtype=torch.float32,
                             device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    evaluated = counted_n = warp_steps = 0
    for t0 in range(0, num_tiles, tile_chunk):
        t1 = min(num_tiles, t0 + tile_chunk)
        tiles = torch.arange(t_lo + t0, t_lo + t1, device=dev)
        st = starts[t0:t1]
        ox, oy = _tile_origins(tiles, tw)
        g = g_all[t0:t1]
        stop = stop_all[t0:t1]
        logt = logt_all[t0:t1].clone()
        suffix = torch.zeros_like(logt)
        max_stop = stop.max(dim=1).values
        top = int(max_stop.max())
        for j in range(top - 1, -1, -1):
            active = j < max_stop
            gi = sorted_gauss[torch.clamp(st + j, max=last)].long()
            row = geom[gi]
            v = vals[gi]
            dx = (row[:, 0:1] - ox) - fx
            dy = (row[:, 1:2] - oy) - fy
            ca, cb, cc = row[:, 2:3], row[:, 3:4], row[:, 4:5]
            raw = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy \
                + row[:, 5:6]
            alog = torch.clamp(raw, max=LOG_ALPHA_MAX)
            counted = (j < stop) & (alog >= LOG_ALPHA_EPS)
            alpha = torch.where(counted, torch.exp(alog), zero)
            before = logt - torch.log1p(-alpha)
            t = torch.exp(before)
            w = alpha * t
            d = []
            if not values_only:
                q = g[..., 0]
                for c in range(n_val):
                    q = q + g[..., 1 + c] * v[:, c:c + 1]
                dalpha = q * t - suffix / (1.0 - alpha)
                suffix = torch.where(counted, suffix + q * w, suffix)
                dpow = torch.where(counted & (raw < LOG_ALPHA_MAX),
                                   dalpha * alpha, zero)
                d = [dpow * -(ca * dx + cb * dy),
                     dpow * -(cc * dy + cb * dx), dpow * (-0.5 * dx * dx),
                     dpow * -(dx * dy), dpow * (-0.5 * dy * dy), dpow]
            logt = torch.where(counted, before, logt)
            d += [torch.where(counted, g[..., 1 + c] * w, zero)
                  for c in range(n_val)]
            sums = torch.stack([x.sum(dim=1) for x in d], dim=1)
            first = GEOM_COLS if values_only else 0
            dpair[(st + j)[active], first:] = sums[active]
            if stats is not None:
                evaluated += PIX * int(active.sum())
                counted_n += int(counted.sum())
                warp_steps += int(counted.reshape(-1, PIX // 32, 32).any(
                    dim=2).sum())
        logt_first[t0:t1] = logt
    if stats is not None:
        stats["evaluated"] = stats.get("evaluated", 0) + evaluated
        stats["counted"] = stats.get("counted", 0) + counted_n
        stats["warp_steps"] = stats.get("warp_steps", 0) + warp_steps
        stats["logt_first"] = logt_first.reshape(-1)
    return dpair


def inverse_pairs(sorted_pid: torch.Tensor) -> torch.Tensor:
    """int32 inverse of the pair sort: inv[pid] = sorted position of pair
    pid (one index_put, where JAX inverts by a second sort)."""
    n = sorted_pid.shape[0]
    inv = torch.empty(n, dtype=torch.int32, device=sorted_pid.device)
    inv[sorted_pid] = torch.arange(n, dtype=torch.int32,
                                   device=sorted_pid.device)
    return inv


def reduce_pair_grads_plain(dpair: torch.Tensor, inv: torch.Tensor,
                            tile_start: torch.Tensor, n: int, t_lo: int = 0,
                            t_hi: int | None = None,
                            sorted_gauss: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Plain PyTorch version of the reduce kernel: (n, words) per-gaussian
    gradients, gaussian g summing, in k order, the rows at sorted
    positions inv[g K + k]; positions outside [tile_start[t_lo],
    tile_start[t_hi]) read zero: with the default range, those at or past
    tile_start[-1] (invalid pairs); with a slab's, every other slab's.
    `sorted_gauss` (the kernel's slab walk reads it) is not needed here:
    the argument keeps the two signatures alike."""
    k = inv.shape[0] // n
    pos = inv.long().reshape(n, k)
    hi = tile_start[-1 if t_hi is None else t_hi].long()
    valid = (pos >= tile_start[t_lo].long()) & (pos < hi)
    rows = dpair[torch.clamp(pos, max=dpair.shape[0] - 1)]
    zero = torch.zeros((), dtype=dpair.dtype, device=dpair.device)
    acc = torch.zeros((n, dpair.shape[1]), dtype=dpair.dtype,
                      device=dpair.device)
    for r in range(k):
        acc = acc + torch.where(valid[:, r:r + 1], rows[:, r], zero)
    return acc


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    home = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if nvcc is None and os.path.exists(home):
        nvcc = home
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "trase_tpu_torch/csrc at first use")
    return nvcc


def _library_path(name: str) -> str:
    with open(SOURCES[name], "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build_library(names=None) -> dict:
    """Compile the csrc/*.cu sources for sm_90a into BUILD_DIR, one nvcc
    per source, all started together; each library's name carries its
    source's hash, so a library is built once per source content.
    Returns {name: (library path, build seconds, nvcc output)}; seconds
    and output are 0 and "" for a library that was already built."""
    names = tuple(SOURCES) if names is None else tuple(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    result, running = {}, {}
    for name in names:
        path = _library_path(name)
        if os.path.exists(path):
            result[name] = (path, 0.0, "")
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCES[name]]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, path, tmp, time.perf_counter())
    failed = []
    for name, (proc, path, tmp, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        result[name] = (path, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return result


_ARGTYPES = {
    "composite_fwd": ("trase_composite_fwd",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                      + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 4),
    "composite_bwd": ("trase_composite_bwd",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                      + [ctypes.c_void_p] * 3 + [ctypes.c_float] * 2
                      + [ctypes.c_void_p] * 3),
    "deform_mlp": ("trase_deform_mlp",
                   [ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 8),
}


def _library(name: str):
    lib = _LIBS.get(name)
    if lib is None:
        path = build_library([name])[name][0]
        lib = ctypes.CDLL(path)
        fn_name, argtypes = _ARGTYPES[name]
        getattr(lib, fn_name).argtypes = argtypes
        getattr(lib, fn_name).restype = ctypes.c_int
        if name == "composite_bwd":
            lib.trase_reduce_pair_grads.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                + [ctypes.c_void_p] * 2)
            lib.trase_reduce_pair_grads.restype = ctypes.c_int
            lib.trase_reduce_slab_pairs.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                + [ctypes.c_void_p] * 2)
            lib.trase_reduce_slab_pairs.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def _require_cuda(name: str, plain: str, **tensors):
    for tname, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} takes CUDA tensors; the CPU path is "
                             f"{plain}")
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _count_layout(key):
    trace.bump(LAYOUT_LAUNCHES, key)


def _slab_key(key, t_hi):
    return key + ("slab",) if t_hi is not None else key


def composite_fwd(payload: torch.Tensor, sorted_gauss: torch.Tensor,
                  tile_start: torch.Tensor, image_height: int,
                  image_width: int, n_val: int, n_packed: int = 0,
                  with_color: bool = True, residuals: bool = False,
                  t_lo: int = 0, t_hi: int | None = None):
    """Launch the CUDA compositor on CUDA tensors: (H, W, 1 + n_val)
    float32 [acc, values...], or with `residuals` (out, logt, stop) as
    composite_plain returns them, for the whole image or the slab of tiles
    [t_lo, t_hi). Raises for CPU tensors, for value layouts without a
    kernel instantiation and when the launch fails."""
    _require_cuda("composite_fwd", "composite_plain", payload=payload,
                  sorted_gauss=sorted_gauss, tile_start=tile_start)
    layout = (n_val, n_packed, with_color)
    if layout not in SUPPORTED:
        raise ValueError(f"no kernel instantiation for (n_val, n_packed, "
                         f"with_color)={layout}; have {sorted(SUPPORTED)}")
    th, tw = _check_inputs(payload, sorted_gauss, tile_start, image_height,
                           image_width, n_val, n_packed, with_color)
    if payload.data_ptr() % 8:
        raise ValueError("payload must be 8-byte aligned (the kernel copies "
                         "rows 8 bytes at a time)")
    hi, row0, rows = tile_range(th, tw, image_height, t_lo, t_hi)
    lib = _library("composite_fwd")
    dev = payload.device
    out = torch.empty((rows, image_width, 1 + n_val),
                      dtype=torch.float32, device=dev)
    res_logt = res_stop = None
    if residuals:
        res_logt = torch.empty((hi - t_lo) * PIX, dtype=torch.float32,
                               device=dev)
        res_stop = torch.empty((hi - t_lo) * PIX, dtype=torch.int32,
                               device=dev)
    with torch.cuda.device(dev):
        rc = lib.trase_composite_fwd(
            payload.data_ptr(), sorted_gauss.data_ptr(),
            tile_start[t_lo:].data_ptr(), hi - t_lo, tw, row0 // TILE, rows,
            image_width, n_val, n_packed, int(with_color), LOG_ALPHA_MAX,
            LOG_ALPHA_EPS, LOG_T_EPS, out.data_ptr(),
            None if res_logt is None else res_logt.data_ptr(),
            None if res_stop is None else res_stop.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"composite_fwd launch failed: cudaError {rc}")
    _count_layout(_slab_key(("composite_fwd", *layout, residuals), t_hi))
    if residuals:
        return out, res_logt, res_stop
    return out


def composite_bwd(payload: torch.Tensor, sorted_gauss: torch.Tensor,
                  tile_start: torch.Tensor, image_height: int,
                  image_width: int, n_val: int, n_packed: int,
                  grad_out: torch.Tensor, res_logt: torch.Tensor,
                  res_stop: torch.Tensor,
                  logt_first: torch.Tensor | None = None,
                  with_color: bool = True,
                  values_only: bool = False, t_lo: int = 0,
                  t_hi: int | None = None) -> torch.Tensor:
    """Launch the backward kernel on CUDA tensors: (n_pairs, 6 + n_val)
    pair gradients as composite_bwd_plain returns them, except that rows
    of invalid pairs (past tile_start[-1]) are left unwritten, and so, with
    a tile range [t_lo, t_hi) (slab mode: the slab's cotangent and
    residuals), are the rows of every pair outside the slab. With
    `logt_first` (256 float32 per tile of the range), the kernel also
    writes each pixel's log T reconstructed back to its tile's first pair.
    With `values_only`, the geometry columns are exact zeros."""
    _require_cuda("composite_bwd", "composite_bwd_plain", payload=payload,
                  sorted_gauss=sorted_gauss, tile_start=tile_start,
                  grad_out=grad_out, res_logt=res_logt, res_stop=res_stop)
    layout = (n_val, n_packed, with_color)
    if layout not in SUPPORTED:
        raise ValueError(f"no backward instantiation for (n_val, n_packed, "
                         f"with_color)={layout}; have {sorted(SUPPORTED)}, "
                         "full and values-only")
    th, tw = _check_inputs(payload, sorted_gauss, tile_start, image_height,
                           image_width, n_val, n_packed, with_color)
    hi, row0, rows = tile_range(th, tw, image_height, t_lo, t_hi)
    if grad_out.shape != (rows, image_width, 1 + n_val) or \
            grad_out.dtype != torch.float32:
        raise ValueError(f"grad_out must be float32 ({rows}, {image_width}, "
                         f"{1 + n_val})")
    if res_logt.shape != ((hi - t_lo) * PIX,) or \
            res_stop.dtype != torch.int32:
        raise ValueError("residuals must be (tiles * 256,) float32 / int32")
    lib = _library("composite_bwd")
    dev = payload.device
    dpair = torch.empty((sorted_gauss.shape[0], GEOM_COLS + n_val),
                        dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.trase_composite_bwd(
            payload.data_ptr(), sorted_gauss.data_ptr(),
            tile_start[t_lo:].data_ptr(), hi - t_lo, tw, row0 // TILE, rows,
            image_width, n_val, n_packed, int(with_color), int(values_only),
            grad_out.data_ptr(), res_logt.data_ptr(),
            res_stop.data_ptr(), LOG_ALPHA_MAX, LOG_ALPHA_EPS,
            dpair.data_ptr(),
            None if logt_first is None else logt_first.data_ptr(),
            _stream(dev))
    if rc != 0:
        raise RuntimeError(f"composite_bwd launch failed: cudaError {rc}")
    _count_layout(_slab_key(("composite_bwd", *layout, values_only), t_hi))
    return dpair


def reduce_pair_grads(dpair: torch.Tensor, inv: torch.Tensor,
                      tile_start: torch.Tensor, n: int, t_lo: int = 0,
                      t_hi: int | None = None,
                      sorted_gauss: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Launch the reduce kernel on CUDA tensors: (n, words) per-gaussian
    gradients as reduce_pair_grads_plain returns them, over the pair range
    of the whole image, or of the slab of tiles [t_lo, t_hi), where the
    slab's own pairs are walked (reduce_slab_pairs_kernel, which takes the
    sorted pairs' gaussians, `sorted_gauss`)."""
    _require_cuda("reduce_pair_grads", "reduce_pair_grads_plain",
                  dpair=dpair, inv=inv, tile_start=tile_start)
    if t_hi is not None:
        if sorted_gauss is None:
            raise ValueError("a slab's reduce takes sorted_gauss")
        _require_cuda("reduce_pair_grads", "reduce_pair_grads_plain",
                      sorted_gauss=sorted_gauss)
        if sorted_gauss.dtype != torch.int32 or \
                sorted_gauss.shape != inv.shape:
            raise ValueError("sorted_gauss must be int32, one per pair")
    if inv.dtype != torch.int32 or tile_start.dtype != torch.int32 or \
            dpair.dtype != torch.float32:
        raise ValueError("inv and tile_start must be int32, dpair float32")
    if n <= 0 or inv.shape[0] % n or inv.shape[0] != dpair.shape[0]:
        raise ValueError(f"{inv.shape[0]} pairs do not split over {n} "
                         "gaussians or do not match dpair")
    words = dpair.shape[1]
    hi = tile_start.shape[0] - 1 if t_hi is None else t_hi
    if not 0 <= t_lo < hi < tile_start.shape[0]:
        raise ValueError(f"tile range [{t_lo}, {hi}) outside the "
                         f"{tile_start.shape[0] - 1} tiles")
    if words % 2 or words > 64:
        raise ValueError(f"the reduce kernel sums rows of an even number of "
                         f"words up to 64 (float2 lanes), not {words}")
    lib = _library("composite_bwd")
    dev = dpair.device
    out = torch.empty((n, words), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        if t_hi is None:
            rc = lib.trase_reduce_pair_grads(
                dpair.data_ptr(), inv.data_ptr(), tile_start.data_ptr(),
                tile_start[hi:].data_ptr(), n, inv.shape[0] // n, words,
                out.data_ptr(), _stream(dev))
        else:
            rc = lib.trase_reduce_slab_pairs(
                dpair.data_ptr(), sorted_gauss.data_ptr(), inv.data_ptr(),
                tile_start[t_lo:].data_ptr(), tile_start[hi:].data_ptr(), n,
                inv.shape[0] // n, words, out.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"reduce_pair_grads launch failed: cudaError {rc}")
    _count_layout(_slab_key(("reduce_pair_grads", words), t_hi))
    return out


def composite(payload, sorted_gauss, tile_start, image_height, image_width,
              n_val, n_packed=0, with_color=True, residuals=False, t_lo=0,
              t_hi=None):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = composite_plain if payload.device.type == "cpu" else composite_fwd
    return fn(payload, sorted_gauss, tile_start, image_height, image_width,
              n_val, n_packed, with_color=with_color, residuals=residuals,
              t_lo=t_lo, t_hi=t_hi)


class _Composite(torch.autograd.Function):
    """The compositor under autograd: the forward keeps the per-pixel
    residuals, the backward emits the (N, 6 + n_val) payload gradient
    through composite_bwd + reduce_pair_grads (CUDA tensors) or their
    plain versions (CPU tensors); with `values_only`, its geometry columns
    are zero. With a tile range (t_hi not None), the slab's image and its
    share of the payload gradient. Counterpart of pallas_composite's custom
    VJP (rasterize_pallas.py:1322-1391)."""

    @staticmethod
    def forward(ctx, payload, sorted_gauss, sorted_pid, tile_start,
                image_height, image_width, n_val, n_packed, with_color,
                values_only, t_lo, t_hi):
        kpay = (pack_feature_words(payload, n_val, n_packed, with_color)
                if n_packed else payload)
        out, logt, stop = composite(kpay, sorted_gauss, tile_start,
                                    image_height, image_width, n_val,
                                    n_packed, with_color, residuals=True,
                                    t_lo=t_lo, t_hi=t_hi)
        ctx.save_for_backward(kpay, sorted_gauss, sorted_pid, tile_start,
                              logt, stop)
        ctx.dims = (image_height, image_width, n_val, n_packed,
                    payload.shape[0], with_color, values_only, t_lo, t_hi)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        with trace.span("trase.composite.backward"):
            kpay, sorted_gauss, sorted_pid, tile_start, logt, stop = \
                ctx.saved_tensors
            image_height, image_width, n_val, n_packed, n, with_color, \
                values_only, t_lo, t_hi = ctx.dims
            grad_out = grad_out.contiguous()
            args = (kpay, sorted_gauss, tile_start, image_height, image_width,
                    n_val, n_packed, grad_out, logt, stop)
            mode = dict(with_color=with_color, values_only=values_only,
                        t_lo=t_lo, t_hi=t_hi)
            inv = inverse_pairs(sorted_pid)
            if kpay.device.type == "cpu":
                dpair = composite_bwd_plain(*args, **mode)
                dpayload = reduce_pair_grads_plain(dpair, inv, tile_start, n,
                                                   t_lo, t_hi)
            else:
                dpair = composite_bwd(*args, **mode)
                dpayload = reduce_pair_grads(dpair, inv, tile_start, n, t_lo,
                                             t_hi, sorted_gauss=sorted_gauss)
            return (dpayload,) + (None,) * 11


class CompositeInputs(NamedTuple):
    payload: torch.Tensor  # (N, 6 + n_val) float32, values unpacked
    sorted_gauss: torch.Tensor  # (n*K,) int32 gaussian of each sorted pair
    sorted_pid: torch.Tensor  # (n*K,) int64 pair id of each sorted pair
    tile_start: torch.Tensor  # (T+1,) int32
    n_val: int
    n_packed: int  # > 0: the kernel composites bf16-packed features
    overflow: torch.Tensor  # (2,) f32
    with_color: bool  # False: the values are the features alone


def composite_inputs(proj: ProjectedGaussians,
                     extra_channels: torch.Tensor | None, image_height: int,
                     image_width: int, cfg: RasterConfig = RasterConfig(),
                     with_color: bool = True) -> CompositeInputs:
    """Binning, payload and the packing decision: what the compositor
    takes. Features pack when cfg.pack_features is set and their count
    is even (pack_feature_words turns the payload into the kernel's
    packed layout)."""
    bins = build_tile_bins(proj, image_height, image_width, cfg)
    payload, n_val = build_payload(proj, extra_channels, with_color)
    n_packed = 0
    if (cfg.pack_features and extra_channels is not None
            and extra_channels.shape[1] % 2 == 0):
        n_packed = extra_channels.shape[1] // 2
    sorted_gauss = torch.div(bins.sorted_pid, cfg.pairs_per_gaussian,
                             rounding_mode="floor").to(torch.int32)
    return CompositeInputs(payload, sorted_gauss, bins.sorted_pid,
                           bins.tile_start, n_val, n_packed, bins.overflow,
                           with_color)


def check_card_backward(layout, values_only: bool = False) -> None:
    """Raise NotImplementedError for a (n_val, n_packed, with_color)
    layout that has no backward kernel on the card: one the forward has
    no kernel for either. Every forward layout differentiates, full and
    values-only (`values_only` is accepted for each)."""
    if tuple(layout) not in SUPPORTED:
        raise NotImplementedError(
            f"no compositor kernel on the card for (n_val, n_packed, "
            f"with_color)={tuple(layout)}, values_only={values_only}: the "
            f"forward and backward cover {sorted(SUPPORTED)}")


def composite_image(ci: CompositeInputs, image_height: int,
                    image_width: int, grad_values_only: bool = False,
                    t_lo: int = 0, t_hi: int | None = None) -> torch.Tensor:
    """The [acc | values] image (H, W, 1 + n_val) of composite_inputs'
    `ci`, or with a tile range the slab's rows; under autograd (the payload
    requires grad) the forward keeps its residuals for the backward
    kernels."""
    if torch.is_grad_enabled() and ci.payload.requires_grad:
        if ci.payload.device.type == "cuda":
            check_card_backward((ci.n_val, ci.n_packed, ci.with_color),
                                grad_values_only)
        return _Composite.apply(ci.payload, ci.sorted_gauss, ci.sorted_pid,
                                ci.tile_start, image_height, image_width,
                                ci.n_val, ci.n_packed, ci.with_color,
                                grad_values_only, t_lo, t_hi)
    payload = (pack_feature_words(ci.payload, ci.n_val, ci.n_packed,
                                  ci.with_color)
               if ci.n_packed else ci.payload)
    return composite(payload, ci.sorted_gauss, ci.tile_start, image_height,
                     image_width, ci.n_val, ci.n_packed, ci.with_color,
                     t_lo=t_lo, t_hi=t_hi)


def image_outputs(hwc: torch.Tensor, overflow: torch.Tensor,
                  bg_color: torch.Tensor, with_color: bool,
                  with_extra: bool) -> dict:
    """rasterize_tiled's output dict from the [acc | values] image."""
    acc = hwc[..., 0]
    result = {
        "alpha": acc[None],
        "overflow": overflow[0],
        "overflow_half": overflow[1],
    }
    if with_color:
        rgb = hwc[..., 1:4] + (1.0 - acc)[..., None] * bg_color[None, None, :]
        result["render"] = rgb.permute(2, 0, 1)
        result["depth"] = hwc[..., -1][None]
    else:
        result["feats_acc_hwc"] = hwc
    if with_extra:
        feats_hwc = hwc[..., 4:-1] if with_color else hwc[..., 1:]
        result["feats_hwc"] = feats_hwc
        result["feats"] = feats_hwc.permute(2, 0, 1)
    return result


def rasterize_tiled(
    proj: ProjectedGaussians,
    extra_channels: torch.Tensor | None,
    bg_color: torch.Tensor,
    image_height: int,
    image_width: int,
    cfg: RasterConfig = RasterConfig(),
    with_color: bool = True,
    grad_values_only: bool = False,
):
    """Counterpart of rasterize_tiled_pallas: render (3,H,W), depth
    (1,H,W), alpha (1,H,W), overflow, overflow_half and, with
    extra_channels (N, F), feats (F,H,W) + feats_hwc (H,W,F). rgb gets
    the background (render = rgb + (1 - acc) bg); features do not.
    Differentiable in every projected input when autograd records: the
    forward then keeps its residuals for the backward kernels.

    with_color=False (requires extra_channels) composites only the
    features and alpha, the FEATURE step's path: no render / depth, and
    feats_acc_hwc, the unsliced (H, W, 1 + F) [acc | feats] image.
    grad_values_only=True promises that only the value gradients (the
    features') are consumed: the backward then emits exact zeros for
    mean2d, conic and opacity and skips their chain."""
    ci = composite_inputs(proj, extra_channels, image_height, image_width,
                          cfg, with_color)
    hwc = composite_image(ci, image_height, image_width, grad_values_only)
    return image_outputs(hwc, ci.overflow, bg_color, with_color,
                         extra_channels is not None)


class Slab(NamedTuple):
    hwc: torch.Tensor  # (rows_local * 16, W, 1 + n_val) this rank's rows
    overflow: torch.Tensor  # (2,) f32, of the whole (padded) image
    rows_pad: int  # tile rows of the padded image, a multiple of world


def composite_slab(proj: ProjectedGaussians,
                   extra_channels: torch.Tensor | None, image_height: int,
                   image_width: int, cfg: RasterConfig, rank: int,
                   world: int, with_color: bool = True,
                   grad_values_only: bool = False) -> Slab:
    """The slab entry of rasterize_tiled: rank `rank` of `world` composites
    its slab of tile rows. The tile rows are padded to a multiple of the
    world and the binning runs at the padded height, as trase_tpu's
    _composite_my_rows_pallas does (sharded.py:219-237), so every rank
    bins the same gathered projection identically; the slab is tile rows
    [rank rows_local, (rank + 1) rows_local). Concatenated over the ranks
    and cropped to the image, the slabs are rasterize_tiled's image of the
    padded binning; under autograd each slab's payload gradient covers its
    own pairs, and the slabs' gradients sum to the whole image's."""
    th, tw = _tile_grid(image_height, image_width)
    rows_pad = -(-th // world) * world
    rows_local = rows_pad // world
    h_pad = rows_pad * TILE
    ci = composite_inputs(proj, extra_channels, h_pad, image_width, cfg,
                          with_color)
    t_lo = rank * rows_local * tw
    hwc = composite_image(ci, h_pad, image_width, grad_values_only, t_lo,
                          t_lo + rows_local * tw)
    return Slab(hwc, ci.overflow, rows_pad)
