"""Tile binning + the CUDA tile compositor (forward) and its plain version.

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
tile chunk — for CPU tensors. Nothing falls back from one to the other.
The launch sits inside a ``torch.autograd.Function`` whose backward
raises: the backward kernel belongs to the training slice.
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

from .projection import ProjectedGaussians
from .rasterize import TILE, RasterConfig, _tile_grid, _tile_rects, clamp_rect_to_budget
from .rasterize_ref import ALPHA_EPS, ALPHA_MAX, T_EPS

DEPTH_BITS = 19  # depth quantization inside the composite sort key
GEOM_COLS = 6  # mean2d(2) + conic(3) + log opacity(1)
PIX = TILE * TILE

LOG_ALPHA_MAX = float(np.log(ALPHA_MAX))
LOG_ALPHA_EPS = float(np.log(ALPHA_EPS))
LOG_T_EPS = float(np.log(T_EPS))

# (n_val, n_packed) value layouts the kernel is instantiated for: rgb +
# depth, + 32 features, + 32 bf16-packed features.
SUPPORTED = frozenset({(4, 0), (36, 0), (36, 16)})

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "composite_fwd.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

# Kernel launches made by composite_fwd (the CUDA path only).
FWD_LAUNCHES = 0

_LIB = None


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
                  extra_channels: torch.Tensor | None):
    """(N, 6 + n_val) per-gaussian float32 table + n_val.

    Row = [mean2d, conic, log opacity | rgb, extra, depth]. Invalid rows
    are zeroed (log opacity = log 1e-38), so garbage projections never
    reach exp(). Each pixel's depth is sum(w * depth), not normalized.
    """
    vmask = proj.valid[:, None]
    opacity = torch.where(proj.valid, proj.opacity,
                          torch.zeros_like(proj.opacity))
    log_op = torch.log(torch.clamp(opacity, min=1e-38))
    geom = torch.cat([proj.mean2d, proj.conic], dim=1)
    cols = [proj.color]
    if extra_channels is not None:
        cols.append(extra_channels)
    cols.append(proj.depth[:, None])
    vals = torch.cat(cols, dim=1)
    zero = torch.zeros((), dtype=geom.dtype, device=geom.device)
    payload = torch.cat([torch.where(vmask, geom, zero), log_op[:, None],
                         torch.where(vmask, vals, zero)], dim=1)
    return payload.contiguous(), vals.shape[1]


def row_words(n_val: int, n_packed: int) -> int:
    """float32 words per payload row in the kernel's layout."""
    return GEOM_COLS + (4 + n_packed if n_packed else n_val)


def pack_feature_words(payload: torch.Tensor, n_val: int,
                       n_packed: int) -> torch.Tensor:
    """[geom 6 | rgb, feats 2P, depth] -> [geom 6 | rgb, depth, P words]:
    word r carries feats[r] as bf16 (round to nearest even, as JAX's
    astype(bfloat16)) in its low half and feats[r + P] in its high half.
    Not differentiable (bit reinterpretation)."""
    n = payload.shape[0]
    g = GEOM_COLS
    feats = payload[:, g + 3:g + 3 + 2 * n_packed]
    bf = feats.to(torch.bfloat16)
    words = torch.stack([bf[:, :n_packed], bf[:, n_packed:]], dim=-1)
    words = words.reshape(n, 2 * n_packed).contiguous().view(torch.float32)
    return torch.cat([payload[:, :g + 3], payload[:, g + n_val - 1:g + n_val],
                      words], dim=1).contiguous()


def unpack_values(payload: torch.Tensor, n_val: int,
                  n_packed: int) -> torch.Tensor:
    """(N, n_val) float32 values [rgb, feats, depth] of a kernel-layout
    payload (inverse of pack_feature_words on the value words)."""
    g = GEOM_COLS
    if not n_packed:
        return payload[:, g:g + n_val]
    bf = payload[:, g + 4:g + 4 + n_packed].contiguous().view(torch.bfloat16)
    return torch.cat([payload[:, g:g + 3], bf[:, 0::2].float(),
                      bf[:, 1::2].float(), payload[:, g + 3:g + 4]], dim=1)


# --------------------------------------------------------- compositing


def _check_inputs(payload, sorted_gauss, tile_start, image_height,
                  image_width, n_val, n_packed):
    th, tw = _tile_grid(image_height, image_width)
    if payload.dtype != torch.float32 or payload.dim() != 2:
        raise ValueError("payload must be a 2-D float32 tensor")
    if payload.shape[1] != row_words(n_val, n_packed):
        raise ValueError(f"payload rows have {payload.shape[1]} words, the "
                         f"layout ({n_val}, {n_packed}) needs "
                         f"{row_words(n_val, n_packed)}")
    if sorted_gauss.dtype != torch.int32 or tile_start.dtype != torch.int32:
        raise ValueError("sorted_gauss and tile_start must be int32")
    if tile_start.shape != (th * tw + 1,):
        raise ValueError(f"tile_start has shape {tuple(tile_start.shape)}, "
                         f"the {th}x{tw} tile grid needs ({th * tw + 1},)")
    if n_packed and n_val != 4 + 2 * n_packed:
        raise ValueError("packed layout needs n_val == 4 + 2 * n_packed")
    devs = {payload.device, sorted_gauss.device, tile_start.device}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    return th, tw


def composite_plain(payload: torch.Tensor, sorted_gauss: torch.Tensor,
                    tile_start: torch.Tensor, image_height: int,
                    image_width: int, n_val: int, n_packed: int = 0,
                    tile_chunk: int = 2048, stats: dict | None = None):
    """Plain PyTorch version of the CUDA compositor: same inputs, same
    output (H, W, 1 + n_val) = [acc, values...], same expressions in the
    same order (log-space T, skip below 1/255, stop before T < 1e-4).

    Walks the pairs by rank within their tile, all tiles of a chunk at
    once, so memory is bounded by `tile_chunk` x 256 pixels. With
    `stats`, adds the pair-pixel evaluations ("evaluated": pixel not yet
    stopped) and contributions ("contributing") to it.
    """
    th, tw = _check_inputs(payload, sorted_gauss, tile_start, image_height,
                           image_width, n_val, n_packed)
    dev = payload.device
    num_tiles = th * tw
    geom = payload[:, :GEOM_COLS]
    vals = unpack_values(payload, n_val, n_packed)
    pix = torch.arange(PIX, device=dev)
    fx = (pix % TILE).to(torch.float32)
    fy = torch.div(pix, TILE, rounding_mode="floor").to(torch.float32)
    starts = tile_start[:-1].long()
    lens = (tile_start[1:] - tile_start[:-1]).long()
    last = max(sorted_gauss.shape[0] - 1, 0)
    out = torch.zeros((num_tiles, PIX, 1 + n_val), dtype=torch.float32,
                      device=dev)
    evaluated = contributing = 0
    for t0 in range(0, num_tiles, tile_chunk):
        t1 = min(num_tiles, t0 + tile_chunk)
        tiles = torch.arange(t0, t1, device=dev)
        ln, st = lens[t0:t1], starts[t0:t1]
        ox = ((tiles % tw) * TILE).to(torch.float32)[:, None]
        oy = (torch.div(tiles, tw, rounding_mode="floor")
              * TILE).to(torch.float32)[:, None]
        n_t = t1 - t0
        logt = torch.zeros((n_t, PIX), dtype=torch.float32, device=dev)
        acc = torch.zeros_like(logt)
        val = torch.zeros((n_t, PIX, n_val), dtype=torch.float32, device=dev)
        done = torch.zeros((n_t, PIX), dtype=torch.bool, device=dev)
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
    if stats is not None:
        stats["evaluated"] = stats.get("evaluated", 0) + evaluated
        stats["contributing"] = stats.get("contributing", 0) + contributing
    img = out.reshape(th, tw, TILE, TILE, 1 + n_val).permute(0, 2, 1, 3, 4)
    return img.reshape(th * TILE, tw * TILE, 1 + n_val)[
        :image_height, :image_width]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    home = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if nvcc is None and os.path.exists(home):
        nvcc = home
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA compositor is built "
                           "from csrc/composite_fwd.cu at first use")
    return nvcc


def build_library() -> tuple[str, float, str]:
    """Compile csrc/composite_fwd.cu for sm_90a into BUILD_DIR (once per
    source content). Returns (library path, build seconds, nvcc output);
    seconds and output are 0 and "" when the library was already built."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libcomposite_fwd_{digest}.so")
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, path)
    return path, seconds, log


def _library():
    global _LIB
    if _LIB is None:
        path, _, _ = build_library()
        lib = ctypes.CDLL(path)
        fn = lib.trase_composite_fwd
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def composite_fwd(payload: torch.Tensor, sorted_gauss: torch.Tensor,
                  tile_start: torch.Tensor, image_height: int,
                  image_width: int, n_val: int, n_packed: int = 0):
    """Launch the CUDA compositor on CUDA tensors: (H, W, 1 + n_val)
    float32 [acc, values...]. Raises for CPU tensors, for value layouts
    without a kernel instantiation and when the launch fails."""
    global FWD_LAUNCHES
    if payload.device.type != "cuda":
        raise ValueError("composite_fwd takes CUDA tensors; the CPU path "
                         "is composite_plain")
    if (n_val, n_packed) not in SUPPORTED:
        raise ValueError(f"no kernel instantiation for n_val={n_val}, "
                         f"n_packed={n_packed}; have {sorted(SUPPORTED)}")
    th, tw = _check_inputs(payload, sorted_gauss, tile_start, image_height,
                           image_width, n_val, n_packed)
    for name, t in (("payload", payload), ("sorted_gauss", sorted_gauss),
                    ("tile_start", tile_start)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _library()
    out = torch.empty((image_height, image_width, 1 + n_val),
                      dtype=torch.float32, device=payload.device)
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream(payload.device).cuda_stream
        rc = lib.trase_composite_fwd(
            payload.data_ptr(), sorted_gauss.data_ptr(),
            tile_start.data_ptr(), th * tw, tw, image_height, image_width,
            n_val, n_packed, LOG_ALPHA_MAX, LOG_ALPHA_EPS, LOG_T_EPS,
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"composite_fwd launch failed: cudaError {rc}")
    FWD_LAUNCHES += 1
    return out


def composite(payload, sorted_gauss, tile_start, image_height, image_width,
              n_val, n_packed=0):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = composite_plain if payload.device.type == "cpu" else composite_fwd
    return fn(payload, sorted_gauss, tile_start, image_height, image_width,
              n_val, n_packed)


class _Composite(torch.autograd.Function):
    """Forward-only compositor under autograd: backward raises, so a
    render differentiated before the training slice fails loudly instead
    of returning zero gradients."""

    @staticmethod
    def forward(ctx, payload, sorted_gauss, tile_start, image_height,
                image_width, n_val, n_packed):
        if n_packed:
            payload = pack_feature_words(payload, n_val, n_packed)
        return composite(payload, sorted_gauss, tile_start, image_height,
                         image_width, n_val, n_packed)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the compositor backward (_bwd_group_kernel) is not ported "
            "yet: it belongs to the training slice")


class CompositeInputs(NamedTuple):
    payload: torch.Tensor  # (N, 6 + n_val) float32, values unpacked
    sorted_gauss: torch.Tensor  # (n*K,) int32 gaussian of each sorted pair
    tile_start: torch.Tensor  # (T+1,) int32
    n_val: int
    n_packed: int  # > 0: the kernel composites bf16-packed features
    overflow: torch.Tensor  # (2,) f32


def composite_inputs(proj: ProjectedGaussians,
                     extra_channels: torch.Tensor | None, image_height: int,
                     image_width: int,
                     cfg: RasterConfig = RasterConfig()) -> CompositeInputs:
    """Binning, payload and the packing decision: what the compositor
    takes. Features pack when cfg.pack_features is set and their count
    is even (pack_feature_words turns the payload into the kernel's
    packed layout)."""
    bins = build_tile_bins(proj, image_height, image_width, cfg)
    payload, n_val = build_payload(proj, extra_channels)
    n_packed = 0
    if (cfg.pack_features and extra_channels is not None
            and extra_channels.shape[1] % 2 == 0):
        n_packed = extra_channels.shape[1] // 2
    sorted_gauss = torch.div(bins.sorted_pid, cfg.pairs_per_gaussian,
                             rounding_mode="floor").to(torch.int32)
    return CompositeInputs(payload, sorted_gauss, bins.tile_start, n_val,
                           n_packed, bins.overflow)


def rasterize_tiled(
    proj: ProjectedGaussians,
    extra_channels: torch.Tensor | None,
    bg_color: torch.Tensor,
    image_height: int,
    image_width: int,
    cfg: RasterConfig = RasterConfig(),
    with_color: bool = True,
):
    """Counterpart of rasterize_tiled_pallas: render (3,H,W), depth
    (1,H,W), alpha (1,H,W), overflow, overflow_half and, with
    extra_channels (N, F), feats (F,H,W) + feats_hwc (H,W,F). rgb gets
    the background (render = rgb + (1 - acc) bg); features do not."""
    if not with_color:
        raise NotImplementedError(
            "with_color=False (features-only FEATURE-phase path) belongs "
            "to the training slice")
    ci = composite_inputs(proj, extra_channels, image_height, image_width,
                          cfg)
    hwc = _Composite.apply(ci.payload, ci.sorted_gauss, ci.tile_start,
                           image_height, image_width, ci.n_val, ci.n_packed)
    acc = hwc[..., 0]
    rgb = hwc[..., 1:4] + (1.0 - acc)[..., None] * bg_color[None, None, :]
    result = {
        "alpha": acc[None],
        "overflow": ci.overflow[0],
        "overflow_half": ci.overflow[1],
        "render": rgb.permute(2, 0, 1),
        "depth": hwc[..., -1][None],
    }
    if extra_channels is not None:
        feats_hwc = hwc[..., 4:-1]
        result["feats_hwc"] = feats_hwc
        result["feats"] = feats_hwc.permute(2, 0, 1)
    return result
