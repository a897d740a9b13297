"""Peaks of one NVIDIA H100 and the least time of the measured work.

A frozen copy of chip_smoke.py's ``bound`` / ``mlp_bound`` arithmetic
(the published peaks, bytes and operations from shapes), with the
compositor's work counted from the benchmark's own plain binning: each
pixel counts the pairs up to its own stop ("evaluated") and the pairs
that contribute ("contributing"), and a tile the pairs up to its pixels'
last stop ("pairs": those past it need not be read), so the count is
what these inputs need, whatever kernel does the work.
"""
from __future__ import annotations

# H100 SXM (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TILE_PIX = 256
GEOM_WORDS = 6


def bound(prefix: str, nbytes: float, ops: float) -> dict:
    """The least time for `nbytes` of traffic and `ops` float32
    operations, and which of the two bounds it."""
    pre = f"{prefix}_" if prefix else ""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS_PER_S * 1e3
    return {f"{pre}bound_ms": max(bytes_ms, ops_ms),
            f"{pre}bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def mlp_hidden_macs(in_dim: int, width: int = 256) -> int:
    """Multiply-adds per row of the 8 x 256 hidden stack with the input
    concatenated after layer 4."""
    return in_dim * width + 4 * width * width + (in_dim + width) * width \
        + 2 * width * width


def mlp_bound(n: int, in_dim: int, kin: int) -> dict:
    """The fused MLP's least time at n rows: bytes (the embedding read,
    the three heads written, the packed weights read once) over the
    memory rate; operations (the hidden stack at the bf16 tensor-core
    peak, the float32 heads at the float32 peak, on separate units)."""
    hidden = mlp_hidden_macs(in_dim)
    head = 256 * 10
    nbytes = (4 * n * in_dim + 4 * n * 10
              + 2 * (2 * 256 * kin + 7 * 256 * 256)
              + 4 * (8 * 256 + 256 * 10 + 10))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(2 * n * hidden / BF16_FLOPS_PER_S,
                 2 * n * head / F32_FLOPS_PER_S) * 1e3
    return {"bytes": nbytes, "flops": 2 * n * (hidden + head),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def composite_fwd_work(c: dict, n_val: int, height: int, width: int,
                       tiles: int, residuals: bool,
                       row_words: int | None = None) -> tuple[float, float]:
    """(bytes, ops) of one forward composite: each needed pair's payload
    row (`row_words` words; 6 + n_val unpacked) and id read once, the
    tile ranges, the image written (and the per-pixel residuals); 16
    operations per evaluated pair-pixel and 8 + 2 n_val per contributing
    one."""
    words = GEOM_WORDS + n_val if row_words is None else row_words
    nbytes = c["pairs"] * (4 * words + 4) + 4 * (tiles + 1) \
        + 4 * height * width * (1 + n_val)
    if residuals:
        nbytes += 8 * tiles * TILE_PIX
    ops = 16 * c["evaluated"] + (8 + 2 * n_val) * c["contributing"]
    return float(nbytes), float(ops)


def composite_bwd_work(c: dict, n_val: int, height: int, width: int,
                       tiles: int, n_rows: int, k: int,
                       row_words: int | None = None,
                       values_only: bool = False) -> tuple[float, float]:
    """(bytes, ops) of the backward and its per-gaussian reduce: the
    payload, the cotangent and the residuals read, each needed pair's
    gradient row (6 + n_val words) written and read back once, the per-gaussian
    rows written; 16 operations per evaluated pair-pixel and 35 + 4 n_val
    per contributing one (values only: 5 + 2 n_val), one add per reduced
    word."""
    words = GEOM_WORDS + n_val if row_words is None else row_words
    dwords = GEOM_WORDS + n_val
    nbytes = c["pairs"] * (4 * words + 4) + c["pairs"] * 4 * dwords \
        + 4 * height * width * (1 + n_val) + 8 * tiles * TILE_PIX \
        + 4 * (tiles + 1)
    nbytes += 4 * n_rows * k + c["pairs"] * 4 * dwords + n_rows * 4 * dwords
    per = (5 + 2 * n_val) if values_only else (35 + 4 * n_val)
    ops = 16 * c["evaluated"] + per * c["contributing"] + n_rows * k * dwords
    return float(nbytes), float(ops)


def ssim_ops(height: int, width: int, channels: int = 3) -> float:
    """Operations of SSIM's five 11 x 11 window sums, forward and
    input-gradient (twice the forward)."""
    return 3.0 * 5 * channels * height * width * 2 * 121
