"""The frozen bound arithmetic, pinned to PERF.md's kernel table and to
a compositing case counted by hand."""
import math

import pytest
import torch

from port_bench.counts import bounds as B
from port_bench.reference import plain as P


def test_mlp_bound_matches_the_kernel_table():
    # PERF.md kernel table: deform_mlp bound 0.132996 ms at 131072 rows,
    # the non-Blender embedding (84 inputs): bound by operations
    got = B.mlp_bound(131072, 84, 96)
    assert got["bound_ms"] == pytest.approx(0.132996, abs=5e-7)
    assert got["bound_by"] == "operations"


def hand_case():
    """One 16 x 16 tile, five gaussians covering it with alpha 0.95 at
    every pixel (zero conic): T after k pairs is 0.05^k, so each pixel
    takes three pairs (T = 1.25e-4) and stops at the fourth (T would be
    6.25e-6 < 1e-4): 4 evaluated and 3 contributing pairs a pixel."""
    n = 5
    mean2d = torch.full((n, 2), 8.0)
    conic = torch.zeros((n, 3))
    logop = torch.full((n,), math.log(0.95))
    vals = torch.rand((n, 4), generator=torch.Generator().manual_seed(0))
    bins = P.Bins(torch.arange(n), torch.tensor([0, n]), 1, 1, 0)
    return bins, mean2d, conic, logop, vals


def test_pair_pixels_are_counted_up_to_each_pixels_stop():
    bins, *pay = hand_case()
    c = {"evaluated": 0, "contributing": 0, "pairs": 0}
    img = P.composite(bins, *pay, 16, 16, counts=c)
    # every pixel stops at the fourth pair: the fifth is never needed
    assert c == {"evaluated": 4 * 256, "contributing": 3 * 256, "pairs": 4}
    w = [0.95, 0.95 * 0.05, 0.95 * 0.05 ** 2]
    assert float(img[0, 0, 0]) == pytest.approx(sum(w), rel=1e-6)


def test_compositor_bound_of_the_hand_case():
    c = {"evaluated": 1024, "contributing": 768, "pairs": 4}
    nbytes, ops = B.composite_fwd_work(c, 4, 16, 16, 1, residuals=True)
    # rows of 6 + 4 words and an id per needed pair, two tile offsets,
    # the (16, 16, 5) image, 8 bytes of residuals a pixel
    assert nbytes == 4 * 44 + 8 + 4 * 256 * 5 + 8 * 256
    assert ops == 16 * 1024 + 16 * 768
    nb, ob = B.composite_bwd_work(c, 4, 16, 16, 1, n_rows=5, k=1)
    assert nb == 4 * 44 + 4 * 40 + 4 * 256 * 5 + 8 * 256 + 8 \
        + 4 * 5 + 4 * 40 + 5 * 40
    assert ob == 16 * 1024 + 51 * 768 + 5 * 10
    b = B.bound("x", nbytes, ops)
    assert b["x_bound_ms"] == pytest.approx(
        max(nbytes / 3.35e12, ops / 67e12) * 1e3)
    assert b["x_bound_by"] == "bytes"
