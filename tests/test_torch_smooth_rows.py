"""The feature smoothing's gradient as a reduce over the neighbour map's
transpose (trase_tpu_torch/ops/knn.py: transpose_smooth_map, smooth_rows,
smooth_rows_bwd_plain) against autograd's gradient of the gather-mean it
replaces, and the transpose's invariants. Imports no jax."""
import numpy as np
import pytest
import torch

from trase_tpu_torch.ops import knn as TK

K = 16


def _points(n, dead, seed):
    """n points, the last `dead` of them tied at the origin (dead slots)."""
    xyz = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    xyz[n - dead:] = 0.0
    return torch.from_numpy(xyz)


def _knn_map(n, dead, seed=0):
    return TK.build_feature_smooth_map(_points(n, dead, seed), K)


def _sparse_map(n, seed=1):
    """A map naming only the first third of the rows: the rest have
    in-degree 0."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, max(n // 3, 1), (n, K), generator=g)


def _gathered_map(n, seed=2):
    """A rank's rows naming the gathered rows of three ranks."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 3 * n, (n, K), generator=g)


MAPS = {
    "knn": lambda: (_knn_map(1237, 0), None),
    "in-degree-0": lambda: (_sparse_map(517), None),
    # 700 tied dead rows name the same rows: hubs past SMOOTH_CHUNK
    "dead-hub": lambda: (_knn_map(1237, 700), None),
    "dead-hub-chunk-7": lambda: (_knn_map(611, 200), 7),
    "gathered": lambda: (_gathered_map(301), None),
}


def _autograd(normed, idx, slots, w):
    sel = idx if slots is None else idx[:, slots]
    out = normed[sel].mean(dim=1)
    return out, torch.autograd.grad((out * w).sum(), normed)[0]


@pytest.mark.parametrize("draw", ["all", "8-of-16"])
@pytest.mark.parametrize("case", sorted(MAPS))
def test_smooth_rows_gradient_matches_autograd(case, draw):
    """Forward equal to the gather-mean, gradient within f32 sum-order
    tolerance of autograd's over every slot and over 8 drawn slots, with
    rows of in-degree 0, hub rows split into chunks (on the CPU too), a
    rank's rows into gathered rows and row counts of no block size."""
    idx, chunk = MAPS[case]()
    n_dst = int(idx.max()) + 1 if case == "gathered" else idx.shape[0]
    smap = TK.transpose_smooth_map(idx, n_dst,
                                   chunk=chunk or TK.SMOOTH_CHUNK)
    if case.startswith("dead-hub"):
        assert smap.hub_rows.numel() > 0 and smap.max_in_degree > smap.chunk
    if case == "in-degree-0":
        assert bool(((smap.rev_ptr[1:] - smap.rev_ptr[:-1]) == 0).any())
    slots = None if draw == "all" else torch.randperm(
        K, generator=torch.Generator().manual_seed(3))[:K // 2]
    rng = np.random.default_rng(4)
    normed = torch.from_numpy(rng.normal(size=(n_dst, 32)).astype(
        np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.normal(size=(idx.shape[0], 32)).astype(
        np.float32))
    ref, ref_g = _autograd(normed, idx, slots, w)
    out = TK.smooth_rows(normed, smap, slots)
    g, = torch.autograd.grad((out * w).sum(), normed)
    assert torch.equal(out, ref)
    # each sum holds at most max_in_degree terms of |w| / n_sel
    tol = 4e-7 * max(smap.max_in_degree, 1) * float(w.abs().max())
    np.testing.assert_allclose(g.numpy(), ref_g.numpy(), rtol=0, atol=tol)
    again, = torch.autograd.grad((TK.smooth_rows(normed, smap, slots)
                                  * w).sum(), normed)
    assert torch.equal(g, again)


@pytest.mark.parametrize("case", sorted(MAPS))
def test_transpose_invariants(case):
    """Every (i, s) appears once, each row's entries name it and ascend in
    (i, s), rev_ptr rises to C K, and the hub chunks tile each hub row's
    entries in order, `chunk` entries each but the last."""
    idx, chunk = MAPS[case]()
    n_dst = int(idx.max()) + 1 if case == "gathered" else idx.shape[0]
    m = TK.transpose_smooth_map(idx, n_dst, chunk=chunk or TK.SMOOTH_CHUNK)
    c = idx.shape[0]
    ptr = m.rev_ptr.long()
    assert ptr.shape == (n_dst + 1,) and int(ptr[0]) == 0
    assert int(ptr[-1]) == c * K and bool((ptr[1:] >= ptr[:-1]).all())
    entry = m.rev_src.long() * K + m.rev_slot.long()
    assert torch.equal(torch.sort(entry).values, torch.arange(c * K))
    row = torch.repeat_interleave(torch.arange(n_dst), ptr[1:] - ptr[:-1])
    assert torch.equal(idx[m.rev_src.long(), m.rev_slot.long()], row)
    same_row = row[1:] == row[:-1]
    assert bool((entry[1:][same_row] > entry[:-1][same_row]).all())
    deg = ptr[1:] - ptr[:-1]
    assert m.max_in_degree == int(deg.max())
    assert torch.equal(m.hub_rows.long(),
                       torch.nonzero(deg > m.chunk).reshape(-1))
    hub_ptr = m.hub_part_ptr.long()
    for h, j in enumerate(m.hub_rows.tolist()):
        parts = range(int(hub_ptr[h]), int(hub_ptr[h + 1]))
        begins = [int(m.part_begin[p]) for p in parts]
        ends = [int(m.part_end[p]) for p in parts]
        assert begins[0] == int(ptr[j]) and ends[-1] == int(ptr[j + 1])
        assert begins[1:] == ends[:-1]
        assert all(e - b == m.chunk for b, e in zip(begins[:-1], ends[:-1]))
        assert 0 < ends[-1] - begins[-1] <= m.chunk


def test_transpose_refuses_rows_outside():
    with pytest.raises(ValueError, match="outside"):
        TK.transpose_smooth_map(_gathered_map(40), 40)


def test_bare_map_and_smooth_map_agree():
    """smooth_features over two SmoothMaps of one map, each transpose
    counted by the smooth_map counter: the same values and gradients bit
    for bit, and the gradient-free values; smooth_features itself never
    transposes."""
    idx = _knn_map(400, 120)
    f = torch.from_numpy(np.random.default_rng(5).normal(size=(400, 32))
                         .astype(np.float32))
    perm = torch.tensor([3, 0, 7, 12, 9, 1, 15, 6])
    smap = TK.transpose_smooth_map(idx)
    before = TK.SMOOTH_MAP.get(("transpose",), 0)
    with torch.no_grad():
        plain = TK.smooth_features(f, smap, perm=perm)
    assert TK.SMOOTH_MAP.get(("transpose",), 0) == before
    outs = []
    for m in (TK.transpose_smooth_map(idx), TK.transpose_smooth_map(idx)):
        x = f.clone().requires_grad_(True)
        out = TK.smooth_features(x, m, perm=perm)
        outs.append((out, torch.autograd.grad(out.square().sum(), x)[0]))
    assert TK.SMOOTH_MAP[("transpose",)] == before + 2
    assert TK.SMOOTH_MAP[("max_in_degree",)] >= 120
    assert torch.equal(outs[0][0], plain) and torch.equal(outs[1][0], plain)
    assert torch.equal(outs[0][1], outs[1][1])
