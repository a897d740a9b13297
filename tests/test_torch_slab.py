"""Slab mode of the port's compositor (the multi-device steps' kernels):
the plain versions of composite_fwd, composite_bwd and reduce_pair_grads
given a tile range against trase_tpu's pallas_composite with g_lo /
rows_local in interpret mode, as its sharded path calls it
(trase_tpu/parallel/sharded.py:219-237), and the slabs against the whole
image. The kernels against these plain versions: chip_smoke.py's mesh
phase on the card."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trase_tpu.ops import rasterize as R
from trase_tpu.ops import rasterize_pallas as RP

from trase_tpu_torch.ops import rasterize_cuda as TRC

from test_torch_rasterize import scene, torch_cfg, torch_proj

torch.set_num_threads(2)

# the compositor's parity with trase_tpu (tests/test_torch_rasterize.py's
# forward cases); the payload gradients' as max abs difference over each
# column group's scale (mean2d, conic, log opacity, values): the conic
# group's sums cancel (a dx^2 against the others) and the TPU kernel takes
# them through monomial matmuls, so the whole-image gradient of these
# scenes already differs by up to 1.4e-5 there (the other groups by at
# most 3.7e-6); the slabs stay inside the same bound
FWD_TOL, GRAD_TOL = 1.5e-6, 2e-5
GROUPS = (slice(0, 2), slice(2, 5), slice(5, 6), slice(6, None))
# the slabs' gradients summed against the whole image's: each pair's row
# lies in one slab, so only the K-row sums associate differently
SUM_TOL = 2e-6
N_FEAT = 32
CASES = {"48x48": (48, 48, 300, 5), "64x80": (64, 80, 400, 7)}
# the GAUSSIAN step's layout (rgb + depth) and the FEATURE step's (32
# features alone, bf16-packed)
LAYOUTS = {"gaussian": (True, False), "feature": (False, True)}


def slab_scene(case, layout):
    H, W, n, seed = CASES[case]
    proj, _ = scene(n, seed, H, W)
    with_color, packed = LAYOUTS[layout]
    extra = None
    if not with_color:
        f = np.random.default_rng(seed).normal(size=(n, N_FEAT))
        extra = (f / np.linalg.norm(f, axis=1, keepdims=True)).astype(
            np.float32)
    cfg = R.RasterConfig(pairs_per_gaussian=4, pack_features=packed)
    return proj, extra, H, W, cfg, with_color


@functools.lru_cache(maxsize=None)
def jax_slab_fn(static):
    """jitted (payload, g_lo) -> slab and its vjp, per static config."""
    fn = jax.jit(lambda payload, sorted_pid, slot, layout, g_lo:
                 RP.pallas_composite(static, payload, sorted_pid, slot,
                                     layout, g_lo))

    @jax.jit
    def vjp(payload, sorted_pid, slot, layout, g_lo, ct):
        _, back = jax.vjp(lambda p: RP.pallas_composite(
            static, p, sorted_pid, slot, layout, g_lo), payload)
        return back(ct)[0]

    return fn, vjp


def jax_slabs(proj, extra, H, W, cfg, with_color, world, cts):
    """trase_tpu's slab of every rank and its payload gradient under the
    rank's cotangent, as (slab (rows_local 16, W, 1 + n_val), dpayload
    (N, 6 + n_val)) in the port's column order."""
    th, tw = R._tile_grid(H, W)
    _, gxn = RP.group_geometry(tw)
    rows_pad = -(-th // world) * world
    rows_local = rows_pad // world
    sorted_pid, slot, layout, _ = RP.build_window_layout(
        proj, rows_pad * RP.TILE, W, cfg)
    payload, n_val = RP.build_payload(
        proj, None if extra is None else jnp.asarray(extra), with_color)
    n_packed = extra.shape[1] // 2 if cfg.pack_features and extra is not \
        None else 0
    static = (rows_pad * tw, tw, n_val, True, rows_local, n_packed,
              with_color)
    fn, vjp = jax_slab_fn(static)
    out = []
    for r in range(world):
        g_lo = jnp.int32(r * rows_local * gxn)
        slab = fn(payload, sorted_pid, slot, layout, g_lo)
        gx = slab.shape[2] * RP.TILE
        img = np.asarray(slab).reshape(rows_local * RP.TILE, gx, n_val + 1)
        ct = np.zeros((rows_local * RP.TILE, gx, n_val + 1), np.float32)
        ct[:, :W] = cts[r]
        d = np.asarray(vjp(payload, sorted_pid, slot, layout, g_lo,
                           jnp.asarray(ct.reshape(slab.shape))))
        d = np.concatenate([d[:-1, :6], d[:-1, 8:8 + n_val]], axis=1)
        out.append((img[:, :W], d))
    return out


def port_slab(ci, h_pad, W, t_lo, t_hi, ct):
    """The port's plain slab forward and, through autograd (the plain
    backward and reduce), its payload gradient under `ct`."""
    payload = ci.payload.clone().requires_grad_(True)
    hwc = TRC.composite_image(ci._replace(payload=payload), h_pad, W,
                              t_lo=t_lo, t_hi=t_hi)
    d, = torch.autograd.grad(hwc, payload, torch.from_numpy(ct))
    return hwc.detach().numpy(), d.numpy()


def col_scale(a):
    return np.abs(a).max(axis=0) + 1e-8


def group_err(got, ref):
    """Max abs difference over each column group's largest magnitude."""
    return max(float(np.abs(got[:, g] - ref[:, g]).max()
                     / (np.abs(ref[:, g]).max() + 1e-8)) for g in GROUPS)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("case,world", [("48x48", 2), ("48x48", 4),
                                        ("64x80", 4)])
def test_slabs_match_pallas_and_whole_image(case, world, layout):
    proj, extra, H, W, cfg, with_color = slab_scene(case, layout)
    th, tw = R._tile_grid(H, W)
    rows_pad = -(-th // world) * world
    rows_local = rows_pad // world
    h_pad = rows_pad * R.TILE
    n_val = (4 if with_color else 0) + (0 if extra is None else N_FEAT)
    rng = np.random.default_rng(world)
    cts = [rng.normal(size=(rows_local * R.TILE, W, n_val + 1)).astype(
        np.float32) for _ in range(world)]
    ref = jax_slabs(proj, extra, H, W, cfg, with_color, world, cts)

    tproj = torch_proj(proj)
    textra = None if extra is None else torch.from_numpy(extra)
    ci = TRC.composite_inputs(tproj, textra, h_pad, W, torch_cfg(cfg),
                              with_color)
    assert (ci.n_val, ci.n_packed > 0) == (n_val, not with_color)
    slabs, grads = [], []
    for r, (ref_img, ref_d) in enumerate(ref):
        t_lo = r * rows_local * tw
        img, d = port_slab(ci, h_pad, W, t_lo, t_lo + rows_local * tw,
                           cts[r])
        assert img.shape == (rows_local * R.TILE, W, n_val + 1)
        scale = max(1.0, float(np.abs(ref_img).max()))
        assert np.abs(img - ref_img).max() / scale <= FWD_TOL, r
        assert group_err(d, ref_d) <= GRAD_TOL, r
        # the slab entry of rasterize_tiled renders the same slab
        entry = TRC.composite_slab(tproj, textra, H, W, torch_cfg(cfg), r,
                                   world, with_color)
        assert entry.rows_pad == rows_pad
        np.testing.assert_array_equal(entry.hwc.numpy(), img)
        slabs.append(img)
        grads.append(d)
    assert any(np.abs(d).max() > 0 for d in grads[1:])

    # the slabs concatenated are the whole padded image, bit for bit, and
    # their payload gradients sum to the whole image's
    whole, d_whole = port_slab(ci, h_pad, W, 0, None,
                               np.concatenate(cts, axis=0))
    np.testing.assert_array_equal(np.concatenate(slabs, axis=0), whole)
    total = np.sum(grads, axis=0)
    err = np.abs(total - d_whole) / col_scale(d_whole)
    assert err.max() <= SUM_TOL, err.max(axis=0)


def test_plain_slab_backward_and_reduce():
    """composite_bwd_plain given a tile range writes the slab's pair rows
    only, and reduce_pair_grads_plain sums only the slab's pair range."""
    proj, _, H, W, cfg, _ = slab_scene("64x80", "gaussian")
    th, tw = R._tile_grid(H, W)
    ci = TRC.composite_inputs(torch_proj(proj), None, H, W, torch_cfg(cfg))
    args = (ci.payload, ci.sorted_gauss, ci.tile_start, H, W, 4, 0)
    t_lo, t_hi = tw, 3 * tw
    out, logt, stop = TRC.composite_plain(*args, residuals=True, t_lo=t_lo,
                                          t_hi=t_hi)
    assert out.shape == (2 * R.TILE, W, 5)
    assert logt.shape == ((t_hi - t_lo) * TRC.PIX,)
    g = torch.from_numpy(np.random.default_rng(2).normal(
        size=out.shape).astype(np.float32))
    dpair = TRC.composite_bwd_plain(*args, g, logt, stop, t_lo=t_lo,
                                    t_hi=t_hi)
    lo, hi = int(ci.tile_start[t_lo]), int(ci.tile_start[t_hi])
    assert hi > lo
    assert not dpair[:lo].any() and not dpair[hi:].any()
    assert dpair[lo:hi].abs().max() > 0
    inv = TRC.inverse_pairs(ci.sorted_pid)
    n = ci.payload.shape[0]
    got = TRC.reduce_pair_grads_plain(dpair + 1.0, inv, ci.tile_start, n,
                                      t_lo, t_hi)
    in_range = (inv.long() >= lo) & (inv.long() < hi)
    count = in_range.reshape(n, -1).sum(dim=1, keepdim=True)
    want = TRC.reduce_pair_grads_plain(dpair, inv, ci.tile_start, n,
                                       t_lo, t_hi) + count
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="whole tile rows"):
        TRC.composite_plain(*args, t_lo=1, t_hi=tw)
