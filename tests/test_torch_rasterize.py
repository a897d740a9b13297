"""Port parity for the rasterizer: trase_tpu_torch's binning and compositor
against trase_tpu's Pallas path (interpret mode) on the same projected
inputs, and against the goldens. The CUDA kernel against its plain
version is tests/test_torch_cuda.py (no jax there: it runs on the card)."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trase_tpu.ops import rasterize as R
from trase_tpu.ops import rasterize_pallas as RP

from trase_tpu_torch.ops import projection as TP
from trase_tpu_torch.ops import rasterize as TR
from trase_tpu_torch.ops import rasterize_cuda as TRC

from test_rasterize import make_camera, project, random_scene

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
CFG = R.RasterConfig(pairs_per_gaussian=64, pack_features=False)
# tolerances of tests/test_rasterize_pallas.py::test_matches_dense: the
# port carries T in log space like the Pallas kernel but sums the pairs
# one by one where the kernel sums 128-pair windows by matmul, so the
# per-pixel sums associate differently
TOL = {"render": 2e-4, "feats": 5e-4, "depth": 2e-3, "alpha": 2e-4}


# one compile per case instead of one per primitive
window_layout = jax.jit(RP.build_window_layout, static_argnums=(1, 2, 3))


def torch_proj(jproj):
    """trase_tpu ProjectedGaussians -> the port's, via numpy."""
    return TP.ProjectedGaussians(*[
        None if x is None else torch.from_numpy(np.array(x)) for x in jproj])


def torch_cfg(cfg):
    """trase_tpu's RasterConfig -> the port's, field by field by name."""
    return TR.RasterConfig(**{k: getattr(cfg, k)
                              for k in TR.RasterConfig._fields})


def jax_tile_ranges(layout, num_tiles):
    """Per-tile [start, end) of trase_tpu's window layout, as tile_start."""
    ws = np.asarray(layout.win_start)
    cnt = np.asarray(layout.meta_t) & 255
    counts = np.array([cnt[ws[t]:ws[t + 1]].sum() for t in range(num_tiles)])
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def scene(n, seed, H, W, **kw):
    cam = make_camera(H, W, **kw)
    means, scales, quats, colors, opac, feats = random_scene(n, seed)
    return project(means, scales, quats, colors, opac, cam, H, W), feats


def saturated_scene(H, W):
    """Large, nearly opaque splats stacked in depth: every central pixel
    reaches T < 1e-4 and stops early."""
    rng = np.random.default_rng(3)
    n = 24
    means = np.zeros((n, 3), np.float32)
    means[:, :2] = rng.uniform(-0.3, 0.3, size=(n, 2))
    means[:, 2] = np.linspace(-1.0, 1.0, n)
    scales = np.full((n, 3), 1.2, np.float32)
    quats = np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1))
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.9, 0.985, size=n).astype(np.float32)
    feats = rng.normal(size=(n, 8)).astype(np.float32)
    cam = make_camera(H, W)
    return project(means, scales, quats, colors, opac, cam, H, W), feats


BIN_CASES = {
    "random": dict(n=300, seed=11, H=64, W=96, cfg=R.RasterConfig(
        pairs_per_gaussian=8)),
    "alpha_cull": dict(n=300, seed=11, H=64, W=96, cfg=R.RasterConfig(
        pairs_per_gaussian=8, alpha_cull=True)),
    "truncation": dict(n=60, seed=4, H=64, W=64, cfg=R.RasterConfig(
        pairs_per_gaussian=3)),
}


class TestBinning:
    @pytest.mark.parametrize("case", sorted(BIN_CASES))
    def test_matches_window_layout(self, case):
        """Sorted pair ids, tile ranges and both overflow counts equal
        build_window_layout's exactly (same rects, same key, stable sort)."""
        c = BIN_CASES[case]
        proj, _ = scene(c["n"], c["seed"], c["H"], c["W"])
        if case == "truncation":  # a few huge splats overflow K
            s = np.asarray(proj.extent).copy()
            s[:5] *= 6.0
            proj = proj._replace(extent=jnp.asarray(s))
        sorted_pid, _, layout, overflow = window_layout(
            proj, c["H"], c["W"], c["cfg"])
        bins = TRC.build_tile_bins(torch_proj(proj), c["H"], c["W"],
                                   torch_cfg(c["cfg"]))
        th, tw = R._tile_grid(c["H"], c["W"])
        np.testing.assert_array_equal(bins.sorted_pid.numpy(),
                                      np.asarray(sorted_pid))
        np.testing.assert_array_equal(bins.tile_start.numpy(),
                                      jax_tile_ranges(layout, th * tw))
        np.testing.assert_array_equal(bins.overflow.numpy(),
                                      np.asarray(overflow))
        if case == "truncation":
            assert float(overflow[0]) > 0 and float(overflow[1]) > 0
        if case == "alpha_cull":
            plain = TRC.build_tile_bins(torch_proj(proj), c["H"], c["W"],
                                        torch_cfg(c["cfg"]._replace(
                                            alpha_cull=False)))
            assert int(bins.tile_start[-1]) < int(plain.tile_start[-1])

    def test_depth_ties_keep_pair_order(self):
        """Gaussians at identical depth tie on the key: the stable sort
        keeps pair-id order, as jax.lax.sort does."""
        H, W = 48, 64
        cam = make_camera(H, W)
        means, scales, quats, colors, opac, _ = random_scene(40, 2)
        means[:, 2] = 0.25  # one depth for all
        proj = project(means, scales, quats, colors, opac, cam, H, W)
        cfg = R.RasterConfig(pairs_per_gaussian=8)
        sorted_pid, _, layout, _ = window_layout(proj, H, W, cfg)
        bins = TRC.build_tile_bins(torch_proj(proj), H, W, torch_cfg(cfg))
        np.testing.assert_array_equal(bins.sorted_pid.numpy(),
                                      np.asarray(sorted_pid))


def pallas(proj, feats, bg, H, W, cfg=CFG):
    return RP.rasterize_tiled_pallas(
        proj, None if feats is None else jnp.asarray(feats),
        jnp.asarray(bg), H, W, cfg, interpret=True)


def port(proj, feats, bg, H, W, cfg=CFG):
    return TRC.rasterize_tiled(
        torch_proj(proj), None if feats is None else torch.from_numpy(feats),
        torch.tensor(bg, dtype=torch.float32), H, W, torch_cfg(cfg))


def assert_outputs(ref, got, tol, keys=("render", "feats", "depth", "alpha")):
    for k in keys:
        if k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       atol=tol[k], rtol=0, err_msg=k)


class TestCompositor:
    @pytest.mark.parametrize("with_feats", [True, False])
    def test_matches_pallas(self, with_feats):
        H, W = 48, 64
        proj, feats = scene(50, 1, H, W)
        feats = feats if with_feats else None
        bg = [0.1, 0.2, 0.3]
        ref = pallas(proj, feats, bg, H, W)
        got = port(proj, feats, bg, H, W)
        assert_outputs(ref, got, TOL)
        assert float(got["overflow"]) == float(ref["overflow"])
        assert ("feats" in got) == with_feats

    def test_packed_features(self):
        """bf16-packed features: the same rounding as JAX's packed path,
        and rgb/alpha/depth untouched by packing."""
        H, W = 48, 64
        proj, feats = scene(60, 5, H, W)
        feats = feats / np.linalg.norm(feats, axis=1, keepdims=True)
        bg = [0.1, 0.2, 0.3]
        packed = CFG._replace(pack_features=True)
        ref = pallas(proj, feats, bg, H, W, packed)
        got = port(proj, feats, bg, H, W, packed)
        assert_outputs(ref, got, TOL)
        # against the unpacked port: the tolerances of
        # test_rasterize_pallas.py::TestPackedFeatures.test_forward_parity
        # (identical weights; features round to bf16, ~2^-8 relative)
        unpacked = port(proj, feats, bg, H, W)
        assert_outputs(unpacked, got, {"render": 1e-6, "alpha": 1e-6,
                                       "depth": 1e-6, "feats": 6e-3})

    def test_background_only(self):
        H = W = 32
        cam = make_camera(H, W)
        means, scales, quats, colors, opac, _ = random_scene(4)
        proj = project(means + np.array([0, 0, -100.0], np.float32),
                       scales, quats, colors, opac, cam, H, W)
        out = port(proj, None, [1.0, 0.0, 0.5], H, W)
        np.testing.assert_allclose(
            out["render"].numpy(),
            np.broadcast_to(np.array([1.0, 0.0, 0.5])[:, None, None],
                            (3, H, W)), atol=1e-6)
        assert float(out["alpha"].max()) == 0.0

    def test_saturated_early_termination(self):
        H, W = 32, 48
        proj, feats = saturated_scene(H, W)
        bg = [0.0, 0.0, 0.0]
        ref = pallas(proj, feats, bg, H, W)
        got = port(proj, feats, bg, H, W)
        assert_outputs(ref, got, TOL)
        # stopped pixels keep T >= 1e-4: alpha saturates at 1 - T_stop
        # instead of the ~1 - 0.01^k it reaches without the stop rule
        acc = got["alpha"].numpy()
        assert acc.max() > 0.999
        assert acc.max() <= 1.0 - 1e-4 + 1e-6


def test_plain_compositor_matches_golden():
    """golden_scene.ply -> golden_render.npz through the port's loader,
    projection and plain compositor (test_goldens.py's 5e-3; depth
    20x)."""
    from trase_tpu_torch.models import gaussians as G
    from trase_tpu_torch.models.gaussians_io import load_gaussian_ply
    from trase_tpu_torch.renderer import make_render_camera

    H = W = 64
    params, aux, n, _ = load_gaussian_ply(
        os.path.join(GOLD, "golden_scene.ply"), sh_degree=2, device="cpu")
    z = np.load(os.path.join(GOLD, "golden_render.npz"))
    cam = make_render_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), 0.9, 0.9,
                             H, W, device="cpu")
    opacity = torch.where(aux.alive, G.get_opacity(params)[:, 0],
                          torch.zeros(()))
    cov3d = TP.compute_cov3d(G.get_scaling(params), G.get_rotation(params))
    proj = TP.project_gaussians(params.xyz, cov3d, opacity, cam.buffers,
                                H, W, sh_coeffs=G.get_features(params),
                                sh_degree=2)
    feats = params.gaussian_features.numpy()
    normed = feats / (np.linalg.norm(feats, axis=1, keepdims=True) + 1e-12)
    normed = np.where(aux.alive.numpy()[:, None], normed, 0.0)
    cfg = TR.RasterConfig(pairs_per_gaussian=64, pack_features=False)
    out = TRC.rasterize_tiled(proj, torch.from_numpy(normed.astype(np.float32)),
                              torch.from_numpy(z["bg"]), H, W, cfg)
    tol = 5e-3
    for k, t in (("render", tol), ("feats", tol), ("depth", tol * 20),
                 ("alpha", tol)):
        np.testing.assert_allclose(out[k].numpy(), z[k], atol=t, err_msg=k)


def test_plain_rejects_bad_layout():
    payload = torch.zeros((4, 9))
    with pytest.raises(ValueError):
        TRC.composite_plain(payload, torch.zeros(4, dtype=torch.int32),
                            torch.zeros(2, dtype=torch.int32), 16, 16, 4)
    with pytest.raises(ValueError):  # the kernel takes CUDA tensors only
        TRC.composite_fwd(torch.zeros((4, 10)),
                          torch.zeros(4, dtype=torch.int32),
                          torch.zeros(2, dtype=torch.int32), 16, 16, 4)



# ------------------------------------------------------------ gradients

GRAD_FIELDS = ("mean2d", "conic", "opacity", "color", "depth")


def grad_scene(case):
    """Projected inputs + raster config for the gradient cases: a random
    scene, the saturated early-stop scene (the port's mirror of
    test_zombie_window_grads), a K that truncates, and alpha_cull."""
    if case == "saturated":
        H, W = 32, 48
        proj, _ = saturated_scene(H, W)
        return proj, H, W, CFG
    H, W = 48, 64
    proj, _ = scene(60, 3, H, W)
    if case == "truncation":
        s = np.asarray(proj.extent).copy()
        s[:6] *= 5.0
        return proj._replace(extent=jnp.asarray(s)), H, W, R.RasterConfig(
            pairs_per_gaussian=3, pack_features=False)
    if case == "alpha_cull":
        return proj, H, W, CFG._replace(alpha_cull=True)
    return proj, H, W, CFG


def weights(H, W, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(c, H, W)).astype(np.float32)
            for k, c in (("render", 3), ("depth", 1), ("alpha", 1))}


def weighted_loss(out, w, lib):
    return sum(lib.sum(out[k] * lib_arr(w[k], lib)) for k in w)


def lib_arr(x, lib):
    return jnp.asarray(x) if lib is jnp else torch.from_numpy(x)


class TestBackward:
    @pytest.mark.parametrize("case", ["random", "saturated", "truncation",
                                      "alpha_cull"])
    def test_plain_backward_matches_autograd(self, case):
        """composite_bwd_plain + reduce_pair_grads_plain give the payload
        gradient that autograd takes through composite_plain (same
        weights; sums associated differently: 1e-5 of each column's
        scale)."""
        proj, H, W, cfg = grad_scene(case)
        ci = TRC.composite_inputs(torch_proj(proj), None, H, W,
                                  torch_cfg(cfg))
        payload = ci.payload.clone().requires_grad_(True)
        g = torch.from_numpy(np.random.default_rng(1).normal(
            size=(H, W, 5)).astype(np.float32))
        out = TRC.composite_plain(payload, ci.sorted_gauss, ci.tile_start,
                                  H, W, 4)
        ref, = torch.autograd.grad((out * g).sum(), payload)
        out2, logt, stop = TRC.composite_plain(
            ci.payload, ci.sorted_gauss, ci.tile_start, H, W, 4,
            residuals=True)
        assert torch.equal(out2, out.detach())
        stats = {}
        dpair = TRC.composite_bwd_plain(ci.payload, ci.sorted_gauss,
                                        ci.tile_start, H, W, 4, 0, g, logt,
                                        stop, stats=stats)
        got = TRC.reduce_pair_grads_plain(
            dpair, TRC.inverse_pairs(ci.sorted_pid), ci.tile_start,
            ci.payload.shape[0])
        scale = ref.abs().amax(dim=0) + 1e-8
        assert float(((got - ref).abs() / scale).max()) < 1e-5
        # the reverse walk reconstructs T = 1 at each tile's first pair
        assert float(stats["logt_first"].abs().max()) < 1e-4
        lens = (ci.tile_start[1:] - ci.tile_start[:-1]).repeat_interleave(
            TRC.PIX)
        stopped = stop < lens
        assert bool(stopped.any()) == (case == "saturated")

    @pytest.mark.parametrize("case", ["random", "saturated", "truncation",
                                      "alpha_cull"])
    def test_gradients_match_pallas(self, case):
        """The port's rasterize_tiled gradients (mean2d, conic, opacity,
        color, depth) against jax.vjp of rasterize_tiled_pallas in
        interpret mode on the same projected inputs, within
        test_grads_match_dense's bound: max abs diff / scale < 3e-4."""
        proj, H, W, cfg = grad_scene(case)
        bg = np.array([0.1, 0.2, 0.3], np.float32)
        w = weights(H, W)

        def jloss(*leaves):
            p = proj._replace(**dict(zip(GRAD_FIELDS, leaves)))
            out = RP.rasterize_tiled_pallas(p, None, jnp.asarray(bg), H, W,
                                            cfg, interpret=True)
            return weighted_loss(out, w, jnp)

        ref = jax.grad(jloss, argnums=tuple(range(len(GRAD_FIELDS))))(
            *[getattr(proj, k) for k in GRAD_FIELDS])
        tproj = torch_proj(proj)
        leaves = {k: getattr(tproj, k).clone().requires_grad_(True)
                  for k in GRAD_FIELDS}
        out = TRC.rasterize_tiled(tproj._replace(**leaves), None,
                                  torch.from_numpy(bg), H, W,
                                  torch_cfg(cfg))
        got = torch.autograd.grad(weighted_loss(out, w, torch),
                                  list(leaves.values()))
        for name, a, b in zip(GRAD_FIELDS, ref, got):
            a = np.asarray(a)
            b = b.numpy()
            assert np.isfinite(b).all(), name
            scale = np.abs(a).max() + 1e-8
            assert np.abs(a - b).max() / scale < 3e-4, (name, case)
            assert np.abs(b).max() > 0, name
