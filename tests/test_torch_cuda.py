"""The CUDA kernels (trase_tpu_torch/csrc/composite_fwd.cu, composite_bwd.cu,
deform_mlp.cu) against their plain PyTorch versions on the card: the
compositor in the GAUSSIAN step's layout (rgb + depth) and the FEATURE
step's (32 features alone, unpacked and bf16-packed, full and values-only
backward), and the fused deform MLP. Imports no jax, so it runs on the
machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device every case skips."""
import numpy as np
import pytest
import torch

from trase_tpu_torch.ops import projection as TP
from trase_tpu_torch.ops import rasterize as TR
from trase_tpu_torch.ops import rasterize_cuda as TRC

torch.set_num_threads(2)


def _scene(n, H, W, n_feat, device):
    from trase_tpu_torch.renderer import make_render_camera

    rng = np.random.default_rng(6)
    means = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    means[:, 2] += 5.0
    scales = rng.uniform(0.05, 0.3, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 0.99, size=n).astype(np.float32)

    def t(x):
        return torch.tensor(x, device=device)

    cam = make_render_camera(np.eye(3), np.zeros(3), 1.0, 0.8, H, W,
                             device=device)
    proj = TP.project_gaussians(t(means), TP.compute_cov3d(t(scales), t(quats)),
                                t(opac), cam.buffers, H, W,
                                colors_precomp=t(colors))
    feats = None
    if n_feat:
        f = rng.normal(size=(n, n_feat)).astype(np.float32)
        feats = t(f / np.linalg.norm(f, axis=1, keepdims=True))
    return proj, feats


@pytest.mark.cuda
@pytest.mark.parametrize("n_feat,pack", [(0, False), (32, False), (32, True)])
def test_cuda_kernel_matches_plain(n_feat, pack):
    """Same expressions in the same order (built with -fmad=false), so
    only libm ulps and the sign of zero may differ: 1e-5 absolute, 1e-4
    on the depth channel (sums reach ~10)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, W = 96, 128
    proj, feats = _scene(400, H, W, n_feat, "cuda")
    ci = TRC.composite_inputs(proj, feats, H, W, TR.RasterConfig(
        pairs_per_gaussian=16, pack_features=pack))
    assert ci.n_packed == (n_feat // 2 if pack else 0)
    payload = ci.payload
    if ci.n_packed:
        payload = TRC.pack_feature_words(payload, ci.n_val, ci.n_packed)
    args = (payload, ci.sorted_gauss, ci.tile_start, H, W, ci.n_val,
            ci.n_packed)
    key = ("composite_fwd", ci.n_val, ci.n_packed, True, False)
    before = TRC.LAYOUT_LAUNCHES.get(key, 0)
    got = TRC.composite_fwd(*args)
    torch.cuda.synchronize()
    assert TRC.LAYOUT_LAUNCHES[key] == before + 1
    ref = TRC.composite_plain(*args)
    diff = (got - ref).abs()
    assert float(diff[..., :-1].max()) <= 1e-5
    assert float(diff[..., -1].max()) <= 1e-4
    assert float(got[..., 0].max()) > 0.5  # the scene covers the image


def _inputs(n, H, W, K=16):
    proj, _ = _scene(n, H, W, 0, "cuda")
    ci = TRC.composite_inputs(proj, None, H, W,
                              TR.RasterConfig(pairs_per_gaussian=K))
    return ci


@pytest.mark.cuda
def test_cuda_residuals_match_plain():
    """The residual instantiation: same image as without residuals, and
    per-pixel log T and stop index equal to the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, W = 96, 128
    ci = _inputs(400, H, W)
    args = (ci.payload, ci.sorted_gauss, ci.tile_start, H, W, 4, 0)
    out, logt, stop = TRC.composite_fwd(*args, residuals=True)
    plain = TRC.composite_fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    _, ref_logt, ref_stop = TRC.composite_plain(*args, residuals=True)
    assert torch.equal(stop, ref_stop)
    assert float((logt - ref_logt).abs().max()) <= 1e-5
    lens = (ci.tile_start[1:] - ci.tile_start[:-1]).repeat_interleave(256)
    assert bool((stop < lens).any()) or bool((stop == lens).all())


@pytest.mark.cuda
def test_cuda_backward_matches_plain():
    """composite_bwd + reduce_pair_grads against their plain versions on
    one cotangent: the per-pixel terms are the same expressions (built
    with -fmad=false); only the 256-pixel sums associate differently."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, W = 96, 128
    ci = _inputs(400, H, W)
    args = (ci.payload, ci.sorted_gauss, ci.tile_start, H, W, 4, 0)
    _, logt, stop = TRC.composite_fwd(*args, residuals=True)
    g = torch.randn((H, W, 5), generator=torch.Generator().manual_seed(0)
                    ).cuda()
    first = torch.empty_like(logt)
    keys = (("composite_bwd", 4, 0, True, False), ("reduce_pair_grads", 10))
    before = [TRC.LAYOUT_LAUNCHES.get(k, 0) for k in keys]
    dpair = TRC.composite_bwd(*args, g, logt, stop, logt_first=first)
    inv = TRC.inverse_pairs(ci.sorted_pid)
    n = ci.payload.shape[0]
    dpay = TRC.reduce_pair_grads(dpair, inv, ci.tile_start, n)
    torch.cuda.synchronize()
    assert [TRC.LAYOUT_LAUNCHES[k] for k in keys] == [b + 1 for b in before]
    stats = {}
    ref_pair = TRC.composite_bwd_plain(*args, g, logt, stop, stats=stats)
    nv = int(ci.tile_start[-1])
    scale = ref_pair[:nv].abs().amax(dim=0) + 1e-6
    assert float(((dpair[:nv] - ref_pair[:nv]).abs() / scale).max()) < 1e-5
    ref_pay = TRC.reduce_pair_grads_plain(dpair, inv, ci.tile_start, n)
    assert torch.equal(dpay, ref_pay)  # same sums in the same order
    assert float((first - stats["logt_first"]).abs().max()) < 1e-5
    assert float(first.abs().max()) < 1e-3


@pytest.mark.cuda
def test_render_gradients_on_card():
    """rasterize_tiled under autograd on the card (forward with
    residuals, backward kernel, reduce kernel) gives the gradients of the
    same call on the CPU (plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    grads = {}
    for dev in ("cuda", "cpu"):
        proj, _ = _scene(50, 32, 32, 0, "cpu")
        proj = proj._replace(**{k: v.to(dev) for k, v in
                                proj._asdict().items() if v is not None})
        leaves = {k: getattr(proj, k).clone().requires_grad_(True)
                  for k in ("mean2d", "conic", "opacity", "color", "depth")}
        out = TRC.rasterize_tiled(proj._replace(**leaves), None,
                                  torch.zeros(3, device=dev), 32, 32)
        w = torch.linspace(-1, 1, 32 * 32 * 3, device=dev).reshape(3, 32, 32)
        loss = (out["render"] * w).sum() + out["alpha"].sum() \
            + 0.1 * out["depth"].sum()
        grads[dev] = dict(zip(leaves, (x.cpu() for x in torch.autograd.grad(
            loss, list(leaves.values())))))
    for k, ref in grads["cpu"].items():
        scale = float(ref.abs().max()) + 1e-8
        assert float((grads["cuda"][k] - ref).abs().max()) / scale < 1e-5, k


def _feature_inputs(pack, H=96, W=128, n=400):
    proj, feats = _scene(n, H, W, 32, "cuda")
    ci = TRC.composite_inputs(proj, feats, H, W, TR.RasterConfig(
        pairs_per_gaussian=16, pack_features=pack), with_color=False)
    assert (ci.n_val, ci.n_packed) == (32, 16 if pack else 0)
    payload = ci.payload
    if ci.n_packed:
        payload = TRC.pack_feature_words(payload, 32, 16, with_color=False)
    return ci, (payload, ci.sorted_gauss, ci.tile_start, H, W, 32,
                ci.n_packed)


@pytest.mark.cuda
@pytest.mark.parametrize("pack", [False, True])
def test_cuda_features_only_forward_matches_plain(pack):
    """The features-only instantiations, with and without residuals: the
    same image bit for bit as the plain version (the same expressions in
    the same order), and the plain version's log T and stop index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, args = _feature_inputs(pack)
    out = TRC.composite_fwd(*args, with_color=False)
    res, logt, stop = TRC.composite_fwd(*args, with_color=False,
                                        residuals=True)
    torch.cuda.synchronize()
    ref, ref_logt, ref_stop = TRC.composite_plain(*args, with_color=False,
                                                  residuals=True)
    assert torch.equal(out, ref) and torch.equal(res, ref)
    assert torch.equal(stop, ref_stop) and torch.equal(logt, ref_logt)
    assert float(out[..., 0].max()) > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("pack", [False, True])
def test_cuda_features_only_backward_matches_plain(pack):
    """The features-only backward, full and values-only, against the
    plain version (256-pixel sums in another order: 1e-5 of each column's
    scale); values-only gives exact zeros in the geometry columns and the
    full mode's value columns bit for bit; the reduce at 38 words equals
    its plain version bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ci, args = _feature_inputs(pack)
    _, logt, stop = TRC.composite_fwd(*args, with_color=False,
                                      residuals=True)
    H, W = args[3], args[4]
    g = torch.randn((H, W, 33), generator=torch.Generator().manual_seed(0)
                    ).cuda()
    nv = int(ci.tile_start[-1])
    inv = TRC.inverse_pairs(ci.sorted_pid)
    n = ci.payload.shape[0]
    got = {}
    for vo in (False, True):
        dpair = TRC.composite_bwd(*args, g, logt, stop, with_color=False,
                                  values_only=vo)
        dpay = TRC.reduce_pair_grads(dpair, inv, ci.tile_start, n)
        torch.cuda.synchronize()
        ref = TRC.composite_bwd_plain(*args, g, logt, stop,
                                      with_color=False, values_only=vo)
        scale = ref[:nv].abs().amax(dim=0) + 1e-6
        assert float(((dpair[:nv] - ref[:nv]).abs() / scale).max()) < 1e-5
        assert dpay.shape == (n, 38)
        assert torch.equal(dpay, TRC.reduce_pair_grads_plain(
            dpair, inv, ci.tile_start, n))
        got[vo] = dpair[:nv]
    assert not bool(got[True][:, :6].any())
    assert torch.equal(got[True][:, 6:], got[False][:, 6:])
    assert bool(got[False][:, :6].any())


@pytest.mark.cuda
@pytest.mark.parametrize("n,model_type", [
    (300, "DeformNetwork"), (4096 + 7, "DeformNetwork"),
    (300, "DeformStaticNetwork"), (300, "DeformDynamicNetwork")])
def test_deform_mlp_matches_plain(n, model_type):
    """The fused deform MLP kernel against fused_deform_mlp_plain on the
    same embedding (ragged last tiles; input widths 84, 68 and 128): bf16
    operands with float32 sums in another order, so an activation near a
    bf16 rounding boundary may round the other way: 1e-2 of each head's
    scale. One launch, counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trase_tpu_torch.models.deform import (
        deform_step, frequency_embed, init_deform, make_deform_network)
    from trase_tpu_torch.ops import mlp_cuda as TM

    net = init_deform(make_deform_network(model_type, device="cuda"),
                      torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    xyz = torch.tensor(rng.normal(size=(n, 3)).astype(np.float32),
                       device="cuda")
    t = torch.full((n, 1), 0.42, device="cuda")
    emb = torch.cat([frequency_embed(xyz, net.multires),
                     frequency_embed(t, net.t_multires)], 1)
    key = ("deform_mlp",)
    before = TRC.LAYOUT_LAUNCHES.get(key, 0)
    got = deform_step(net, xyz, t, fused=True)
    torch.cuda.synchronize()
    assert TRC.LAYOUT_LAUNCHES[key] == before + 1
    ref = TM.fused_deform_mlp_plain(net, emb)
    for a, b in zip(ref, got):
        assert b.shape == a.shape and bool(torch.isfinite(b).all())
        err = float((a - b).abs().max()) / (float(a.abs().max()) + 1e-6)
        assert err <= 1e-2, err
