"""The CUDA kernels (trase_tpu_torch/csrc/composite_fwd.cu, composite_bwd.cu)
against their plain PyTorch versions on the card. Imports no jax, so it
runs on the machine with the card:

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
    before = TRC.FWD_LAUNCHES
    got = TRC.composite_fwd(*args)
    torch.cuda.synchronize()
    assert TRC.FWD_LAUNCHES == before + 1
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
    before = (TRC.BWD_LAUNCHES, TRC.REDUCE_LAUNCHES)
    dpair = TRC.composite_bwd(*args, g, logt, stop, logt_first=first)
    inv = TRC.inverse_pairs(ci.sorted_pid)
    n = ci.payload.shape[0]
    dpay = TRC.reduce_pair_grads(dpair, inv, ci.tile_start, n)
    torch.cuda.synchronize()
    assert (TRC.BWD_LAUNCHES, TRC.REDUCE_LAUNCHES) == (before[0] + 1,
                                                       before[1] + 1)
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
