"""The CUDA compositor (trase_tpu_torch/csrc/composite_fwd.cu) against its
plain PyTorch version on the card. Imports no jax, so it runs on the
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
    before = TRC.FWD_LAUNCHES
    got = TRC.composite_fwd(*args)
    torch.cuda.synchronize()
    assert TRC.FWD_LAUNCHES == before + 1
    ref = TRC.composite_plain(*args)
    diff = (got - ref).abs()
    assert float(diff[..., :-1].max()) <= 1e-5
    assert float(diff[..., -1].max()) <= 1e-4
    assert float(got[..., 0].max()) > 0.5  # the scene covers the image


@pytest.mark.cuda
def test_render_under_autograd_raises_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proj, _ = _scene(50, 32, 32, 0, "cuda")
    mean2d = proj.mean2d.clone().requires_grad_(True)
    out = TRC.rasterize_tiled(proj._replace(mean2d=mean2d), None,
                              torch.zeros(3, device="cuda"), 32, 32)
    with pytest.raises(NotImplementedError, match="training slice"):
        out["render"].sum().backward()
