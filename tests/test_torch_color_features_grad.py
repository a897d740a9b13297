"""The compositor's gradient with colour beside 32 features (36 values,
the layouts whose card backward is composite_bwd.cu's 42-word
instantiations) on the CPU plain path: the port's rasterize_tiled under
autograd against jax.vjp of trase_tpu's rasterize_tiled_pallas in
interpret mode on the same projected inputs, with the scenes and weights
of tests/test_torch_rasterize.py::TestBackward plus seeded unit features
and feature weights; unpacked and bf16-packed, full and values-only.
Tolerance: max abs diff / scale < 3e-4 per field (test_gradients_match_
pallas's). Values-only: mean2d, conic and opacity get exact zeros, and the
value inputs (colour, depth, features) the full mode's gradients bit for
bit."""
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trase_tpu.ops import rasterize_pallas as RP

from trase_tpu_torch.ops import rasterize_cuda as TRC

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_rasterize import (  # noqa: E402
    GRAD_FIELDS, grad_scene, torch_cfg, torch_proj, weighted_loss, weights)

torch.set_num_threads(2)

N_FEAT = 32
GEOMETRY = ("mean2d", "conic", "opacity")


def _features(n, seed=4):
    f = np.random.default_rng(seed).normal(size=(n, N_FEAT)).astype(
        np.float32)
    return f / np.linalg.norm(f, axis=1, keepdims=True)


def _port_grads(proj, feats, bg, H, W, cfg, w, w_feat, values_only):
    tproj = torch_proj(proj)
    leaves = {k: getattr(tproj, k).clone().requires_grad_(True)
              for k in GRAD_FIELDS}
    f = torch.from_numpy(feats).requires_grad_(True)
    out = TRC.rasterize_tiled(tproj._replace(**leaves), f,
                              torch.from_numpy(bg), H, W, torch_cfg(cfg),
                              grad_values_only=values_only)
    assert out["feats"].shape == (N_FEAT, H, W)
    loss = weighted_loss(out, w, torch) + torch.sum(
        out["feats"] * torch.from_numpy(w_feat))
    got = torch.autograd.grad(loss, [*leaves.values(), f])
    return {k: g.numpy() for k, g in zip(GRAD_FIELDS + ("features",), got)}


@pytest.mark.parametrize("values_only", [False, True],
                         ids=["full", "values_only"])
@pytest.mark.parametrize("pack", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("case", ["random", "saturated"])
def test_color_features_gradients_match_pallas(case, pack, values_only):
    proj, H, W, cfg = grad_scene(case)
    cfg = cfg._replace(pack_features=pack)
    n = proj.mean2d.shape[0]
    feats = _features(n)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    w = weights(H, W)
    w_feat = np.random.default_rng(5).normal(size=(N_FEAT, H, W)).astype(
        np.float32)

    def jloss(*leaves):
        p = proj._replace(**dict(zip(GRAD_FIELDS, leaves[:-1])))
        out = RP.rasterize_tiled_pallas(p, leaves[-1], jnp.asarray(bg), H, W,
                                        cfg, interpret=True,
                                        grad_values_only=values_only)
        return weighted_loss(out, w, jnp) + jnp.sum(
            out["feats"] * jnp.asarray(w_feat))

    primals = [getattr(proj, k) for k in GRAD_FIELDS] + [jnp.asarray(feats)]
    _, vjp = jax.vjp(jloss, *primals)
    ref = dict(zip(GRAD_FIELDS + ("features",),
                   (np.asarray(x) for x in vjp(jnp.float32(1.0)))))

    got = _port_grads(proj, feats, bg, H, W, cfg, w, w_feat, values_only)
    for name, b in got.items():
        assert np.isfinite(b).all(), name
        if values_only and name in GEOMETRY:
            assert not b.any(), name  # exact zeros
            continue
        a = ref[name]
        scale = np.abs(a).max() + 1e-8
        assert np.abs(a - b).max() / scale < 3e-4, (name, case, pack)
        assert np.abs(b).max() > 0, name
    if values_only:
        full = _port_grads(proj, feats, bg, H, W, cfg, w, w_feat, False)
        for name in ("color", "depth", "features"):
            assert np.array_equal(got[name], full[name]), name
