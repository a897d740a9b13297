"""Port parity for the compositor's FEATURE-step modes: the features-only
layout (with_color=False, 32 features, unpacked and bf16-packed) forward
and gradients against trase_tpu's rasterize_tiled_pallas(interpret=True,
with_color=False) and jax.grad, and the values-only backward
(grad_values_only) against the full one."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trase_tpu.ops import rasterize_pallas as RP

from trase_tpu_torch.ops import rasterize_cuda as TRC

from test_torch_rasterize import grad_scene, torch_cfg, torch_proj

torch.set_num_threads(2)

GEOM = ("mean2d", "conic", "opacity")
CASES = ["random", "saturated", "truncation", "alpha_cull"]


def feature_case(case, pack, seed=0):
    proj, H, W, cfg = grad_scene(case)
    rng = np.random.default_rng(seed)
    n = proj.mean2d.shape[0]
    f = rng.normal(size=(n, 32)).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    g = rng.normal(size=(H, W, 33)).astype(np.float32)
    return proj, f, g, H, W, cfg._replace(pack_features=pack)


def jax_run(proj, f, g, H, W, cfg, values_only):
    """Outputs and jax.grad of sum(feats_acc_hwc * g) in (features,
    mean2d, conic, opacity)."""
    def loss(feats, *geom):
        p = proj._replace(**dict(zip(GEOM, geom)))
        out = RP.rasterize_tiled_pallas(
            p, feats, jnp.zeros(3), H, W, cfg, interpret=True,
            with_color=False, grad_values_only=values_only)
        return jnp.sum(out["feats_acc_hwc"] * g), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                         has_aux=True)(
        jnp.asarray(f), *[getattr(proj, k) for k in GEOM])
    return out, [np.asarray(x) for x in grads]


def port_run(proj, f, g, H, W, cfg, values_only):
    tproj = torch_proj(proj)
    geom = {k: getattr(tproj, k).clone().requires_grad_(True) for k in GEOM}
    feats = torch.from_numpy(f).requires_grad_(True)
    out = TRC.rasterize_tiled(tproj._replace(**geom), feats, torch.zeros(3),
                              H, W, torch_cfg(cfg), with_color=False,
                              grad_values_only=values_only)
    grads = torch.autograd.grad((out["feats_acc_hwc"]
                                 * torch.from_numpy(g)).sum(),
                                [feats] + list(geom.values()))
    return out, [x.numpy() for x in grads]


def assert_rel(ref, got, tol, name):
    scale = np.abs(ref).max() + 1e-8
    err = np.abs(ref - got).max() / scale
    assert err < tol, (name, err, tol)


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_features_only_matches_pallas(case, pack):
    """Forward (alpha, feats, feats_acc_hwc) within 5e-4 absolute
    (TOL["feats"] of test_torch_rasterize: the same weights, pixel sums
    associated differently) and the gradients in the features, mean2d,
    conic and opacity within 3e-4 of scale (test_grads_match_dense's
    bound); no render or depth key. Then the port's values-only backward:
    exact zeros in the geometry and the full mode's feature gradient bit
    for bit."""
    proj, f, g, H, W, cfg = feature_case(case, pack)
    ref, rgrads = jax_run(proj, f, g, H, W, cfg, False)
    got, grads = port_run(proj, f, g, H, W, cfg, False)
    assert "render" not in got and "depth" not in got
    for k in ("alpha", "feats", "feats_acc_hwc", "feats_hwc"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(ref[k]), atol=5e-4, rtol=0,
                                   err_msg=k)
    assert float(got["overflow"]) == float(ref["overflow"])
    for name, a, b in zip(("features",) + GEOM, rgrads, grads):
        assert np.isfinite(b).all(), name
        assert np.abs(b).max() > 0, name
        assert_rel(a, b, 3e-4, (name, case, pack))
    _, vgrads = port_run(proj, f, g, H, W, cfg, True)
    np.testing.assert_array_equal(vgrads[0], grads[0])
    for name, b in zip(GEOM, vgrads[1:]):
        assert not b.any(), name


def test_values_only_matches_pallas_values_only():
    """trase_tpu's values-only backward on the packed layout: feature
    gradients within 3e-4 of scale of the port's, geometry zero in
    both."""
    proj, f, g, H, W, cfg = feature_case("random", True, seed=1)
    _, rgrads = jax_run(proj, f, g, H, W, cfg, True)
    _, grads = port_run(proj, f, g, H, W, cfg, True)
    assert_rel(rgrads[0], grads[0], 3e-4, "features")
    for name, a, b in zip(GEOM, rgrads[1:], grads[1:]):
        assert not a.any() and not b.any(), name


@pytest.mark.parametrize("pack", [False, True])
def test_plain_backward_modes(pack):
    """composite_bwd_plain in both modes on the features-only layouts
    (the kernel's plain version): the full mode against autograd through
    composite_plain (1e-5 of each column's scale); values-only zero in
    the 6 geometry columns and equal to the full mode in the 32 value
    columns; reduce_pair_grads_plain at 38 words."""
    proj, f, g, H, W, cfg = feature_case("saturated", pack, seed=2)
    ci = TRC.composite_inputs(torch_proj(proj), torch.from_numpy(f), H, W,
                              torch_cfg(cfg), with_color=False)
    assert (ci.n_val, ci.n_packed, ci.with_color) == (
        32, 16 if pack else 0, False)
    kpay = (TRC.pack_feature_words(ci.payload, 32, ci.n_packed, False)
            if pack else ci.payload)
    assert kpay.shape[1] == TRC.row_words(32, ci.n_packed, False)
    args = (kpay, ci.sorted_gauss, ci.tile_start, H, W, 32, ci.n_packed)
    gt = torch.from_numpy(g)
    # autograd through the plain forward, on the values as the kernel
    # reads them (bf16-rounded when packed)
    vals = TRC.unpack_values(kpay, 32, ci.n_packed, False)
    payload = torch.cat([ci.payload[:, :6], vals], 1).requires_grad_(True)
    out = TRC.composite_plain(payload, ci.sorted_gauss, ci.tile_start, H, W,
                              32, 0, False)
    ref, = torch.autograd.grad((out * gt).sum(), payload)
    _, logt, stop = TRC.composite_plain(*args, with_color=False,
                                        residuals=True)
    inv = TRC.inverse_pairs(ci.sorted_pid)
    n = ci.payload.shape[0]
    full = TRC.composite_bwd_plain(*args, gt, logt, stop, with_color=False)
    vo = TRC.composite_bwd_plain(*args, gt, logt, stop, with_color=False,
                                 values_only=True)
    assert not bool(vo[:, :6].any())
    assert torch.equal(vo[:, 6:], full[:, 6:])
    got = TRC.reduce_pair_grads_plain(full, inv, ci.tile_start, n)
    assert got.shape == (n, 38)
    scale = ref.abs().amax(dim=0) + 1e-8
    assert float(((got - ref).abs() / scale).max()) < 1e-5


def test_layout_helpers_round_trip():
    """pack_feature_words / unpack_values in the features-only layout:
    word r holds bf16(feats[r]) low, bf16(feats[r + 16]) high."""
    rng = np.random.default_rng(3)
    payload = torch.from_numpy(rng.normal(size=(7, 38)).astype(np.float32))
    packed = TRC.pack_feature_words(payload, 32, 16, with_color=False)
    assert packed.shape == (7, 22)
    assert torch.equal(packed[:, :6], payload[:, :6])
    vals = TRC.unpack_values(packed, 32, 16, with_color=False)
    assert torch.equal(vals, payload[:, 6:].to(torch.bfloat16).float())
    words = packed[:, 6:].contiguous().view(torch.int32)
    lo = (words & 0xFFFF).to(torch.int16)
    assert torch.equal(lo.view(torch.bfloat16).float(), vals[:, :16])
    assert TRC.row_words(32, 0, False) == 38
    with pytest.raises(ValueError):
        TRC.composite_plain(packed, torch.zeros(0, dtype=torch.int32),
                            torch.zeros(2, dtype=torch.int32), 16, 16, 32,
                            16)  # packed rows read as the colour layout
