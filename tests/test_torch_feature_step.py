"""Port parity for the FEATURE training step: one step of
trase_tpu_torch's feature_phase_step against trase_tpu's
_feature_phase_body (its Pallas path in interpret mode, which takes the
feats_acc_hwc branch the port mirrors) on the same state, masks, pixel
sample and smoothing permutation (trase_tpu's, injected), in both arms of
with_densify_stats."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trase_tpu import renderer as JR
from trase_tpu.engine import trainer as JT
from trase_tpu.losses import contrastive as JC
from trase_tpu.models import deform as JD
from trase_tpu.ops.knn import build_feature_smooth_map as j_smooth_map
from trase_tpu.ops.rasterize import RasterConfig as JRasterConfig
from trase_tpu.renderer import make_render_camera as j_camera

from trase_tpu_torch.engine import trainer as TT
from trase_tpu_torch.losses.contrastive import PixelSample
from trase_tpu_torch.models import deform as TD
from trase_tpu_torch.ops.knn import SMOOTH_DROPOUT, transpose_smooth_map
from trase_tpu_torch.ops.rasterize import RasterConfig as TRasterConfig
from trase_tpu_torch.renderer import make_render_camera as t_camera

from test_torch_train import jax_field, np_tree, t32

torch.set_num_threads(2)

H, W = 40, 56
HM, WM = 20, 28  # masks at half the render's resolution: the resize runs
M, P, SMOOTH_K = 5, 96, 16


def seeded_masks(seed=0):
    """4 overlapping seeded rectangles and one padding slot."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((M, HM, WM), np.float32)
    for m in range(M - 1):
        y0, x0 = rng.integers(0, HM // 2), rng.integers(0, WM // 2)
        hh, ww = rng.integers(5, HM // 2 + 4), rng.integers(6, WM // 2 + 6)
        masks[m, y0:y0 + hh, x0:x0 + ww] = 1.0
    return masks, np.arange(M) < M - 1


def feature_inputs(use_deform):
    jp, ja = jax_field(n=80, cap=128, seed=5)
    rng = np.random.default_rng(11)
    feats = rng.normal(size=jp.gaussian_features.shape).astype(np.float32)
    jp = jp._replace(gaussian_features=jnp.asarray(feats))
    net = JD.make_deform_network("DeformNetwork")
    dvars = JD.init_deform(jax.random.PRNGKey(1), net)
    for head in ("Dense_8", "Dense_9", "Dense_10"):
        dvars["params"][head]["kernel"] = dvars["params"][head]["kernel"] \
            * 0.05
    jstate = JT.init_train_state(jp, ja, dvars)
    R, T = np.eye(3), np.array([0.05, -0.02, 0.0])
    masks, valid = seeded_masks()
    smooth_map = np.asarray(j_smooth_map(jp.xyz, SMOOTH_K))
    rng_sample, rng_smooth = jax.random.split(jax.random.PRNGKey(7))
    sample = JC.sample_pixels_and_masks(rng_sample, jnp.asarray(masks),
                                        jnp.asarray(valid), P, 3)
    perm = np.asarray(jax.random.permutation(rng_smooth, SMOOTH_K)[:8])
    lrs = JT.LearningRates(*[1e-3] * 6, 2.5e-3, 1e-3)
    return dict(net=net, jstate=jstate, jcam=j_camera(R, T, 0.9, 0.7, H, W),
                tcam=t_camera(R, T, 0.9, 0.7, H, W, device="cpu"),
                masks=masks, valid=valid, smooth_map=smooth_map,
                sample=sample, perm=perm, lrs=lrs, use_deform=use_deform)


def step_kw(inp, mode, stats):
    return dict(sh_degree=1, use_deform=inp["use_deform"], is_6dof=False,
                contrastive_mode=mode, rfn=1.0, positive_th=0.75,
                negative_th=0.5, num_sampled_pixels=P, num_sampled_masks=3,
                with_densify_stats=stats)


def port_step(inp, lrs, kw):
    """The port's step on the inputs' state: (new state, metrics), and
    the state it started from."""
    s = inp["sample"]
    tstate = TT.train_state_from_numpy(np_tree(inp["jstate"]), "cpu")
    return TT.feature_phase_step(
        tstate, inp["tcam"], t32(inp["masks"]), torch.from_numpy(
            inp["valid"]), 0.4, lrs, torch.zeros(3),
        transpose_smooth_map(torch.from_numpy(inp["smooth_map"]).long()),
        deform_net=TD.make_deform_network(device="cpu"),
        raster_cfg=TRasterConfig(pairs_per_gaussian=16),
        sample=PixelSample(torch.from_numpy(np.asarray(s.pixel_idx)).long(),
                           torch.from_numpy(np.asarray(s.pixel_valid)),
                           torch.from_numpy(np.asarray(s.mask_sel))),
        smooth_perm=torch.from_numpy(inp["perm"]).long(), **kw), tstate


def run_both(inp, mode, stats, monkeypatch):
    """(JAX new state, metrics), (port new state, metrics)."""
    kw = step_kw(inp, mode, stats)
    monkeypatch.setattr(JR, "default_backend", lambda: "pallas_interpret")
    step = jax.jit(functools.partial(
        JT._feature_phase_body, deform_net=inp["net"], image_height=H,
        image_width=W, use_smoothing=True, smooth_dropout=SMOOTH_DROPOUT,
        mask_hw=(HM, WM),
        raster_cfg=JRasterConfig(pairs_per_gaussian=16), **kw))
    jnew, jm = step(inp["jstate"], inp["jcam"].buffers,
                    jnp.asarray(inp["masks"]), jnp.asarray(inp["valid"]),
                    jnp.float32(0.4), jax.random.PRNGKey(7), inp["lrs"],
                    jnp.zeros(3), jnp.asarray(inp["smooth_map"]))
    (tnew, tm), _ = port_step(inp, TT.LearningRates(*inp["lrs"]), kw)
    return (jnew, jm), (tnew, tm)


def close(a, b, tol, name=""):
    a, b = np.asarray(a), np.asarray(b)
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-12)
    assert err < tol, (name, err, tol)


@pytest.mark.parametrize("stats", [True, False])
def test_feature_step_matches_all_mode(stats, monkeypatch):
    """contrastive_mode "all" (no thresholds): loss and metrics within
    1e-5, the features' Adam moments within 1e-4 of scale (the
    compositor's sums associate differently; the resize and the gram are
    float32 products), the features where the gradient is clearly
    nonzero, and in the stats arm the densification accumulators
    (1e-4 of scale). Only the features, their moments and, in the stats
    arm, the accumulators change."""
    inp = feature_inputs(use_deform=False)
    (jnew, jm), (tnew, tm) = run_both(inp, "all", stats, monkeypatch)
    assert bool(jm["finite"]) and bool(tm["finite"])
    for k in ("loss", "rfn", "pos_sim", "neg_sim", "overflow"):
        assert abs(float(tm[k]) - float(jm[k])) < 1e-5, k
    ref = TT.train_state_to_numpy(TT.train_state_from_numpy(
        np_tree(jnew), "cpu"))
    got = TT.train_state_to_numpy(tnew)
    old = TT.train_state_to_numpy(TT.train_state_from_numpy(
        np_tree(inp["jstate"]), "cpu"))
    mu = ref["opt"]["gaussian_features"]["mu"]
    assert np.abs(mu).max() > 0
    close(mu, got["opt"]["gaussian_features"]["mu"], 1e-4, "mu")
    close(ref["opt"]["gaussian_features"]["nu"],
          got["opt"]["gaussian_features"]["nu"], 2e-4, "nu")
    big = np.abs(mu) > 0.05 * np.abs(mu).max()
    close(ref["params"]["gaussian_features"][big],
          got["params"]["gaussian_features"][big], 1e-4, "features")
    for k in ("xyz", "opacity", "scaling", "rotation", "features_dc"):
        np.testing.assert_array_equal(got["params"][k], old["params"][k])
        np.testing.assert_array_equal(got["opt"][k]["mu"],
                                      old["opt"][k]["mu"])
    for k in ("xyz_gradient_accum", "denom"):
        if stats:
            close(ref["aux"][k], got["aux"][k], 1e-4, k)
            assert ref["aux"][k].sum() > 0
        else:
            np.testing.assert_array_equal(got["aux"][k], old["aux"][k])


def test_feature_step_soft_mode_band(monkeypatch):
    """contrastive_mode "soft", the default, values-only arm, the bf16
    deform stack on: the thresholds can flip a pair near the boundary, so
    test_feature_step_backend_parity's band: loss within 5e-4 relative,
    more than 99 % of the feature entries within 1e-4."""
    inp = feature_inputs(use_deform=True)
    (jnew, jm), (tnew, tm) = run_both(inp, "soft", False, monkeypatch)
    assert bool(jm["finite"]) and bool(tm["finite"])
    l_j, l_t = float(jm["loss"]), float(tm["loss"])
    assert abs(l_j - l_t) < 5e-4 * max(abs(l_j), 1.0), (l_j, l_t)
    f_j = np.asarray(jnew.params.gaussian_features)
    f_t = tnew.params.gaussian_features.numpy()
    frac = np.mean(np.abs(f_j - f_t) < 1e-4)
    assert frac > 0.99, frac
    assert np.abs(f_t - np.asarray(inp["jstate"].params.gaussian_features)
                  ).max() > 0


@pytest.mark.parametrize("with_densify_stats", [True, False])
def test_nan_guard_skips_the_feature_step(with_densify_stats):
    """A NaN learning rate for gaussian_features turns the update
    non-finite: the step leaves every float tensor of the state as it
    was, on the device flag alone, with and without the densification
    statistics."""
    inp = feature_inputs(use_deform=False)
    lrs = TT.LearningRates(*inp["lrs"])._replace(
        gaussian_features=float("nan"))
    (new, m), old = port_step(inp, lrs,
                              step_kw(inp, "soft", with_densify_stats))
    assert not bool(m["finite"])
    for a, b in zip(TT.float_tensors(new), TT.float_tensors(old)):
        assert torch.equal(a, b)
