"""Port parity for the renderer: trase_tpu_torch.renderer.render against
trase_tpu.renderer.render (Pallas backend in interpret mode) on the same
gaussian field, deformation deltas, masks and colours, its outputs and
its gradients (the screen-space offset, the raw parameters, the
deltas); the port's render CLI against the root render.py on copies of
one model directory; and the PCA colouring of the features."""
import os
import shutil
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trase_tpu.models import deform as JD
from trase_tpu.models import gaussians as JG
from trase_tpu.models.gaussians_io import save_checkpoint, save_gaussian_ply
from trase_tpu.ops.rasterize import RasterConfig as JRasterConfig
from trase_tpu.renderer import make_render_camera as j_camera
from trase_tpu.renderer import render as j_render

from trase_tpu_torch.models import gaussians as TG
from trase_tpu_torch.ops.rasterize import RasterConfig as TRasterConfig
from trase_tpu_torch.renderer import make_render_camera as t_camera
from trase_tpu_torch.renderer import render as t_render

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

torch.set_num_threads(2)

H, W = 48, 64
# as tests/test_rasterize_pallas.py::test_matches_dense: same weights,
# float sums associated differently (pair by pair vs 128-pair windows)
TOL = {"render": 2e-4, "feats": 5e-4, "depth": 2e-3, "alpha": 2e-4}


def field(n=200, seed=0, sh_degree=2):
    """A trase_tpu field with varied rotations, opacities, SH and dead
    slots, plus the port's copy of it."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 0.6).astype(np.float32)
    pts[:, 2] += 3.0
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    jp, ja = JG.from_point_cloud(pts, cols, sh_degree=sh_degree,
                                 dist2=np.full(n, 0.004, np.float32))
    cap = jp.xyz.shape[0]
    jp = jp._replace(
        rotation=jnp.asarray(rng.normal(size=(cap, 4)).astype(np.float32)),
        opacity=jnp.asarray(rng.normal(1.0, 1.5, size=(cap, 1)).astype(
            np.float32)),
        features_rest=jnp.asarray((0.2 * rng.normal(
            size=jp.features_rest.shape)).astype(np.float32)),
        scaling=jp.scaling.at[:n].add(jnp.asarray(
            rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32))))
    alive = np.asarray(ja.alive).copy()
    alive[:10] = False  # dead slots inside the live range
    ja = ja._replace(alive=jnp.asarray(alive))
    tp, ta = TG.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  jax.tree_util.tree_map(np.asarray, ja),
                                  device="cpu")
    return jp, ja, tp, ta


def cameras():
    R = np.eye(3)
    T = np.array([0.1, -0.05, 0.0])
    return (j_camera(R, T, 0.9, 0.7, H, W),
            t_camera(R, T, 0.9, 0.7, H, W, device="cpu"))


def check(ref, got, keys):
    for k in keys:
        tk = {"render_gaussian_features": "feats"}.get(k, k)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=TOL[tk], rtol=0, err_msg=k)
    np.testing.assert_array_equal(got["visibility_filter"].numpy(),
                                  np.asarray(ref["visibility_filter"]))
    np.testing.assert_array_equal(got["radii"].numpy(),
                                  np.asarray(ref["radii"]))
    assert float(got["overflow"]) == float(ref["overflow"])
    assert float(got["overflow_half"]) == float(ref["overflow_half"])


def test_render_deform_mask_features():
    """Deformation deltas, a keep-mask, dead slots and 32 bf16-packed
    feature channels (RasterConfig's default)."""
    jp, ja, tp, ta = field()
    jcam, tcam = cameras()
    cap = jp.xyz.shape[0]
    rng = np.random.default_rng(1)
    d = [(s * rng.normal(size=(cap, k))).astype(np.float32)
         for s, k in ((0.05, 3), (0.1, 4), (0.005, 3))]
    mask = rng.uniform(size=cap) < 0.8
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    ref = j_render(jcam, jp, ja.alive, jnp.asarray(bg),
                   *[jnp.asarray(x) for x in d], sh_degree=2,
                   mask=jnp.asarray(mask),
                   raster_cfg=JRasterConfig(pairs_per_gaussian=16),
                   backend="pallas_interpret")
    got = t_render(tcam, tp, ta.alive, torch.from_numpy(bg),
                   *[torch.from_numpy(x) for x in d], sh_degree=2,
                   mask=torch.from_numpy(mask),
                   raster_cfg=TRasterConfig(pairs_per_gaussian=16))
    check(ref, got, ("render", "depth", "alpha", "render_gaussian_features"))
    assert got["render_gaussian_features"].shape == (32, H, W)
    np.testing.assert_array_equal(
        got["render_gaussian_features_hwc"].numpy(),
        got["render_gaussian_features"].permute(1, 2, 0).numpy())


def test_render_override_color_6dof():
    """override_color, scaling_modifier and 6-DoF transforms, no
    features."""
    jp, ja, tp, ta = field(seed=2, sh_degree=1)
    jcam, tcam = cameras()
    cap = jp.xyz.shape[0]
    rng = np.random.default_rng(3)
    tf = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
    tf[:, :3, 3] = 0.05 * rng.normal(size=(cap, 3))
    tf[:, :3, :3] += 0.02 * rng.normal(size=(cap, 3, 3))
    color = rng.uniform(size=(cap, 3)).astype(np.float32)
    ref = j_render(jcam, jp, ja.alive, jnp.zeros(3), jnp.asarray(tf),
                   is_6dof=True, scaling_modifier=0.8,
                   override_color=jnp.asarray(color), with_features=False,
                   raster_cfg=JRasterConfig(pairs_per_gaussian=16),
                   backend="pallas_interpret")
    got = t_render(tcam, tp, ta.alive, torch.zeros(3), torch.from_numpy(tf),
                   is_6dof=True, scaling_modifier=0.8,
                   override_color=torch.from_numpy(color),
                   with_features=False,
                   raster_cfg=TRasterConfig(pairs_per_gaussian=16))
    check(ref, got, ("render", "depth", "alpha"))
    assert "render_gaussian_features" not in got


def test_mean2d_offset_grad_through_render():
    """The densification signal (reference train.py:366): the gradient of
    a zero screen-space offset through render, against trase_tpu's
    through the Pallas path in interpret mode (test_rasterize_pallas.py::
    test_mean2d_offset_grad_through_render's scene), within 3e-4 of
    scale; the deformed field and dead slots included."""
    jp, ja, tp, ta = field(n=40, seed=4, sh_degree=1)
    jcam, tcam = cameras()
    cap = jp.xyz.shape[0]
    d = (0.03 * np.random.default_rng(5).normal(size=(cap, 3))).astype(
        np.float32)
    w = np.random.default_rng(6).normal(size=(3, H, W)).astype(np.float32)

    def jloss(off):
        out = j_render(jcam, jp, ja.alive, jnp.zeros(3), jnp.asarray(d),
                       sh_degree=1, mean2d_offset=off, with_features=False,
                       raster_cfg=JRasterConfig(pairs_per_gaussian=16),
                       backend="pallas_interpret")
        return jnp.sum(out["render"] * jnp.asarray(w))

    ref = np.asarray(jax.grad(jloss)(jnp.zeros((cap, 2))))
    off = torch.zeros((cap, 2), requires_grad=True)
    out = t_render(tcam, tp, ta.alive, torch.zeros(3), torch.from_numpy(d),
                   sh_degree=1, mean2d_offset=off, with_features=False,
                   raster_cfg=TRasterConfig(pairs_per_gaussian=16))
    got, = torch.autograd.grad((out["render"] * torch.from_numpy(w)).sum(),
                               off)
    got = got.numpy()
    assert np.isfinite(got).all() and np.abs(got).sum() > 0
    assert not got[~np.asarray(ja.alive)].any()  # dead slots: no signal
    assert np.abs(got - ref).max() / (np.abs(ref).max() + 1e-8) < 3e-4


def test_render_gradients_reach_params_and_deltas():
    """Under autograd the render differentiates into the raw gaussian
    parameters and the deformation deltas (the GAUSSIAN step's inputs),
    and the gradients agree with trase_tpu's (Pallas, interpret mode)."""
    jp, ja, tp, ta = field(n=40, seed=7, sh_degree=1)
    jcam, tcam = cameras()
    cap = jp.xyz.shape[0]
    rng = np.random.default_rng(8)
    d = [(s * rng.normal(size=(cap, k))).astype(np.float32)
         for s, k in ((0.03, 3), (0.05, 4), (0.002, 3))]
    w = rng.normal(size=(3, H, W)).astype(np.float32)
    names = ("xyz", "opacity", "scaling", "features_dc")

    def jloss(fields, deltas):
        out = j_render(jcam, jp._replace(**dict(zip(names, fields))),
                       ja.alive, jnp.zeros(3), *deltas, sh_degree=1,
                       with_features=False,
                       raster_cfg=JRasterConfig(pairs_per_gaussian=16),
                       backend="pallas_interpret")
        return jnp.sum(out["render"] * jnp.asarray(w))

    ref = jax.grad(jloss, argnums=(0, 1))(
        [getattr(jp, k) for k in names], [jnp.asarray(x) for x in d])
    leaves = [getattr(tp, k).clone().requires_grad_(True) for k in names]
    deltas = [torch.from_numpy(x).requires_grad_(True) for x in d]
    out = t_render(tcam, tp._replace(**dict(zip(names, leaves))), ta.alive,
                   torch.zeros(3), *deltas, sh_degree=1, with_features=False,
                   raster_cfg=TRasterConfig(pairs_per_gaussian=16))
    got = torch.autograd.grad((out["render"] * torch.from_numpy(w)).sum(),
                              leaves + deltas)
    for name, a, b in zip(names + ("d_xyz", "d_rot", "d_scale"),
                          list(ref[0]) + list(ref[1]), got):
        a, b = np.asarray(a), b.numpy()
        scale = np.abs(a).max() + 1e-8
        assert np.abs(a - b).max() / scale < 3e-4, name


@pytest.mark.parametrize("option", [
    dict(layout=(36, 0, True)), dict(layout=(36, 16, True)),
    dict(layout=(4, 0, True), values_only=True),
    dict(layout=(8, 0, True), raises=True)])
def test_training_options_not_ported(option):
    """The options the card's backward once lacked, 32 features beside rgb
    + depth under autograd (unpacked and packed) and values-only with
    colour, now pass check_card_backward, as does every forward layout in
    both modes; a layout the forward has no kernel for either still
    raises."""
    from trase_tpu_torch.ops import rasterize_cuda as TRC

    option = dict(option)
    if option.pop("raises", False):
        with pytest.raises(NotImplementedError, match="no compositor kernel"):
            TRC.check_card_backward(**option)
        return
    TRC.check_card_backward(**option)
    for layout in TRC.SUPPORTED:
        TRC.check_card_backward(layout)
        TRC.check_card_backward(layout, values_only=True)


@pytest.mark.parametrize("values_only", [False, True])
def test_render_features_only_smoothed(values_only):
    """render(with_color=False) with a smoothing map and trase_tpu's
    slot permutation, the FEATURE step's call: the [acc | feats] image
    and alpha against trase_tpu's (Pallas, interpret mode) within
    TOL["feats"], no render / depth keys, and the gradients in the raw
    features and (full mode) in mean2d_offset within 3e-4 of scale; in
    values-only mode the offset gets exact zeros."""
    from trase_tpu.ops.knn import build_feature_smooth_map

    jp, ja, tp, ta = field(n=60, seed=9, sh_degree=1)
    rng = np.random.default_rng(10)
    cap = jp.xyz.shape[0]
    f = rng.normal(size=(cap, 32)).astype(np.float32)
    jp = jp._replace(gaussian_features=jnp.asarray(f))
    tp = tp._replace(gaussian_features=torch.from_numpy(f))
    jcam, tcam = cameras()
    nmap = np.array(build_feature_smooth_map(jp.xyz, 16))
    key = jax.random.PRNGKey(4)
    perm = np.array(jax.random.permutation(key, 16)[:8])
    w = rng.normal(size=(H, W, 33)).astype(np.float32)
    cfg = dict(raster_cfg=JRasterConfig(pairs_per_gaussian=16))

    def jloss(feats, off):
        out = j_render(jcam, jp._replace(gaussian_features=feats), ja.alive,
                       jnp.zeros(3), sh_degree=1, mean2d_offset=off,
                       with_color=False, grad_values_only=values_only,
                       smooth_map=jnp.asarray(nmap), smooth_rng=key,
                       backend="pallas_interpret", **cfg)
        return jnp.sum(out["render_gaussian_features_acc_hwc"] * w), out

    (_, ref), rg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(f), jnp.zeros((cap, 2)))
    feats = torch.from_numpy(f).requires_grad_(True)
    off = torch.zeros((cap, 2), requires_grad=True)
    got = t_render(tcam, tp._replace(gaussian_features=feats), ta.alive,
                   torch.zeros(3), sh_degree=1, mean2d_offset=off,
                   with_color=False, grad_values_only=values_only,
                   smooth_map=torch.from_numpy(nmap),
                   smooth_perm=torch.from_numpy(perm),
                   raster_cfg=TRasterConfig(pairs_per_gaussian=16))
    assert "render" not in got and "depth" not in got
    for k in ("render_gaussian_features_acc_hwc", "alpha",
              "render_gaussian_features"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(ref[k]), atol=TOL["feats"],
                                   rtol=0, err_msg=k)
    np.testing.assert_array_equal(got["radii"].numpy(),
                                  np.asarray(ref["radii"]))
    loss = (got["render_gaussian_features_acc_hwc"]
            * torch.from_numpy(w)).sum()
    gf, goff = torch.autograd.grad(loss, [feats, off], allow_unused=True)
    for name, a, b in (("features", rg[0], gf), ("offset", rg[1], goff)):
        a = np.asarray(a)
        b = np.zeros_like(a) if b is None else b.numpy()
        if values_only and name == "offset":
            assert not a.any() and not b.any()
            continue
        assert np.abs(b).max() > 0, name
        assert np.abs(a - b).max() / np.abs(a).max() < 3e-4, name


def test_feature3d_to_rgb_up_to_sign():
    """PCA colours agree up to the sign of each component: each port
    column is an affine image of the JAX column (|correlation| = 1)."""
    from trase_tpu.viz import feature3d_to_rgb as j_pca
    from trase_tpu_torch.viz import feature3d_to_rgb as t_pca

    rng = np.random.default_rng(5)
    x = (rng.normal(size=(300, 32)) * np.linspace(3, 0.1, 32)).astype(
        np.float32)
    a = np.asarray(j_pca(jnp.asarray(x)))
    b = t_pca(torch.from_numpy(x)).numpy()
    assert a.shape == b.shape == (300, 3)
    assert b.min() >= 0.0 and b.max() <= 1.0
    for c in range(3):
        r = np.corrcoef(a[:, c], b[:, c])[0, 1]
        assert abs(abs(r) - 1.0) < 1e-4, (c, r)


IT = 77


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A Blender-format dataset plus a model directory as the JAX trainer
    writes it (tests/test_render_cli.py's fixture plus a deform.pkl)."""
    from trase_tpu.data.synthetic import write_synthetic_dataset
    from trase_tpu.utils.sh import rgb_to_sh

    base = tmp_path_factory.mktemp("cli")
    src, mdl = str(base / "data"), str(base / "model")
    scene = write_synthetic_dataset(src, n_train=2, n_test=2, image_size=48,
                                    n_blobs=3, pts_per_blob=32)
    n = scene["xyz"].shape[0]
    params = JG.empty_params(capacity=n, sh_degree=1)
    params = params._replace(
        xyz=jnp.asarray(scene["xyz"]),
        features_dc=jnp.asarray(rgb_to_sh(scene["rgb"]))[:, None, :],
        scaling=jnp.full((n, 3), np.log(scene["scale"])),
        rotation=jnp.zeros((n, 4)).at[:, 0].set(1.0),
        opacity=jnp.full((n, 1), 2.0),
        gaussian_features=jnp.asarray(np.random.default_rng(11).normal(
            size=(n, JG.FEATURE_DIM)).astype(np.float32)),
    )
    save_gaussian_ply(os.path.join(mdl, "point_cloud", f"iteration_{IT}",
                                   "point_cloud.ply"), params,
                      np.ones(n, bool))
    net = JD.make_deform_network("DeformNetwork", is_blender=True)
    v = jax.tree_util.tree_map(np.asarray,
                               JD.init_deform(jax.random.PRNGKey(0), net))
    for head in ("Dense_10", "Dense_11", "Dense_12"):  # small deformations
        v["params"][head]["kernel"] = v["params"][head]["kernel"] * 0.05
    save_checkpoint(os.path.join(mdl, "deform", f"iteration_{IT}",
                                 "deform.pkl"),
                    {"vars": v, "type": "DeformNetwork"})
    return src, mdl


def _pngs(folder):
    from PIL import Image

    out = {}
    for f in sorted(os.listdir(folder)):
        if f.endswith(".png"):
            with Image.open(os.path.join(folder, f)) as im:
                out[f] = np.asarray(im, np.int16)
    return out


def test_cli_matches_root_render_py(model_dir, tmp_path):
    """Both CLIs on their own copy of one model directory: the renders/
    and canonical/ PNGs agree within one 8-bit level (float sums that
    differ in the last bits can round to neighbouring levels).
    --segment_ids is passed because the root render.py reads
    args.segment_ids unguarded; without clusters it selects nothing."""
    import render as j_cli
    from trase_tpu_torch import render as t_cli

    src, mdl = model_dir
    outs = {}
    for name, cli, extra in (("jax", j_cli, []),
                             ("port", t_cli, ["--device", "cpu"])):
        copy = str(tmp_path / name)
        shutil.copytree(mdl, copy)
        cli.main(["-s", src, "-m", copy, "--iteration", str(IT),
                  "--skip_train", "--sh_degree", "1", "--is_blender",
                  "--eval", "--pairs_per_gaussian", "16",
                  "--segment_ids", "0"] + extra)
        outs[name] = os.path.join(copy, "test", f"ours_{IT}")
    for stream, count in (("renders", 2), ("canonical", 1), ("gt", 2)):
        a = _pngs(os.path.join(outs["jax"], stream))
        b = _pngs(os.path.join(outs["port"], stream))
        assert sorted(a) == sorted(b) and len(b) == count, stream
        for f in a:
            assert np.abs(a[f] - b[f]).max() <= 1, (stream, f)
    assert len(_pngs(os.path.join(outs["port"], "rendered_feats"))) == 2
    feats3d = np.load(os.path.join(outs["port"], "rendered_feats",
                                   "gaussian_feats3d.npy"))
    np.testing.assert_array_equal(feats3d, np.load(os.path.join(
        outs["jax"], "rendered_feats", "gaussian_feats3d.npy")))
