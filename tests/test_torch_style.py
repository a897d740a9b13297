"""Port parity for the style-transfer path: losses/style.py (values and
gradients against jax.grad, with tied columns in the NNFM max), the
bounded clip's gradient, and one engine.trainer.style_phase_step against
trase_tpu's on a 2000-gaussian 64x64 scene from one state (made with
numpy, carried across as numpy).

Tolerances: the losses 1e-5 of scale (the same float32 expressions); the
step's loss 1e-5, its colours and Adam moments 1e-4 of each tensor's
scale, the densification statistics 1e-4, every other field bit-equal.
With the deform net on, both packages run its hidden stack in bf16 and
round at other places (d_xyz differs by ~3e-3 of its scale), so that arm
feeds the port's step trase_tpu's deform outputs and checks the port's
own bf16 deform against them at 1e-2."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trase_tpu.engine import trainer as JT
from trase_tpu.losses import style as JS
from trase_tpu.models import deform as JD
from trase_tpu.models import vgg as JV
from trase_tpu.ops.rasterize import RasterConfig as JRasterConfig
from trase_tpu.renderer import make_render_camera as j_camera
from trase_tpu.renderer import render as j_render

from trase_tpu_torch.engine import trainer as TT
from trase_tpu_torch.losses import style as TS
from trase_tpu_torch.models import deform as TD
from trase_tpu_torch.models import vgg as TV
from trase_tpu_torch.ops.rasterize import RasterConfig as TRasterConfig
from trase_tpu_torch.renderer import make_render_camera as t_camera
from trase_tpu_torch.renderer import render as t_render

from test_torch_train import jax_field, np_tree

torch.set_num_threads(2)

H = W = 64
N_GAUSS, CAP = 2000, 2048
LOSS_TOL, STEP_TOL, DEFORM_TOL = 1e-5, 1e-4, 1e-2


def close(a, b, tol, name=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-12)
    assert err < tol, (name, err, tol)


def t32(x):
    return torch.tensor(np.asarray(x, np.float32))


def grads_both(jfn, tfn, arrays):
    """(value, grads) of a scalar function of `arrays` in both packages."""
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    xs = [t32(a).requires_grad_(True) for a in arrays]
    tv = tfn(*xs)
    tg = torch.autograd.grad(tv, xs, allow_unused=True)
    return (float(jv), [np.asarray(g) for g in jg]), \
        (float(tv.detach()), [np.zeros(x.shape, np.float32) if g is None
                              else g.numpy() for x, g in zip(xs, tg)])


# ------------------------------------------------------------ the losses


def _nnfm_argmax(f1, f2):
    def unit(f):
        return f / (np.linalg.norm(f, axis=0, keepdims=True) + 1e-12)
    return (unit(f1).T @ unit(f2)).argmax(axis=1)


@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "tied"])
def test_nnfm_value_and_grad(dup):
    """NNFM on (C, N1) against (C, N2) features. `tied`: feat2 repeats
    columns (a flat style region), so the max ties: both packages split
    the gradient evenly (amax, jnp.max), after picking the same columns."""
    rng = np.random.default_rng(0)
    f1 = rng.normal(size=(16, 40)).astype(np.float32)
    f2 = rng.normal(size=(16, 30)).astype(np.float32)
    if dup:
        f2[:, 10:20] = f2[:, 5:6]
        f1[:, :8] = f2[:, 5:6] + 0.01 * rng.normal(size=(16, 1))
    (jv, jg), (tv, tg) = grads_both(JS.loss_nnfm_style, TS.loss_nnfm_style,
                                    [f1, f2])
    assert abs(jv - tv) <= LOSS_TOL * max(abs(jv), 1.0)
    for a, b, name in zip(jg, tg, ("feat1", "feat2")):
        close(a, b, LOSS_TOL * 10, name)
    if dup:
        # the tied columns receive equal shares of the gradient
        g = tg[1]
        np.testing.assert_allclose(g[:, 10:20], g[:, 10:11].repeat(10, 1),
                                   rtol=1e-5, atol=1e-9)
        assert np.abs(g[:, 10:20]).sum() > 0


@pytest.mark.parametrize("name", ["adain", "gram", "mse", "mean_std"])
def test_style_losses_value_and_grad(name):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 8, 6, 5)).astype(np.float32)
    y = rng.normal(size=(1, 8, 6, 5)).astype(np.float32)
    fns = {
        "adain": (JS.adain_style_loss, TS.adain_style_loss),
        "gram": (lambda a, b: JS.style_loss_gram(a, b, 3.0),
                 lambda a, b: TS.style_loss_gram(a, b, 3.0)),
        "mse": (JS.mse_content_loss, TS.mse_content_loss),
        "mean_std": (lambda a, b: sum(JS._mean_std(a)[i].sum() * (i + 1)
                                      for i in range(2)),
                     lambda a, b: sum(TS._mean_std(a)[i].sum() * (i + 1)
                                      for i in range(2))),
    }[name]
    (jv, jg), (tv, tg) = grads_both(*fns, [x, y])
    assert abs(jv - tv) <= LOSS_TOL * max(abs(jv), 1.0), (jv, tv)
    for a, b in zip(jg, tg):
        if np.abs(a).max() > 0:
            close(a, b, LOSS_TOL * 10, name)
    np.testing.assert_allclose(TS.gram_matrix(t32(x)).numpy(),
                               np.asarray(JS.gram_matrix(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def test_clip_unit_gradient_halves_at_the_bounds():
    """jnp.clip passes half the cotangent at a bound; torch.clamp all of
    it; the step's clip matches jnp.clip."""
    x = np.array([-0.5, 0.0, 0.3, 1.0, 1.5], np.float32)
    jg = jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(jnp.asarray(x))
    xt = t32(x).requires_grad_(True)
    tg, = torch.autograd.grad(TT.clip_unit(xt).sum(), xt)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tg.numpy(), [0, 0.5, 1, 0.5, 0])


# ------------------------------------------------------------ the step


class _Opt:
    position_lr_init, position_lr_final = 0.00016, 0.0000016
    position_lr_delay_mult, position_lr_max_steps = 0.01, 30_000
    deform_lr_max_steps = 40_000
    feature_lr, opacity_lr, scaling_lr, rotation_lr = \
        0.0025, 0.05, 0.005, 0.001


def style_image(seed=3):
    """A seeded style image: a flat band (identical VGG columns: ties in
    the NNFM max) above noise."""
    img = np.random.default_rng(seed).uniform(size=(3, H, W)).astype(
        np.float32)
    img[:, : H // 2] = 0.2
    return img


@pytest.fixture(scope="module")
def step_case():
    jp, ja = jax_field(n=N_GAUSS, cap=CAP, seed=5)
    net = JD.make_deform_network("DeformNetwork")
    dvars = JD.init_deform(jax.random.PRNGKey(1), net)
    for head in ("Dense_8", "Dense_9", "Dense_10"):  # small deformations
        dvars["params"][head]["kernel"] = \
            dvars["params"][head]["kernel"] * 0.05
    jstate = JT.init_train_state(jp, ja, dvars)
    mask = np.asarray(jp.xyz)[:, 0] > 0  # about half the gaussians
    R, T = np.eye(3), np.array([0.05, -0.02, 0.0])
    jvgg = JV.VGGFeatureExtractor(["conv4_1"], JV.VGG16_BLOCKS)
    ref = jvgg(jvgg.normalize(jnp.asarray(style_image())))["conv4_1"][0]
    ref = np.asarray(ref.reshape(ref.shape[0], -1))
    lrs = TT.make_learning_rate_schedules(_Opt)(3100)
    return dict(net=net, jstate=jstate, mask=mask, ref=ref, lrs=lrs,
                jcam=j_camera(R, T, 0.9, 0.9, H, W),
                tcam=t_camera(R, T, 0.9, 0.9, H, W, device="cpu"),
                jvgg=jvgg,
                tvgg=TV.VGGFeatureExtractor(["conv4_1"], TV.VGG16_BLOCKS,
                                            device="cpu"))


def _jax_deltas(c, fid):
    s = c["jstate"]
    return JT._apply_deform(c["net"], s.deform_vars, s.params.xyz,
                            jnp.float32(fid), 0.0, True,
                            stop_grad_deform=True,
                            gaussian_features=s.params.gaussian_features)


@pytest.mark.parametrize("use_deform", [False, True],
                         ids=["no_deform", "deform"])
def test_style_step_matches(step_case, use_deform, monkeypatch):
    c, fid = step_case, 0.4
    cfg = 16
    jnew, jm = JT.style_phase_step(
        c["jstate"], c["jcam"].buffers, jnp.asarray(c["ref"]),
        jnp.asarray(c["mask"]), jnp.float32(fid),
        JT.LearningRates(*c["lrs"]), jnp.zeros(3), deform_net=c["net"],
        vgg_ext=c["jvgg"], image_height=H, image_width=W, sh_degree=1,
        use_deform=use_deform, is_6dof=False, fx_key="conv4_1",
        raster_cfg=JRasterConfig(pairs_per_gaussian=cfg))
    tnet = TD.make_deform_network(device="cpu")
    tstate = TT.train_state_from_numpy(np_tree(c["jstate"]), "cpu")
    deltas = (0.0, 0.0, 0.0)
    if use_deform:
        deltas = [t32(d) for d in _jax_deltas(c, fid)]
        with torch.no_grad():
            own = TT.apply_deform(tnet, tstate.deform, tstate.params.xyz,
                                  fid, 0.0, True)
        for a, b, name in zip(deltas, own, ("d_xyz", "d_rot", "d_scale")):
            close(a, b, DEFORM_TOL, name)
        monkeypatch.setattr(TT, "apply_deform", lambda *a, **k: deltas)

    # both packages' renders pick the same NNFM columns (no near-tie flips
    # the gradient to another style column)
    tparams = tstate.params
    with torch.no_grad():
        img = TT.clip_unit(t_render(
            c["tcam"], tparams, tstate.aux.alive, torch.zeros(3), *deltas,
            sh_degree=1, with_features=False,
            raster_cfg=TRasterConfig(pairs_per_gaussian=cfg))["render"])
        tf = c["tvgg"](c["tvgg"].normalize(img))["conv4_1"][0]
    jimg = jnp.clip(j_render(
        c["jcam"], c["jstate"].params, c["jstate"].aux.alive, jnp.zeros(3),
        *(_jax_deltas(c, fid) if use_deform else (0.0, 0.0, 0.0)),
        sh_degree=1, with_features=False,
        raster_cfg=JRasterConfig(pairs_per_gaussian=cfg))["render"], 0, 1)
    jf = c["jvgg"](c["jvgg"].normalize(jimg))["conv4_1"][0]
    np.testing.assert_array_equal(
        _nnfm_argmax(tf.reshape(512, -1).numpy(), c["ref"]),
        _nnfm_argmax(np.asarray(jf).reshape(512, -1), c["ref"]))

    tnew, tm = TT.style_phase_step(
        tstate, c["tcam"], t32(c["ref"]), torch.from_numpy(c["mask"]), fid,
        c["lrs"], torch.zeros(3), deform_net=tnet, vgg_ext=c["tvgg"],
        sh_degree=1, use_deform=use_deform, is_6dof=False, fx_key="conv4_1",
        raster_cfg=TRasterConfig(pairs_per_gaussian=cfg))
    assert bool(tm["finite"]) and bool(jm["finite"])
    assert abs(float(tm["loss"]) - float(jm["loss"])) < LOSS_TOL
    ref = TT.train_state_to_numpy(TT.train_state_from_numpy(
        np_tree(jnew), "cpu"))
    got = TT.train_state_to_numpy(tnew)
    old = TT.train_state_to_numpy(tstate)
    frozen = ~(np.asarray(c["jstate"].aux.alive) & c["mask"])
    for k in ("features_dc", "features_rest"):
        close(ref["params"][k], got["params"][k], STEP_TOL, k)
        for m in ("mu", "nu"):
            close(ref["opt"][k][m], got["opt"][k][m], STEP_TOL, f"{m} {k}")
            np.testing.assert_array_equal(got["opt"][k][m][frozen],
                                          old["opt"][k][m][frozen])
        assert got["opt"][k]["step"] == ref["opt"][k]["step"] == 1
        np.testing.assert_array_equal(got["params"][k][frozen],
                                      old["params"][k][frozen])
        assert (got["params"][k][~frozen] != old["params"][k][~frozen]).any()
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        close(ref["aux"][k], got["aux"][k], STEP_TOL, k)
    assert got["aux"]["denom"].sum() > 0
    changed = {("params", "features_dc"), ("params", "features_rest"),
               ("opt", "features_dc"), ("opt", "features_rest"),
               ("aux", "xyz_gradient_accum"), ("aux", "denom"),
               ("aux", "max_radii2d")}
    for part in ("params", "aux", "opt"):
        for k, v in old[part].items():
            if (part, k) in changed:
                continue
            leaves = v.values() if isinstance(v, dict) else [v]
            for a, b in zip(leaves, (got[part][k].values()
                                     if isinstance(v, dict)
                                     else [got[part][k]])):
                np.testing.assert_array_equal(a, b, err_msg=f"{part}.{k}")
    for a, b in zip(tstate.deform, tnew.deform):
        assert torch.equal(a, b)


def test_nan_guard_skips_the_style_step(step_case):
    """A non-finite style target leaves the whole state as it was."""
    c = step_case
    tstate = TT.train_state_from_numpy(np_tree(c["jstate"]), "cpu")
    ref = t32(c["ref"])
    ref[0, 0] = float("nan")
    new, m = TT.style_phase_step(
        tstate, c["tcam"], ref, torch.from_numpy(c["mask"]), 0.4, c["lrs"],
        torch.zeros(3), deform_net=TD.make_deform_network(device="cpu"),
        vgg_ext=c["tvgg"], sh_degree=1, use_deform=False, is_6dof=False,
        fx_key="conv4_1", raster_cfg=TRasterConfig(pairs_per_gaussian=16))
    assert not bool(m["finite"])
    for a, b in zip(TT.float_tensors(new), TT.float_tensors(tstate)):
        assert torch.equal(a, b)
