"""Port parity for the GAUSSIAN training phase: Adam, SSIM / L1, the
densification ops, the bf16 deform stack and one whole GAUSSIAN step of
trase_tpu_torch against trase_tpu on the same state (made with numpy,
carried across as numpy), and the port's training CLI on a synthetic
dataset whose snapshot both packages' render paths read."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trase_tpu.engine import optim as JO
from trase_tpu.engine import trainer as JT
from trase_tpu.models import deform as JD
from trase_tpu.models import gaussians as JG
from trase_tpu.ops.rasterize import RasterConfig as JRasterConfig
from trase_tpu.ops.ssim import ssim as j_ssim
from trase_tpu.renderer import make_render_camera as j_camera

from trase_tpu_torch.engine import optim as TO
from trase_tpu_torch.engine import trainer as TT
from trase_tpu_torch.losses.image_losses import l1_loss as t_l1
from trase_tpu_torch.models import deform as TD
from trase_tpu_torch.models import gaussians as TG
from trase_tpu_torch.ops.rasterize import RasterConfig as TRasterConfig
from trase_tpu_torch.ops.ssim import ssim as t_ssim
from trase_tpu_torch.renderer import make_render_camera as t_camera

torch.set_num_threads(2)

H, W = 40, 56


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t32(x):
    return torch.tensor(np.asarray(x))


def t_opt(jopt):
    """trase_tpu GaussianOptState -> the port's, via numpy."""
    return TG.GaussianOptState(**{
        k: TO.AdamState(t32(s.mu), t32(s.nu),
                        torch.tensor(np.asarray(s.step), dtype=torch.int32))
        for k, s in jopt._asdict().items()})


def close(a, b, tol, name=""):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(a).max() + 1e-12
    err = np.abs(a - b).max() / scale
    assert err < tol, (name, err, tol)


def jax_field(n=60, cap=128, seed=0, sh_degree=1):
    """A trase_tpu field with varied rotations, opacities, scales, SH
    and dead slots inside the live range."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    pts[:, 2] += 3.0
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    p, a = JG.from_point_cloud(pts, cols, sh_degree=sh_degree, capacity=cap,
                               dist2=np.full(n, 0.006, np.float32))
    p = p._replace(
        rotation=p.rotation.at[:n].set(jnp.asarray(
            rng.normal(size=(n, 4)).astype(np.float32))),
        opacity=p.opacity.at[:n].set(jnp.asarray(
            rng.normal(0.5, 1.5, size=(n, 1)).astype(np.float32))),
        features_rest=jnp.asarray((0.2 * rng.normal(
            size=p.features_rest.shape)).astype(np.float32)),
        scaling=p.scaling.at[:n].add(jnp.asarray(
            rng.uniform(-0.6, 0.6, size=(n, 3)).astype(np.float32))))
    alive = np.asarray(a.alive).copy()
    alive[:4] = False
    return p, a._replace(alive=jnp.asarray(alive))


# ------------------------------------------------------------ pieces


def test_adam_row_mask_matches():
    """Two row-masked Adam steps equal trase_tpu's (same expressions;
    1e-6 of scale)."""
    rng = np.random.default_rng(0)
    p = rng.normal(size=(50, 3)).astype(np.float32)
    mask = rng.uniform(size=50) < 0.7
    js, ts = JO.adam_init(jnp.asarray(p)), TO.adam_init(t32(p))
    jp, tp = jnp.asarray(p), t32(p)
    for step in range(2):
        g = rng.normal(size=(50, 3)).astype(np.float32)
        jp, js = JO.adam_update(jp, jnp.asarray(g), js, 0.01,
                                row_mask=jnp.asarray(mask))
        tp, ts = TO.adam_update(tp, t32(g), ts, 0.01,
                                row_mask=torch.from_numpy(mask))
    close(jp, tp.numpy(), 1e-6, "param")
    close(js.mu, ts.mu.numpy(), 1e-6, "mu")
    close(js.nu, ts.nu.numpy(), 1e-6, "nu")
    assert int(ts.step) == int(js.step) == 2
    np.testing.assert_array_equal(tp.numpy()[~mask], p[~mask])


def test_ssim_and_l1_match():
    """SSIM (a depthwise conv here, shifted adds in trase_tpu) and L1,
    values and gradients: 1e-5 of scale."""
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(3, H, W)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda x: j_ssim(x, jnp.asarray(b)))(
        jnp.asarray(a))
    x = t32(a).requires_grad_(True)
    tv = t_ssim(x, t32(b))
    tg, = torch.autograd.grad(tv, x)
    assert abs(float(jv) - float(tv.detach())) < 1e-5
    close(jg, tg.numpy(), 1e-5, "ssim grad")
    assert abs(float(t_l1(t32(a), t32(b)))
               - float(jnp.abs(jnp.asarray(a) - jnp.asarray(b)).mean())) \
        < 1e-7


def test_add_densification_stats_matches():
    rng = np.random.default_rng(2)
    _, ja = jax_field()
    ja = ja._replace(xyz_gradient_accum=jnp.asarray(
        rng.uniform(size=128).astype(np.float32)))
    g = (rng.normal(size=(128, 2)) * 1e-4).astype(np.float32)
    vis = rng.uniform(size=128) < 0.6
    radii = rng.uniform(0, 9, size=128).astype(np.float32)
    ref = JG.add_densification_stats(ja, jnp.asarray(g), jnp.asarray(vis),
                                     jnp.asarray(radii), H, W)
    _, ta = TG.params_from_numpy(np_tree(jax_field()[0]), np_tree(ja), "cpu")
    got = TG.add_densification_stats(ta, t32(g), torch.from_numpy(vis),
                                     t32(radii), H, W)
    for k in TG.GaussianAux._fields:
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("max_screen_size", [0.0, 6.0])
def test_densify_and_prune_matches(max_screen_size):
    """Clone, split (trase_tpu's standard normals injected), prune and
    the optimizer-row resets, with a max_new small enough to drop
    candidates: every tensor equal up to float rounding."""
    rng = np.random.default_rng(3)
    jp, ja = jax_field(n=60, cap=96)
    jp = jp._replace(opacity=jp.opacity.at[10:13].set(-7.0))  # prunable
    cap = 96
    ja = ja._replace(
        xyz_gradient_accum=jnp.asarray(
            rng.uniform(0, 2e-3, size=cap).astype(np.float32)),
        denom=jnp.asarray(rng.integers(1, 4, size=cap).astype(np.float32)),
        max_radii2d=jnp.asarray(rng.uniform(0, 10, size=cap).astype(
            np.float32)))
    jopt = JG.init_opt_state(jp)
    jopt = jopt._replace(xyz=jopt.xyz._replace(mu=jnp.asarray(
        rng.normal(size=(cap, 3)).astype(np.float32))))
    cfg = JG.DensifyConfig()
    max_new, extent = 12, 10.0
    key = jax.random.PRNGKey(7)
    rp, ra, ro, rs = JG.densify_and_prune(jp, ja, jopt, cfg, extent,
                                          max_screen_size, key, max_new)
    keys = jax.random.split(key, cfg.split_n)
    samples = np.stack([np.asarray(jax.random.normal(k, (max_new, 3)))
                        for k in keys])
    assert samples.shape == TG.split_sample_shape(cap, max_new)
    tp, ta = TG.params_from_numpy(np_tree(jp), np_tree(ja), "cpu")
    gp, ga, go, gs = TG.densify_and_prune(
        tp, ta, t_opt(jopt), TG.DensifyConfig(), extent, max_screen_size,
        max_new, samples=t32(samples))
    for k in TG.GaussianParams._fields:
        np.testing.assert_allclose(getattr(gp, k).numpy(),
                                   np.asarray(getattr(rp, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    for k in TG.GaussianAux._fields:
        np.testing.assert_array_equal(getattr(ga, k).numpy(),
                                      np.asarray(getattr(ra, k)), err_msg=k)
    for k in TG.GaussianOptState._fields:
        np.testing.assert_array_equal(getattr(go, k).mu.numpy(),
                                      np.asarray(getattr(ro, k).mu), k)
    for k in ("n_clone", "n_split", "n_pruned", "n_alive", "dropped"):
        assert int(gs[k]) == int(rs[k]), k
    assert int(rs["n_clone"]) > 0 and int(rs["n_split"]) > 0
    assert int(rs["dropped"]) > 0 and int(rs["n_pruned"]) > 0


def test_reset_opacity_and_grow_capacity_match():
    jp, ja = jax_field(n=40, cap=64)
    jopt = JG.init_opt_state(jp)
    tp, ta = TG.params_from_numpy(np_tree(jp), np_tree(ja), "cpu")
    rp, _ = JG.reset_opacity(jp, ja, jopt)
    gp, go = TG.reset_opacity(tp, ta, t_opt(jopt))
    np.testing.assert_allclose(gp.opacity.numpy(), np.asarray(rp.opacity),
                               rtol=1e-6)
    assert not go.opacity.mu.any()
    rp, ra, ro = JG.grow_capacity(jp, ja, jopt, 128)
    gp, ga, go = TG.grow_capacity(tp, ta, t_opt(jopt), 128)
    for k in TG.GaussianParams._fields:
        np.testing.assert_array_equal(getattr(gp, k).numpy(),
                                      np.asarray(getattr(rp, k)), k)
    for k in TG.GaussianAux._fields:
        np.testing.assert_array_equal(getattr(ga, k).numpy(),
                                      np.asarray(getattr(ra, k)), k)
    assert go.xyz.mu.shape == (128, 3)


@pytest.mark.parametrize("is_blender", [False, True])
def test_bf16_deform_matches_flax(is_blender):
    """The bf16 hidden stack against flax's dtype=bfloat16, within
    test_bf16_deform_close's 2e-2 of scale (bf16 rounds at other places
    in the two frameworks); the f32 stack within 1e-5."""
    net = JD.make_deform_network("DeformNetwork", is_blender=is_blender)
    dvars = JD.init_deform(jax.random.PRNGKey(0), net)
    tnet = TD.load_flax_params(
        TD.make_deform_network(is_blender=is_blender, device="cpu"),
        np_tree(dvars))
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(256, 3)).astype(np.float32)
    t = np.full((256, 1), 0.37, np.float32)
    for dtype, tdtype, tol in ((None, None, 1e-5),
                               (jnp.bfloat16, torch.bfloat16, 2e-2)):
        ref = JD.deform_step(net, dvars, jnp.asarray(xyz), jnp.asarray(t),
                             dtype=dtype)
        with torch.no_grad():
            got = TD.deform_step(tnet, t32(xyz), t32(t), dtype=tdtype)
        for a, b in zip(ref, got):
            assert b.dtype == torch.float32
            close(a, b.numpy(), tol, str(dtype))
    back = TD.flax_variables(tnet)
    for name, layer in dvars["params"].items():
        np.testing.assert_array_equal(back["params"][name]["kernel"],
                                      np.asarray(layer["kernel"]))


# ------------------------------------------------- one GAUSSIAN step


def step_inputs(use_deform):
    jp, ja = jax_field(n=80, cap=128, seed=5)
    net = JD.make_deform_network("DeformNetwork")
    dvars = JD.init_deform(jax.random.PRNGKey(1), net)
    # small deformations, as a trained net gives
    dvars = jax.tree_util.tree_map(lambda x: x, dvars)
    for head in ("Dense_8", "Dense_9", "Dense_10"):
        dvars["params"][head]["kernel"] = dvars["params"][head]["kernel"] \
            * 0.05
    jstate = JT.init_train_state(jp, ja, dvars)
    rng = np.random.default_rng(9)
    gt = rng.uniform(size=(3, H, W)).astype(np.float32)
    R, T = np.eye(3), np.array([0.05, -0.02, 0.0])
    jcam = j_camera(R, T, 0.9, 0.7, H, W)
    tcam = t_camera(R, T, 0.9, 0.7, H, W, device="cpu")

    class Opt:
        position_lr_init, position_lr_final = 0.00016, 0.0000016
        position_lr_delay_mult, position_lr_max_steps = 0.01, 30_000
        deform_lr_max_steps = 40_000
        feature_lr, opacity_lr, scaling_lr, rotation_lr = \
            0.0025, 0.05, 0.005, 0.001

    lrs = TT.make_learning_rate_schedules(Opt)(3100)
    assert lrs == JT.make_learning_rate_schedules(Opt)(3100)
    kw = dict(sh_degree=1, use_deform=use_deform, is_6dof=False,
              lambda_dssim=0.2, lambda_reg_deform=0.0)
    return net, jstate, gt, jcam, tcam, lrs, kw


@pytest.mark.parametrize("use_deform,tol", [(False, 1e-4), (True, 3e-2)])
def test_gaussian_step_matches(use_deform, tol):
    """One GAUSSIAN step from the same state against trase_tpu's
    _gaussian_phase_body on the CPU (its dense compositor): loss, Adam
    moments, densify stats, deform weights and moments, and the
    parameters where the gradient is clearly nonzero (a first Adam step
    moves every other entry by +-lr whatever its sign noise).
    Tolerances (of each tensor's scale): 1e-4 without the deform net
    (compositor sums associated differently; about 1e-6 seen); 3e-2 with
    it, whose hidden stack is bf16 in both and rounds at other places
    (about 8e-3 seen on the deform moments)."""
    net, jstate, gt, jcam, tcam, lrs, kw = step_inputs(use_deform)
    fid, ast = 0.4, 0.01
    jnew, jm = JT.gaussian_phase_step(
        jstate, jcam.buffers, jnp.asarray(gt), jnp.float32(fid),
        jnp.float32(ast), JT.LearningRates(*lrs), jnp.zeros(3),
        deform_net=net, image_height=H, image_width=W,
        raster_cfg=JRasterConfig(pairs_per_gaussian=16), **kw)
    tnet = TD.make_deform_network(device="cpu")
    tstate = TT.train_state_from_numpy(np_tree(jstate), "cpu")
    tnew, tm = TT.gaussian_phase_step(
        tstate, tcam, t32(gt), fid, ast, lrs, torch.zeros(3),
        deform_net=tnet, raster_cfg=TRasterConfig(pairs_per_gaussian=16),
        **kw)
    assert bool(tm["finite"]) and bool(jm["finite"])
    assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-5
    ref = TT.train_state_to_numpy(TT.train_state_from_numpy(
        np_tree(jnew), "cpu"))
    got = TT.train_state_to_numpy(tnew)
    for k in TT.TRAINED:
        mu = ref["opt"][k]["mu"]
        close(mu, got["opt"][k]["mu"], tol, f"mu {k}")
        close(ref["opt"][k]["nu"], got["opt"][k]["nu"], 2 * tol, f"nu {k}")
        big = np.abs(mu) > 0.05 * np.abs(mu).max()
        close(ref["params"][k][big], got["params"][k][big], tol, k)
        assert got["opt"][k]["step"] == ref["opt"][k]["step"] == 1
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        close(ref["aux"][k], got["aux"][k], tol, k)
    assert ref["aux"]["denom"].sum() > 0
    for name, layer in ref["deform_opt"]["params"].items():
        for part in ("kernel", "bias"):
            mu = layer[part]["mu"]
            close(mu, got["deform_opt"]["params"][name][part]["mu"],
                  tol if use_deform else 1e-9, f"{name} {part}")
            big = np.abs(mu) >= 0.05 * np.abs(mu).max()
            close(ref["deform_vars"]["params"][name][part][big],
                  got["deform_vars"]["params"][name][part][big], tol,
                  f"{name} {part}")


def test_nan_guard_skips_the_step():
    """A non-finite gradient leaves the whole state as it was, on the
    device flag alone."""
    net, jstate, gt, jcam, tcam, lrs, kw = step_inputs(False)
    tstate = TT.train_state_from_numpy(np_tree(jstate), "cpu")
    bad = gt.copy()
    bad[0, 0, 0] = np.nan
    new, m = TT.gaussian_phase_step(
        tstate, tcam, t32(bad), 0.4, 0.0, lrs, torch.zeros(3),
        deform_net=TD.make_deform_network(device="cpu"),
        raster_cfg=TRasterConfig(pairs_per_gaussian=16), **kw)
    assert not bool(m["finite"])
    for a, b in zip(TT.float_tensors(new), TT.float_tensors(tstate)):
        assert torch.equal(a, b)


# ------------------------------------------------------------ the CLI


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`python -m trase_tpu_torch.train --device cpu` on a synthetic
    Blender dataset, densifying at 15 and 30 and resetting opacity at 25
    (the calls are counted on the trainer module)."""
    from trase_tpu.data.synthetic import write_synthetic_dataset
    from trase_tpu_torch import train as t_train

    base = tmp_path_factory.mktemp("train")
    src, mdl = str(base / "data"), str(base / "model")
    write_synthetic_dataset(src, n_train=3, n_test=2, image_size=32,
                            n_blobs=2, pts_per_blob=24)
    calls = {"densify": [], "reset": []}
    densify, reset = TT.densify_step, TT.reset_opacity_step

    def count_densify(state, *a, **kw):
        calls["densify"].append(int(state.aux.alive.sum()))
        return densify(state, *a, **kw)

    def count_reset(state):
        calls["reset"].append(1)
        return reset(state)

    TT.densify_step, TT.reset_opacity_step = count_densify, count_reset
    try:
        trainer = t_train.main([
            "-s", src, "-m", mdl, "--iterations", "40", "--device", "cpu",
            "--is_blender", "--eval", "--sh_degree", "1", "--quiet",
            "--warm_up", "10", "--densify_from_iter", "10",
            "--densification_interval", "15", "--opacity_reset_interval",
            "25", "--pairs_per_gaussian", "16", "--save_iterations", "20"])
    finally:
        TT.densify_step, TT.reset_opacity_step = densify, reset
    return src, mdl, trainer, calls


def test_cli_trains_and_densifies(trained):
    src, mdl, trainer, calls = trained
    assert trainer.step_calls == 40 and int(trainer.skipped) == 0
    assert calls == {"densify": calls["densify"], "reset": [1]}
    assert len(calls["densify"]) == 2 and calls["densify"][0] == 48
    assert int(trainer.state.aux.alive.sum()) != 48  # the field changed
    for it in (20, 40):
        assert os.path.exists(os.path.join(
            mdl, "point_cloud", f"iteration_{it}", "point_cloud.ply"))
        assert os.path.exists(os.path.join(
            mdl, "deform", f"iteration_{it}", "deform.pkl"))
    assert int(trainer.state.opt.opacity.step) == 40


def test_snapshot_renders_in_both_packages(trained):
    """The port's snapshot loads in trase_tpu (its PLY loader, its deform
    checkpoint, its renderer in interpret mode) and in the port, and one
    test view renders alike (test_torch_render's tolerances); the port's
    render CLI writes its PNGs from it."""
    from trase_tpu.data.scene import Scene as JScene
    from trase_tpu.models.gaussians_io import (load_checkpoint,
                                               load_gaussian_ply)
    from trase_tpu.renderer import render as j_render
    from trase_tpu_torch import render as t_cli
    from trase_tpu_torch.models.gaussians_io import (
        load_checkpoint as t_load_checkpoint,
        load_gaussian_ply as t_load_gaussian_ply)
    from trase_tpu_torch.renderer import render as t_render

    src, mdl, _, _ = trained
    it = 40
    ply = os.path.join(mdl, "point_cloud", f"iteration_{it}",
                       "point_cloud.ply")
    dpk = os.path.join(mdl, "deform", f"iteration_{it}", "deform.pkl")
    jp, ja, n, _ = load_gaussian_ply(ply, sh_degree=1)
    tp, ta, tn, _ = t_load_gaussian_ply(ply, sh_degree=1, device="cpu")
    assert n == tn > 0
    net = JD.make_deform_network("DeformNetwork", is_blender=True)
    jv = load_checkpoint(dpk)["vars"]
    tnet = TD.load_flax_params(TD.make_deform_network(is_blender=True,
                                                      device="cpu"),
                               t_load_checkpoint(dpk)["vars"])

    class A:
        sh_degree, source_path, model_path = 1, src, mdl
        images, resolution, white_background, eval = "images", -1, False, True
        is_blender, is_6dof, end_frame = True, False, -1
        load_mask_on_the_fly = load_image_on_the_fly = False

    cam = JScene(A(), load_iteration=it, shuffle=False).get_test_cameras()[0]
    cap = jp.xyz.shape[0]
    t = np.full((cap, 1), np.float32(cam.fid), np.float32)
    jd = JD.deform_step(net, jv, jp.xyz, jnp.asarray(t))
    ref = j_render(cam.to_render_camera(), jp, ja.alive, jnp.zeros(3), *jd,
                   sh_degree=1, with_features=False,
                   raster_cfg=JRasterConfig(pairs_per_gaussian=16),
                   backend="pallas_interpret")["render"]
    rc = t_camera(cam.R, cam.T, cam.fovx, cam.fovy, cam.image_height,
                  cam.image_width, device="cpu")
    with torch.no_grad():
        td = TD.deform_step(tnet, tp.xyz, t32(t))
        got = t_render(rc, tp, ta.alive, torch.zeros(3), *td, sh_degree=1,
                       with_features=False,
                       raster_cfg=TRasterConfig(pairs_per_gaussian=16))
    np.testing.assert_allclose(got["render"].numpy(), np.asarray(ref),
                               atol=2e-4)
    assert float(got["render"].max()) > 0.05
    t_cli.main(["-s", src, "-m", mdl, "--iteration", str(it),
                "--skip_train", "--device", "cpu",
                "--pairs_per_gaussian", "16"])
    out = os.path.join(mdl, "test", f"ours_{it}", "renders")
    assert len([f for f in os.listdir(out) if f.endswith(".png")]) == 2

