"""The port's training CLI across warm_up_3d_features on the CPU: a
synthetic Blender dataset with SAM masks, GAUSSIAN and FEATURE blocks
alternating, FEATURE steps in both arms of with_densify_stats, densifies
inside a FEATURE block and between blocks; the snapshot carries the
KNN-smoothed features and both packages render it."""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from trase_tpu_torch.engine import loop as TL
from trase_tpu_torch.engine import trainer as TT

torch.set_num_threads(2)

ITERATIONS, WARM_UP_FEATURES, INTERVAL, DENSIFY_UNTIL = 40, 12, 7, 30


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Iterations 1-11 GAUSSIAN; the switch at 12 opens a FEATURE block
    of INTERVAL + 1 = 8 steps (12-19), then GAUSSIAN 20-27, FEATURE
    28-35 (with stats at 28-29, values-only from 30 =
    densify_until_iter), GAUSSIAN 36-40. Densifies at 16 (inside the
    first FEATURE block) and 24. Each call of the steps, the densify and
    the smoothing map is recorded."""
    from trase_tpu.data.synthetic import write_synthetic_dataset
    from trase_tpu_torch import train as t_train

    base = tmp_path_factory.mktemp("feature_train")
    src, mdl = str(base / "data"), str(base / "model")
    write_synthetic_dataset(src, n_train=3, n_test=2, image_size=32,
                            n_blobs=2, pts_per_blob=24)
    calls = []
    fstep, gstep, dstep = (TT.feature_phase_step, TT.gaussian_phase_step,
                           TT.densify_step)
    smap = TL.build_feature_smooth_map

    def feature(*a, **kw):
        calls.append(("feature", kw["with_densify_stats"]))
        return fstep(*a, **kw)

    def gaussian(*a, **kw):
        calls.append(("gaussian", None))
        return gstep(*a, **kw)

    def densify(*a, **kw):
        calls.append(("densify", None))
        return dstep(*a, **kw)

    def smooth_map(*a, **kw):
        calls.append(("smooth_map", None))
        return smap(*a, **kw)

    TT.feature_phase_step, TT.gaussian_phase_step = feature, gaussian
    TT.densify_step, TL.build_feature_smooth_map = densify, smooth_map
    try:
        trainer = t_train.main([
            "-s", src, "-m", mdl, "--iterations", str(ITERATIONS),
            "--device", "cpu", "--is_blender", "--eval", "--sh_degree", "1",
            "--quiet", "--warm_up", "10", "--warm_up_3d_features",
            str(WARM_UP_FEATURES), "--iterative_opt_interval", str(INTERVAL),
            "--densify_from_iter", "10", "--densification_interval", "8",
            "--densify_until_iter", str(DENSIFY_UNTIL),
            "--opacity_reset_interval", "1000", "--num_sampled_pixels", "64",
            "--num_sampled_masks", "4", "--pairs_per_gaussian", "16",
            "--save_iterations", "25"])
    finally:
        TT.feature_phase_step, TT.gaussian_phase_step = fstep, gstep
        TT.densify_step, TL.build_feature_smooth_map = dstep, smap
    return src, mdl, trainer, calls


def test_cli_alternates_phases(trained):
    _, _, trainer, calls = trained
    steps = [c for c in calls if c[0] in ("feature", "gaussian")]
    assert len(steps) == ITERATIONS
    kinds = "".join("F" if k == "feature" else "G" for k, _ in steps)
    assert kinds == "G" * 11 + "F" * 8 + "G" * 8 + "F" * 8 + "G" * 5
    arms = [stats for k, stats in steps if k == "feature"]
    assert arms == [True] * 10 + [False] * 6  # iterations 12-29, 30-35
    assert trainer.feature_calls == 16 and trainer.step_calls == 24
    assert int(trainer.skipped) == 0
    assert trainer.opt_state.state == TT.GAUSSIAN
    order = [k for k, _ in calls]
    assert order.count("densify") == 2
    # the densify at 16 lies inside the first FEATURE block, and the next
    # FEATURE step smooths over a map rebuilt after it
    first = order.index("densify")
    assert order[first - 1] == "feature"
    assert order[first + 1:first + 3] == ["smooth_map", "feature"]
    # one smoothing map per FEATURE block, one after the densify inside
    # it, one for each of the two snapshots (after GAUSSIAN steps)
    assert order.count("smooth_map") == 5
    for it in (25, ITERATIONS):
        assert os.path.exists(os.path.join(
            trained[1], "point_cloud", f"iteration_{it}", "point_cloud.ply"))


def test_feature_blocks_train_only_features(trained):
    """FEATURE steps moved the features; the alive rows differ from the
    initial (random) ones, and Adam stepped them 16 times."""
    _, _, trainer, _ = trained
    assert int(trainer.state.opt.gaussian_features.step) == 16
    assert int(trainer.state.opt.xyz.step) == 24


def test_snapshot_smoothed_and_rendered_by_both(trained):
    """The snapshot's features are trase_tpu's smooth_features over
    build_feature_smooth_map(xyz, 16) of the final state (every slot, no
    dropout; 1e-5); trase_tpu's loader and renderer (Pallas, interpret
    mode) and the port's render the snapshot's features alike
    (test_torch_render's TOL["feats"]); the port's render CLI writes its
    feature PNGs."""
    from trase_tpu.models import deform as JD
    from trase_tpu.models.gaussians_io import (load_checkpoint,
                                               load_gaussian_ply)
    from trase_tpu.ops.knn import build_feature_smooth_map, smooth_features
    from trase_tpu.ops.rasterize import RasterConfig as JRasterConfig
    from trase_tpu.renderer import make_render_camera as j_camera
    from trase_tpu.renderer import render as j_render
    from trase_tpu_torch import render as t_cli
    from trase_tpu_torch.models import deform as TD
    from trase_tpu_torch.models.gaussians_io import (
        load_checkpoint as t_load_checkpoint,
        load_gaussian_ply as t_load_gaussian_ply)
    from trase_tpu_torch.ops.rasterize import RasterConfig as TRasterConfig
    from trase_tpu_torch.renderer import make_render_camera as t_camera
    from trase_tpu_torch.renderer import render as t_render

    src, mdl, trainer, _ = trained
    it = ITERATIONS
    ply = os.path.join(mdl, "point_cloud", f"iteration_{it}",
                       "point_cloud.ply")
    state = trainer.state
    alive = state.aux.alive.numpy()
    ref = np.asarray(smooth_features(
        jnp.asarray(state.params.gaussian_features.numpy()),
        build_feature_smooth_map(jnp.asarray(state.params.xyz.numpy()), 16),
        rng=None))[alive]
    jp, ja, n, _ = load_gaussian_ply(ply, sh_degree=1)
    tp, ta, tn, _ = t_load_gaussian_ply(ply, sh_degree=1, device="cpu")
    assert n == tn == int(alive.sum())
    np.testing.assert_allclose(tp.gaussian_features[:n].numpy(), ref,
                               atol=1e-5)
    assert not np.allclose(ref, state.params.gaussian_features.numpy()[
        alive], atol=1e-3)  # smoothing changed them
    dpk = os.path.join(mdl, "deform", f"iteration_{it}", "deform.pkl")
    net = JD.make_deform_network("DeformNetwork", is_blender=True)
    jv = load_checkpoint(dpk)["vars"]
    tnet = TD.load_flax_params(TD.make_deform_network(is_blender=True,
                                                      device="cpu"),
                               t_load_checkpoint(dpk)["vars"])
    R, T = np.eye(3), np.array([0.0, 0.0, 3.0])
    cap = jp.xyz.shape[0]
    t = np.full((cap, 1), 0.5, np.float32)
    jd = JD.deform_step(net, jv, jp.xyz, jnp.asarray(t))
    jout = j_render(j_camera(R, T, 0.8, 0.8, 32, 32), jp, ja.alive,
                    jnp.zeros(3), *jd, sh_degree=1,
                    raster_cfg=JRasterConfig(pairs_per_gaussian=16),
                    backend="pallas_interpret")
    with torch.no_grad():
        td = TD.deform_step(tnet, tp.xyz, torch.from_numpy(t))
        tout = t_render(t_camera(R, T, 0.8, 0.8, 32, 32, device="cpu"), tp,
                        ta.alive, torch.zeros(3), *td, sh_degree=1,
                        raster_cfg=TRasterConfig(pairs_per_gaussian=16))
    feats = tout["render_gaussian_features"].numpy()
    assert np.abs(feats).max() > 0.05
    np.testing.assert_allclose(
        feats, np.asarray(jout["render_gaussian_features"]), atol=5e-4)
    t_cli.main(["-s", src, "-m", mdl, "--iteration", str(it),
                "--skip_train", "--device", "cpu",
                "--pairs_per_gaussian", "16"])
    out = os.path.join(mdl, "test", f"ours_{it}", "rendered_feats")
    assert len([f for f in os.listdir(out) if f.endswith(".png")]) == 2
