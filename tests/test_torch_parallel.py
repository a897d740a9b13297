"""The port's multi-device steps (trase_tpu_torch/parallel) in worlds of 2
and 4 gloo ranks on the CPU, against the port's single-device functions
and against trase_tpu's sharded functions on a mesh of the same size
(backend "pallas", interpreted). One world per size runs every sharded
function from the same state (tests/torch_worlds.py: sharded_steps); the
references are computed here, in the parent, and the ranks get numpy.

The port's gradients are the true single-device ones. trase_tpu's
sharded steps scale them by the mesh size (its slab all-gather
transposes into a psum_scatter: ROADMAP.md, Queue 3, "the sharded steps'
gradients are n_shards times the true ones"); Adam does not see the
factor, so params and moments agree, while the densify statistics are
held against trase_tpu's divided by the mesh size."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trase_tpu.engine import optim as JO
from trase_tpu.engine import trainer as JT
from trase_tpu.losses import contrastive as JC
from trase_tpu.models import deform as JD
from trase_tpu.models import gaussians as JG
from trase_tpu.ops.rasterize import RasterConfig as JRasterConfig
from trase_tpu.parallel import sharded as JS
from trase_tpu.renderer import make_render_camera as j_camera

from trase_tpu_torch.engine import trainer as TT
from trase_tpu_torch.losses.contrastive import PixelSample
from trase_tpu_torch.models import gaussians as TG
from trase_tpu_torch.ops.knn import build_feature_smooth_map
from trase_tpu_torch.parallel import sharded as TS
from trase_tpu_torch.parallel.world import World
from trase_tpu_torch.renderer import render

import torch_worlds as TW
from test_torch_train import jax_field, np_tree

torch.set_num_threads(2)

H = W = 48  # 3 tile rows: padded to 4 in both worlds
HM = WM = 24  # the masks' resolution: the sampled four-tap path
CAM = (np.eye(3), np.zeros(3), 0.8, 0.8, H, W)
RASTER = dict(pairs_per_gaussian=4)
FID, LR, EXTENT = 0.5, 1e-3, 8.0
SMOOTH_K, N_SEL = 4, 2
MAX_NEW = 16
GAUSS_KW = dict(sh_degree=1, use_deform=True, is_6dof=False,
                lambda_dssim=0.2, lambda_reg_deform=0.01)
FEAT_KW = dict(sh_degree=1, use_deform=True, is_6dof=False,
               contrastive_mode="soft", rfn=1.0, positive_th=0.75,
               negative_th=0.5, num_sampled_pixels=64, num_sampled_masks=4)
DENSIFY = dict(grad_threshold=2e-6, percent_dense=0.01, min_opacity=0.005)
# against the port's single-device step: the gathered image is the
# single render's, so losses agree to rounding; params and moments
# within 1e-5 of each field's scale, densify stats 1e-5 relative
STEP_TOL, AUX_RTOL = 1e-5, 1e-5
# the deform net's gradient: its hidden stack runs in bf16, so each rank's
# share of a weight gradient is a bf16 product rounded on its own before
# the sum (2^-8 relative); its first Adam step moves each weight by +-lr
# by the gradient's sign, which rounding flips where the gradient is ~0
DEFORM_MU_TOL = 1e-2
# against trase_tpu's sharded step: its compositor sums 128-pair windows
# by matmul, the port pair by pair
J_LOSS_RTOL, J_PARAM_TOL = 2e-4, 2e-5


def jax_state_from_tree(tree):
    """trase_tpu's TrainState from train_state_to_numpy's layout."""
    def adam(s):
        return JO.AdamState(*[jnp.asarray(s[k]) for k in ("mu", "nu",
                                                         "step")])

    dopt = {"params": {layer: {w: adam(s) for w, s in ws.items()}
                       for layer, ws in tree["deform_opt"]["params"].items()}}
    return JT.TrainState(
        params=JG.GaussianParams(**{k: jnp.asarray(v)
                                    for k, v in tree["params"].items()}),
        aux=JG.GaussianAux(**{k: jnp.asarray(v)
                              for k, v in tree["aux"].items()}),
        opt=JG.GaussianOptState(**{k: adam(v)
                                   for k, v in tree["opt"].items()}),
        deform_vars=jax.tree_util.tree_map(jnp.asarray,
                                           tree["deform_vars"]),
        deform_opt=dopt)


def base_state():
    p, a = jax_field(n=96, cap=256, seed=3, sh_degree=1)
    dvars = JD.init_deform(jax.random.PRNGKey(0),
                           JD.make_deform_network("DeformNetwork"))
    return JT.init_train_state(p, a, dvars)


def inputs(world):
    """The global state (rows interleaved for `world`, as the mesh trainer
    keeps them) and every step's inputs, as numpy."""
    jstate = JS.interleave_rows(base_state(), world)
    rng = np.random.default_rng(world)
    masks = (rng.random((4, HM, WM)) > 0.6).astype(np.float32)
    valid = np.ones(4, bool)
    key_sample, key_smooth = jax.random.split(jax.random.PRNGKey(7))
    sample = JC.sample_pixels_and_masks(key_sample, jnp.asarray(masks),
                                        jnp.asarray(valid), 64, 4)
    perm = np.asarray(jax.random.permutation(key_smooth, SMOOTH_K)[:N_SEL])
    tstate = TT.train_state_from_numpy(np_tree(jstate), "cpu")
    smap = build_feature_smooth_map(tstate.params.xyz, SMOOTH_K)
    cap = tstate.params.xyz.shape[0]
    shape = TG.split_sample_shape(cap // world, MAX_NEW,
                                  TG.DensifyConfig(**DENSIFY))
    return dict(
        state=TT.train_state_to_numpy(tstate), camera=CAM, raster=RASTER,
        bg=np.array([0.2, 0.1, 0.4], np.float32), sh_degree=1,
        gt=rng.uniform(size=(3, H, W)).astype(np.float32), fid=FID, lr=LR,
        gauss_kw=GAUSS_KW, feat_kw=FEAT_KW, masks=masks, mask_valid=valid,
        sample=[np.asarray(x) for x in sample], smooth_perm=perm,
        smooth_map=smap.numpy(), densify_cfg=DENSIFY,
        max_new_per_shard=MAX_NEW, extent=EXTENT,
        split_samples=rng.normal(size=(world,) + shape).astype(np.float32))


def single(inp):
    """The port's single-device functions on the same global state."""
    state = TW.state_from(inp["state"])
    cam, cfg = TW.camera(inp["camera"]), TW.raster_cfg(inp["raster"])
    bg, lrs, net = torch.tensor(inp["bg"]), TW.lrs(LR), TW.net()
    out = {"render": render(cam, state.params, state.aux.alive, bg,
                            sh_degree=1, with_features=False,
                            raster_cfg=cfg)["render"].detach().numpy()}
    new, m = TT.gaussian_phase_step(
        state, cam, torch.tensor(inp["gt"]), FID, 0.0, lrs, bg,
        deform_net=net, raster_cfg=cfg, **GAUSS_KW)
    out["gauss"] = (TT.train_state_to_numpy(new),
                    {k: v.numpy() for k, v in m.items()})
    sample = PixelSample(*[torch.tensor(x) for x in inp["sample"]])
    for name, smooth, stats in (("smooth", True, True),
                                ("plain", False, True),
                                ("values_only", False, False)):
        new, m = TT.feature_phase_step(
            state, cam, torch.tensor(inp["masks"]),
            torch.tensor(inp["mask_valid"]), FID, lrs, bg,
            torch.tensor(inp["smooth_map"]) if smooth else None,
            deform_net=net, raster_cfg=cfg, with_densify_stats=stats,
            sample=sample, smooth_perm=torch.tensor(inp["smooth_perm"]),
            **FEAT_KW)
        out[name] = (TT.train_state_to_numpy(new),
                     {k: v.numpy() for k, v in m.items()})
    return out


def densify_blocks(inp, tree):
    """densify_and_prune on each rank's block of the global state `tree`
    with that rank's split samples, the blocks concatenated and the
    counts summed."""
    state = TW.state_from(tree)
    n = len(inp["split_samples"])
    blocks, stats = [], {}
    for r in range(n):
        block = TS.shard_train_state(state, World(r, n, torch.device("cpu"),
                                                  "gloo"))
        new, s = TT.densify_step(
            block, EXTENT, 0.0, cfg=TG.DensifyConfig(**DENSIFY),
            max_new=MAX_NEW, samples=torch.tensor(inp["split_samples"][r]))
        blocks.append(TT.train_state_to_numpy(new))
        for k, v in s.items():
            stats[k] = stats.get(k, 0) + int(v)
    merged = dict(blocks[0])
    for group in ("params", "aux", "opt"):
        merged[group] = jax.tree_util.tree_map(
            lambda *x: np.concatenate(x) if np.ndim(x[0]) else x[0],
            *[b[group] for b in blocks])
    return merged, stats


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"world{n}")
def worlds(request, tmp_path_factory):
    n = request.param
    inp = inputs(n)
    got, *others = TW.run_world(TW.sharded_steps, n,
                                tmp_path_factory.mktemp("w"), inp)
    got["others"] = others
    return n, inp, got, single(inp)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-12)


def assert_states_close(ref, got, tol, aux_rtol=AUX_RTOL, fields=None):
    for group in ("params", "opt"):
        for k, v in ref[group].items():
            if fields and k not in fields:
                continue
            leaves = v.items() if group == "opt" else [("", v)]
            for sub, a in leaves:
                assert rel(a, got[group][k][sub] if sub else got[group][k]) \
                    <= tol, (group, k, sub)
    for k, a in ref["aux"].items():
        if a.dtype == bool:
            np.testing.assert_array_equal(a, got["aux"][k], err_msg=k)
        else:
            np.testing.assert_allclose(got["aux"][k], a, rtol=aux_rtol,
                                       atol=1e-12, err_msg=k)


def test_render_matches_single(worlds):
    _, _, got, ref = worlds
    np.testing.assert_allclose(got["render"], ref["render"], atol=1e-6,
                               rtol=0)
    assert float(np.abs(got["render"]).max()) > 0.05


def test_gaussian_step_matches_single(worlds):
    _, _, got, ref = worlds
    (gs, gm), (rs, rm) = got["gauss"], ref["gauss"]
    assert bool(gm["finite"]) and bool(rm["finite"])
    np.testing.assert_allclose(gm["loss"], rm["loss"], rtol=1e-6)
    assert_states_close(rs, gs, STEP_TOL)
    # the replicated deform net's gradient (its first moment), and its
    # update where that is not ~0
    for layer, ws in rs["deform_opt"]["params"].items():
        for w, a in ws.items():
            b = gs["deform_opt"]["params"][layer][w]
            assert rel(a["mu"], b["mu"]) <= DEFORM_MU_TOL, (layer, w)
            big = np.abs(a["mu"]) > 1e-3 * np.abs(a["mu"]).max()
            np.testing.assert_allclose(
                gs["deform_vars"]["params"][layer][w][big],
                rs["deform_vars"]["params"][layer][w][big], atol=1e-6)
    assert rs["aux"]["xyz_gradient_accum"].max() > 0


@pytest.mark.parametrize("variant", ["smooth", "plain", "values_only"])
def test_feature_step_matches_single(worlds, variant):
    _, _, got, ref = worlds
    (gs, gm), (rs, rm) = got[variant], ref[variant]
    assert bool(gm["finite"])
    np.testing.assert_allclose(gm["loss"], rm["loss"], rtol=1e-6)
    assert_states_close(rs, gs, STEP_TOL)
    moved = rel(rs["params"]["gaussian_features"],
                np.asarray(worlds[1]["state"]["params"]["gaussian_features"]))
    assert moved > 0


def test_densify_and_reset_match_blocks(worlds):
    """From the sharded GAUSSIAN step's state: the sharded densify equals
    densify_and_prune on each block with the same samples; the opacity
    reset equals the single-device one on the same state."""
    _, inp, got, _ = worlds
    (gs, gstats) = got["densify"]
    rs, rstats = densify_blocks(inp, got["gauss"][0])
    assert gstats == rstats
    assert rstats["n_clone"] + rstats["n_split"] > 0
    jax.tree_util.tree_map(np.testing.assert_array_equal, rs, gs)
    reset = TT.reset_opacity_step(TW.state_from(got["gauss"][0]))
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           TT.train_state_to_numpy(reset), got["reset"])


def test_state_moves_through_rank0_host(worlds):
    """unshard_train_state gathers the global state onto rank 0 alone;
    capacity growth grows it there, and scatter_train_state sends each
    rank its block: the blocks gathered again are the grown state."""
    n, inp, got, _ = worlds
    want, back, rows = got["grown"]
    capacity = np.asarray(inp["state"]["params"]["xyz"]).shape[0]
    assert want["params"]["xyz"].shape[0] == 2 * capacity
    jax.tree_util.tree_map(np.testing.assert_array_equal, want, back)
    assert got["others"] == [{"global_state": None,
                              "block_rows": rows}] * (n - 1)
    assert rows == 2 * capacity // n


# ------------------------------------------------ against trase_tpu


@pytest.fixture(scope="module")
def jax_steps(worlds):
    """trase_tpu's sharded GAUSSIAN step, FEATURE step (no smoothing: its
    sharded smoothing skips the second normalization, ROADMAP.md Queue 3)
    and densify on a mesh of the world's size."""
    n, inp, got, _ = worlds
    mesh = JS.make_mesh(n)
    cfg = JRasterConfig(**RASTER)
    net = JD.make_deform_network("DeformNetwork")
    cam = j_camera(*CAM)
    state = JS.shard_train_state(mesh, jax_state_from_tree(inp["state"]))
    lrs = JT.LearningRates(*[jnp.float32(LR)] * 8)
    bg = jnp.asarray(inp["bg"])
    kw = {k: v for k, v in GAUSS_KW.items() if k != "sh_degree"}
    step = JS.make_sharded_gaussian_step(
        mesh, net, H, W, 1, raster_cfg=cfg, backend="pallas", **kw)(state)
    gstate, gm = step(state, cam.buffers, jnp.asarray(inp["gt"]),
                      jnp.float32(FID), jnp.float32(0.0), lrs, bg)
    out = {"gauss": (np_tree(gstate), np_tree(gm))}
    kw = {k: v for k, v in FEAT_KW.items() if k != "sh_degree"}
    fstep = JS.make_sharded_feature_step(
        mesh, net, H, W, 1, mask_hw=(HM, WM), raster_cfg=cfg,
        backend="pallas", use_smoothing=False, **kw)(state)
    fstate, fm = fstep(state, cam.buffers, jnp.asarray(inp["masks"]),
                       jnp.asarray(inp["mask_valid"]), jnp.float32(FID),
                       jax.random.PRNGKey(7), lrs, bg,
                       jnp.zeros((state.params.xyz.shape[0], 1), jnp.int32))
    out["plain"] = (np_tree(fstate), np_tree(fm))
    # densify from the port's post-step state: the same choices
    after = JS.shard_train_state(mesh, jax_state_from_tree(
        got["gauss"][0]))
    dstep = JS.make_sharded_densify(
        mesh, cfg=JG.DensifyConfig(**DENSIFY),
        max_new_per_shard=MAX_NEW)(after)
    dstate, dstats = dstep(after, jax.random.PRNGKey(1),
                           jnp.float32(EXTENT), jnp.float32(0.0))
    out["densify"] = (np_tree(dstate), np_tree(dstats))
    return out


def _params_close(ref_tree, got_tree, fields):
    for k in fields:
        assert rel(ref_tree["params"][k], got_tree["params"][k]) \
            <= J_PARAM_TOL, k


def test_gaussian_step_matches_trase_tpu(worlds, jax_steps):
    n, _, got, _ = worlds
    (js, jm), (gs, gm) = jax_steps["gauss"], got["gauss"]
    np.testing.assert_allclose(gm["loss"], jm["loss"], rtol=J_LOSS_RTOL)
    _params_close({"params": js.params._asdict()}, gs, TT.TRAINED)
    # the screen-space gradient statistics: trase_tpu's are n times the
    # true ones (ROADMAP.md, Queue 3)
    vis = np.asarray(js.aux.denom) > 0
    assert vis.sum() > 10
    np.testing.assert_array_equal(np.asarray(js.aux.denom),
                                  gs["aux"]["denom"])
    np.testing.assert_allclose(np.asarray(js.aux.max_radii2d),
                               gs["aux"]["max_radii2d"])
    np.testing.assert_allclose(
        np.asarray(js.aux.xyz_gradient_accum)[vis] / n,
        gs["aux"]["xyz_gradient_accum"][vis], rtol=J_LOSS_RTOL)


def test_feature_step_matches_trase_tpu(worlds, jax_steps):
    n, _, got, _ = worlds
    (js, jm), (gs, gm) = jax_steps["plain"], got["plain"]
    np.testing.assert_allclose(gm["loss"], jm["loss"], rtol=J_LOSS_RTOL)
    _params_close({"params": js.params._asdict()}, gs,
                  ("gaussian_features",))
    vis = np.asarray(js.aux.denom) > 0
    np.testing.assert_allclose(
        np.asarray(js.aux.xyz_gradient_accum)[vis] / n,
        gs["aux"]["xyz_gradient_accum"][vis], rtol=J_LOSS_RTOL)


def test_densify_choices_match_trase_tpu(worlds, jax_steps):
    """The same clones, splits and prunes from the same state; the split
    children's positions come from each package's own draws and are left
    out."""
    _, _, got, _ = worlds
    (js, jstats), (gs, gstats) = jax_steps["densify"], got["densify"]
    for k in ("n_clone", "n_split", "n_pruned", "n_alive", "dropped"):
        assert int(jstats[k]) == gstats[k], k
    np.testing.assert_array_equal(np.asarray(js.aux.alive),
                                  gs["aux"]["alive"])
    # the split children's scales go through exp and log, which the two
    # libraries round differently by an ulp
    jp = js.params._asdict()
    for k in TG.GaussianParams._fields:
        if k != "xyz":
            np.testing.assert_allclose(gs["params"][k], np.asarray(jp[k]),
                                       rtol=1e-6, err_msg=k)
    before = got["gauss"][0]["params"]["scaling"]
    same_rows = (gs["params"]["scaling"] == before).all(axis=1)
    np.testing.assert_array_equal(np.asarray(jp["xyz"])[same_rows],
                                  gs["params"]["xyz"][same_rows])


def test_trase_tpu_sharded_smoothing_fault(tmp_path):
    """The fault this port does not copy (ROADMAP.md, Queue 3): trase_tpu's
    sharded FEATURE step averages the normalized neighbours and composites
    the average as it is (sharded.py:674-691), where its single-device
    step normalizes the average again (renderer.py:205-216). From the
    same state, sample and slots: the port's single-device step (which
    the port's sharded step equals, test_feature_step_matches_single)
    agrees with trase_tpu's single-device step, and trase_tpu's sharded
    step does not."""
    inp = inputs(2)
    state = jax_state_from_tree(inp["state"])
    cfg = JRasterConfig(**RASTER)
    net = JD.make_deform_network("DeformNetwork")
    cam = j_camera(*CAM)
    lrs = JT.LearningRates(*[jnp.float32(LR)] * 8)
    args = (jnp.asarray(inp["masks"]), jnp.asarray(inp["mask_valid"]),
            jnp.float32(FID), jax.random.PRNGKey(7), lrs,
            jnp.asarray(inp["bg"]), jnp.asarray(inp["smooth_map"],
                                                 jnp.int32))
    kw = {k: v for k, v in FEAT_KW.items() if k != "sh_degree"}
    _, single = JT.feature_phase_step(
        state, cam.buffers, *args, deform_net=net, image_height=H,
        image_width=W, sh_degree=1, use_smoothing=True, smooth_dropout=0.5,
        mask_hw=(HM, WM), raster_cfg=cfg, **kw)
    mesh = JS.make_mesh(2)
    sharded = JS.shard_train_state(mesh, state)
    step = JS.make_sharded_feature_step(
        mesh, net, H, W, 1, mask_hw=(HM, WM), raster_cfg=cfg,
        backend="pallas", use_smoothing=True, smooth_dropout=0.5,
        **kw)(sharded)
    _, mesh_m = step(sharded, cam.buffers, *args)
    port = single_feature_loss(inp)
    loss_single, loss_mesh = float(single["loss"]), float(mesh_m["loss"])
    assert abs(port - loss_single) <= 5e-4 * abs(loss_single), (
        port, loss_single)
    assert abs(loss_mesh - loss_single) > 0.05 * abs(loss_single), (
        loss_mesh, loss_single, float(mesh_m["rfn"]), float(single["rfn"]))


def single_feature_loss(inp) -> float:
    """The port's single-device FEATURE step with smoothing: its loss."""
    state = TW.state_from(inp["state"])
    _, m = TT.feature_phase_step(
        state, TW.camera(inp["camera"]), torch.tensor(inp["masks"]),
        torch.tensor(inp["mask_valid"]), FID, TW.lrs(LR),
        torch.tensor(inp["bg"]), torch.tensor(inp["smooth_map"]),
        deform_net=TW.net(), raster_cfg=TW.raster_cfg(inp["raster"]),
        sample=PixelSample(*[torch.tensor(x) for x in inp["sample"]]),
        smooth_perm=torch.tensor(inp["smooth_perm"]), **FEAT_KW)
    return float(m["loss"])
