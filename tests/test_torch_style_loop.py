"""The port's NNFM style loop (engine/loop.py: Trainer.train_style, the
style CLI's loop) against the benchmark's plain reference
(port_bench/reference/style_step.py), on the CPU at a small size: a
1500-gaussian 48 x 64 render, VGG16 at its published widths through
conv4_1, seeded weights, a 160 x 160 style picture. Also: the style CLI
and the benchmark's style mode both run through that entry, and a traced
style step records its spans and the ``nnfm`` counter.

Tolerances, each with its reason:
- the NNFM alone, value 1e-6 relative and gradient 1e-5 of its scale:
  the same float32 products, summed in another order (the reference in
  blocks of render columns);
- the loop's losses 1e-5 relative: float32 sums of the render, the VGG
  and the NNFM in other orders (the reference composites by cumulative
  sums over each tile's pairs, the port by its walk);
- the first step's colour gradients (Adam's first moment over 1 - beta1)
  1e-4 of each leaf's scale: those sums, carried back through VGG16 and
  the compositor;
- each colour leaf's change after three steps, 1e-3 of its norm: Adam's
  first steps are sign-like, so an element whose gradient is rounding
  moves by the learning rate either way in either package.
"""
import copy
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import harness as HB  # noqa: E402
from port_bench.modes import style as M  # noqa: E402
from port_bench.reference import style_step as RS  # noqa: E402
from port_bench.scene import style as SS  # noqa: E402

from trase_tpu_torch.engine import loop as L  # noqa: E402
from trase_tpu_torch.losses import style as TS  # noqa: E402
from trase_tpu_torch.utils import trace  # noqa: E402

torch.set_num_threads(2)

SEED = 2 ** 31 + 77
CPU = torch.device("cpu")
NNFM_LOSS_TOL, NNFM_GRAD_TOL = 1e-6, 1e-5
LOSS_TOL, GRAD_TOL, CHANGE_TOL = 1e-5, 1e-4, 1e-3
STYLE_SIZE, FLAT = 160, 96


def tiny_cell():
    """n3v-style-step's files, the scene, image and run cut to a CPU
    test's size (the VGG's widths as published)."""
    wl = HB.load_json("workloads", "n3v-style-step")
    cfg = copy.deepcopy(HB.load_json("configs", wl["config"]))
    traffic = copy.deepcopy(HB.load_json("traffic", wl["traffic"]))
    cfg.update(image_width=64, image_height=48, capacity=2048, n_alive=1500)
    cfg["capture"] = [128, 96]
    cfg["scene"]["objects"]["count"] = 6
    cfg["style"].update(height=STYLE_SIZE, width=STYLE_SIZE, segment_id=2)
    traffic.update(cameras=3, frames=2, traced_iterations=2,
                   warm_up_iterations=2)
    return cfg, traffic


def picture(tied: bool) -> np.ndarray:
    """A seeded style picture: noise, or with a flat left part wider than
    conv4_1's receptive field, whose conv4_1 columns are equal."""
    img = np.random.default_rng(5).uniform(
        size=(3, STYLE_SIZE, STYLE_SIZE)).astype(np.float32)
    if tied:
        img[:, :, :FLAT] = np.array([0.3, 0.5, 0.7],
                                    np.float32)[:, None, None]
    return img


def close(a, b, tol, name):
    err = float((a - b).abs().max() / (b.abs().max() + 1e-30))
    assert err < tol, (name, err, tol)


# ------------------------------------------------------------- the NNFM


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied"])
def test_nnfm_matches_the_reference(tied):
    """The port's loss_nnfm_style (its gradient by autograd through
    amax) against the reference's NNFM, worked out in blocks of 7 render
    columns. `tied`: render column 0 lies at the same cosine, exactly, to
    two different style columns, so each must take half its gradient:
    their parts across each other cancel."""
    rng = np.random.default_rng(0)
    f1 = rng.normal(size=(16, 40)).astype(np.float32)
    f2 = rng.normal(size=(16, 30)).astype(np.float32)
    if tied:
        f2[0] = -np.abs(f2[0])  # every other column farther from e_0
        f1[:, 0] = 0.0
        f1[0, 0] = 1.0
        f2[:, 3] = 0.0
        f2[:, 7] = 0.0
        f2[0, [3, 7]] = 1.0
        f2[1, 3], f2[1, 7] = 1.0, -1.0
    a = torch.from_numpy(f1).requires_grad_(True)
    loss = TS.loss_nnfm_style(a, torch.from_numpy(f2))
    (g,) = torch.autograd.grad(loss, [a])
    ref_loss, ref_g = RS.nnfm(torch.from_numpy(f1), torch.from_numpy(f2),
                              block=7)
    assert abs(float(loss.detach()) - ref_loss) <= \
        NNFM_LOSS_TOL * abs(ref_loss)
    close(g, ref_g, NNFM_GRAD_TOL, "feat1")
    if tied:
        assert float(ref_g[1, 0].abs()) < 1e-9 < float(ref_g[0].abs().max())
        assert float(g[1, 0].abs()) < 1e-9


# ------------------------------------------------------------- the loop


def program_steps(run, first_iter: int, n: int = 3):
    """n iterations of the loop's style entry: each call's inputs, the
    losses, the first step's gradients as Adam got them and the leaves
    after the last."""
    calls, losses, got = [], [], {}

    def on_iteration(trainer, it, metrics):
        calls[-1]["iteration"] = it
        losses.append(float(metrics["loss"]))
        p, o = trainer.state.params, trainer.state.opt
        if it == first_iter + 1:
            got["first"] = {k: getattr(o, k).mu / 0.1 for k in RS.LEAVES}
        got["now"] = {k: getattr(p, k) for k in RS.LEAVES}

    with M.recording(run, calls):
        M.drive(run, first_iter, n, on_iteration)
    return calls, losses, got["first"], got["now"]


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied"])
def test_style_loop_matches_the_reference(tied, monkeypatch, tmp_path):
    """Three iterations of Trainer.train_style against the reference's
    three steps on the same views: the losses, the first colour
    gradients and the colours' changes; only the styled live rows move.
    `tied`: the style picture's flat part gives the NNFM max equal
    style columns (checked on the reference's features)."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(SS, "style_image", lambda style, seed: picture(tied))
    cfg, traffic = tiny_cell()
    first_iter = traffic["first_iteration"] - 1
    run = M.build(torch, cfg, traffic, SEED, CPU)
    start = {k: run.params[k].clone() for k in RS.LEAVES}
    calls, losses, first, now = program_steps(run, first_iter)
    assert [c["iteration"] for c in calls] == [first_iter + 1, first_iter + 2,
                                               first_iter + 3]
    inputs = M.reference_inputs(torch, cfg, traffic, SEED, calls, CPU)
    style = inputs["style_feats"]
    n_unique = torch.unique(style.T, dim=0).shape[0]
    assert (n_unique < style.shape[1]) == tied
    ref_losses, ref_first, ref_now = RS.run_steps(**inputs)
    for a, b in zip(losses, ref_losses):
        assert abs(a - b) <= LOSS_TOL * abs(b), (losses, ref_losses)
    rows = inputs["row_mask"]
    assert bool(torch.equal(rows, run.style_mask & run.alive))
    for k in RS.LEAVES:
        close(first[k], ref_first[k], GRAD_TOL, k)
        assert float(ref_first[k].abs().max()) > 0, k
        moved, ref_moved = now[k] - start[k], ref_now[k] - start[k]
        gap = abs(float(moved.norm()) - float(ref_moved.norm()))
        assert gap <= CHANGE_TOL * float(ref_moved.norm()), k
        assert torch.equal(now[k][~rows], start[k][~rows]), k


# ---------------------------------------------- the CLI and the benchmark


def model_dir(base: str) -> tuple:
    """A synthetic dataset, and a model directory holding a snapshot of
    its blobs at iteration 30 and a clusters.pt of each gaussian's blob
    (no deform.pkl: the CLI keeps its seeded deform net)."""
    from PIL import Image

    from trase_tpu_torch.cluster import save_clusters
    from trase_tpu_torch.data.synthetic import write_synthetic_dataset
    from trase_tpu_torch.models import gaussians as G
    from trase_tpu_torch.models.gaussians_io import save_gaussian_ply
    from trase_tpu_torch.utils.sh import rgb_to_sh

    src, mdl = os.path.join(base, "data"), os.path.join(base, "model")
    scene = write_synthetic_dataset(src, n_train=3, n_test=1, image_size=32,
                                    n_blobs=3, pts_per_blob=24, device="cpu")
    n = scene["xyz"].shape[0]
    p = G.empty_params(n, 1, device="cpu")
    p = p._replace(
        xyz=torch.as_tensor(scene["xyz"], dtype=torch.float32),
        features_dc=torch.as_tensor(rgb_to_sh(scene["rgb"]),
                                    dtype=torch.float32)[:, None, :],
        scaling=torch.full((n, 3), float(np.log(scene["scale"]))),
        opacity=torch.full((n, 1), 2.0))
    cdir = os.path.join(mdl, "point_cloud", "iteration_30")
    save_gaussian_ply(os.path.join(cdir, "point_cloud.ply"), p,
                      torch.ones(n, dtype=torch.bool))
    save_clusters(os.path.join(cdir, "clusters.pt"),
                  scene["blob_id"].astype(np.int64), np.zeros((n, 3)))
    style = os.path.join(base, "style.png")
    Image.fromarray((picture(True)[:, :64, :64].transpose(1, 2, 0) * 255)
                    .astype(np.uint8)).save(style)
    return src, mdl, style


def replayed(record) -> dict:
    """The entry called again from the state and draws it started from,
    with the same arguments: the colour leaves it ends with."""
    trainer, args, kwargs, before = record
    trainer.state = before["state"]
    trainer.np_rng.bit_generator.state = before["rng"]
    trainer._viewpoint_stack[:] = before["stack"]
    trainer.ema_loss = before["ema"]
    kwargs = dict(kwargs, saving_iterations=(), progress=False,
                  on_iteration=None)
    L.Trainer.train_style.__wrapped__(trainer, *args, **kwargs)
    return {k: getattr(trainer.state.params, k) for k in RS.LEAVES}


@pytest.mark.parametrize("caller", ["cli", "bench"])
def test_cli_and_bench_mode_run_the_loop_entry(caller, monkeypatch,
                                                tmp_path):
    """The style CLI and the benchmark's style mode each reach their
    state through one call of Trainer.train_style: called again from the
    state and draws it started from, the entry ends where the caller
    ended."""
    entry = L.Trainer.train_style
    records = []

    def spy(self, *args, **kwargs):
        records.append((self, args, kwargs, {
            "state": self.state, "rng": self.np_rng.bit_generator.state,
            "stack": list(self._viewpoint_stack), "ema": self.ema_loss}))
        return entry(self, *args, **kwargs)

    spy.__wrapped__ = entry
    monkeypatch.setattr(L.Trainer, "train_style", spy)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    if caller == "cli":
        from trase_tpu_torch import train_style_transfer_nnfm as cli

        src, mdl, style = model_dir(str(tmp_path))
        trainer = cli.main(["-s", src, "-m", mdl, "--load_iteration", "30",
                            "--iterations", "33", "--sh_degree", "1",
                            "--is_blender", "--eval", "--quiet",
                            "--segment_ids", "1", "--reference_img_path",
                            style, "--device", "cpu"])
        assert os.path.exists(os.path.join(mdl, "point_cloud",
                                           "iteration_33", "point_cloud.ply"))
        assert records[0][1][3:5] == (30, 33)
    else:
        cfg, traffic = tiny_cell()
        run = M.build(torch, cfg, traffic, SEED, CPU)
        M.checked_steps(torch, run, traffic["first_iteration"] - 1)
        trainer = run.trainer
    assert len(records) == 1 and records[0][0] is trainer
    ended = {k: getattr(trainer.state.params, k) for k in RS.LEAVES}
    for k, v in replayed(records[0]).items():
        assert torch.equal(v, ended[k]), k
        assert not torch.equal(v, getattr(records[0][3]["state"].params, k))


# ------------------------------------------------------------- tracing


def test_traced_style_step_records_spans_and_the_nnfm_counter(monkeypatch,
                                                               tmp_path):
    """Iterations 9 and 10 of the style loop with spans on: each is a
    trase.iteration holding the step's trase.step and its six parts, the
    10th also the loss EMA's read; the nnfm counter counts both calls by
    (render columns, style columns, channels)."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cfg, traffic = tiny_cell()
    run = M.build(torch, cfg, traffic, SEED, CPU)
    counts = trace.counter("nnfm")
    before = dict(counts)
    trace.take()
    trace.enable(True)
    try:
        M.drive(run, 8, 2)
    finally:
        trace.enable(False)
        spans = trace.take()
    names = [s.name for s in spans]
    parts = ["trase.step." + p for p in ("deform", "render", "vgg", "loss",
                                         "backward", "adam")]
    for name in ["trase.iteration", "trase.step"] + parts:
        assert names.count(name) == 2, (name, names)
    assert names.count("trase.loop.read_metrics") == 1
    by_name = {s.name: s for s in spans}
    assert by_name["trase.step"].parent == "trase.iteration"
    assert all(by_name[p].parent == "trase.step" for p in parts)
    assert {s.iteration for s in spans} == {9, 10}
    key = (6 * 8, (STYLE_SIZE // 8) ** 2, 512)
    assert counts[key] - before.get(key, 0) == 2
    assert set(counts) - set(before) <= {key}
