"""The style cell's own pieces on the CPU at a tiny size: the objects
regenerated from the scene's draws, the work counts, the result line,
the check failing on each planted fault, the kernels put down to the
step's spans through the ops that launched them, and a program without
the style loop failing before any set-up."""
import contextlib
import copy
import io
import json
import math
import time
import types
import argparse

import pytest
import torch

from port_bench import harness as HB
from port_bench import run as R
from port_bench.counts import style as CS
from port_bench.modes import style as M
from port_bench.scene import generate as SG
from port_bench.scene import style as SS

SEED = 2 ** 31 + 11


def tiny_context(trace=0, seed=SEED, tmp="/tmp"):
    wl = HB.load_json("workloads", "n3v-style-step")
    cfg = copy.deepcopy(HB.load_json("configs", wl["config"]))
    traffic = copy.deepcopy(HB.load_json("traffic", wl["traffic"]))
    cfg.update(image_width=64, image_height=48, capacity=2048, n_alive=1500)
    cfg["capture"] = [128, 96]
    cfg["scene"]["objects"]["count"] = 6
    cfg["style"].update(height=48, width=64, segment_id=2)
    traffic.update(cameras=3, frames=2, traced_iterations=2,
                   warm_up_iterations=2)
    args = argparse.Namespace(workload="n3v-style-step", seed=seed,
                              seconds=0.6, trace=trace)
    return types.SimpleNamespace(args=args, workload=wl, cfg=cfg,
                                 traffic=traffic, t_start=time.perf_counter(),
                                 trace_dir=f"{tmp}/trace",
                                 device=torch.device("cpu"))


def run_cell(tmp_path, trace=0):
    ctx = tiny_context(trace, tmp=str(tmp_path))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = R.finish(ctx, torch)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_object_ids_are_the_scenes_draws():
    """Each live gaussian's object id is the object make_gaussians drew
    it around: the same generator's centres and draws give its xyz."""
    cfg = tiny_context().cfg
    sc, n = cfg["scene"], cfg["n_alive"]
    params, _ = SG.make_gaussians(sc, cfg["capacity"], n, 3, 32, SEED, "cpu")
    ids = SS.object_ids(sc, n, SEED, "cpu")
    g = SG.generator(SEED, SG.S_POSITIONS, "cpu")
    box = torch.tensor(sc["objects"]["center_box"])
    centres = box[:, 0] + (box[:, 1] - box[:, 0]) * torch.rand(
        (sc["objects"]["count"], 3), generator=g)
    obj = ids >= 0
    assert int(obj.sum()) == n - round(n * sc["background"]["share"])
    off = params["xyz"][:n][obj] - centres[ids[obj]]
    assert float(off.std()) == pytest.approx(sc["objects"]["spread"],
                                             rel=0.1)
    assert bool((ids[~obj] == SS.BACKGROUND_ID).all())


def test_work_counts():
    # VGG16 through conv4_1 at 1200 x 1600: 392.7 G multiply-adds
    assert CS.vgg_macs(1200, 1600) == pytest.approx(392.7e9, rel=1e-3)
    assert CS.vgg_step_flops(1200, 1600) == 4 * CS.vgg_macs(1200, 1600)
    assert CS.nnfm_flops({(30000, 30000, 512): 2}) == 2 * 4.0 * 30000 ** 2 \
        * 512


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys_and_check(trace, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    line = run_cell(tmp_path, trace)
    assert list(line) == (["correct", "attempted", "failed", "metrics",
                           "device"] + (["breakdown"] if trace else [])
                          + ["checks"])
    assert line["correct"] is True
    wl = HB.load_json("workloads", "n3v-style-step")
    if trace:
        assert set(line["metrics"]) <= set(wl["per_layer"])
        assert {"device_idle_share.style", "step_mfu.style"} <= \
            set(line["metrics"])
    else:
        assert set(line["metrics"]) == {"train_it_s", "setup_s"}


def unchanged(monkeypatch, T):
    fn = T.style_phase_step

    def step(state, *a, **k):
        return state, fn(state, *a, **k)[1]
    monkeypatch.setattr(T, "style_phase_step", step)


def half_rows(monkeypatch, T):
    fn = T.style_phase_step

    def step(state, camera, ref, mask, *a, **k):
        rows = torch.nonzero(mask).flatten()
        mask = mask.clone()
        mask[rows[1::2]] = False
        return fn(state, camera, ref, mask, *a, **k)
    monkeypatch.setattr(T, "style_phase_step", step)


def doubled(monkeypatch, T):
    fn = T.style_phase_step

    def step(state, *a, **k):
        new, metrics = fn(state, *a, **k)
        f0, f1 = state.params.features_dc, new.params.features_dc
        return new._replace(params=new.params._replace(
            features_dc=f0 + 2.0 * (f1 - f0))), metrics
    monkeypatch.setattr(T, "style_phase_step", step)


@pytest.mark.parametrize("fault", [unchanged, half_rows, doubled])
def test_style_check_fails_on_each_fault(fault, monkeypatch, tmp_path):
    from trase_tpu_torch.engine import trainer as T

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    fault(monkeypatch, T)
    assert run_cell(tmp_path)["correct"] is False


def test_kernels_are_put_down_to_the_spans_that_launched_them():
    """A forward launch inside the vgg span, two backward launches
    inside an op of the same sequence number on autograd's thread (their
    kernels overlapping), one inside the loss span's backward op, and
    one outside both."""
    spans = {"vgg": [(1, 0.0, 10.0)], "nnfm": [(1, 10.0, 20.0)]}
    ops = [(1, 1.0, 2.0, 5), (1, 11.0, 12.0, 6), (2, 30.0, 40.0, 6),
           (2, 40.0, 50.0, 5), (2, 41.0, 42.0, 99)]
    launches = {1: (1, 1.5), 2: (2, 45.0), 3: (2, 31.0), 4: (2, 60.0),
                5: (1, 15.0)}
    kernels = [(1, 100.0, 110.0), (2, 200.0, 220.0), (3, 300.0, 340.0),
               (4, 400.0, 480.0), (5, 500.0, 660.0), (7, 700.0, 1020.0),
               (6, 210.0, 230.0)]
    launches[6] = (2, 46.0)
    got = M.attribute(spans, ops, launches, kernels)
    # the vgg kernels 1, 2 and 6 (2 and 6 side by side: 30 us of device)
    assert got["vgg"] == pytest.approx(40e-6)
    assert got["nnfm"] == pytest.approx(200e-6)


def test_a_program_without_the_style_loop_fails_before_set_up(monkeypatch,
                                                              tmp_path):
    from trase_tpu_torch.engine import loop as L

    monkeypatch.delattr(L.Trainer, "train_style")
    monkeypatch.setattr(SG, "make_gaussians", lambda *a, **k: math.nan)
    with pytest.raises(RuntimeError, match="no style loop"):
        M.run(torch, tiny_context(tmp=str(tmp_path)))
