"""A run's result line, its refusal without a card, the check on sound
runs, and the check failing on the control and on each planted fault:
every run here skips the look for a card and drives the rest of a run on
the CPU at a tiny size."""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from port_bench import harness as HB
from port_bench import run as R
from port_bench.modes import train as M
from tiny import tiny_context

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_cell(workload, tmp_path, trace=0, seed=3):
    ctx = tiny_context(workload, seed=seed, seconds=0.6, trace=trace,
                       tmp=str(tmp_path))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = R.finish(ctx, torch)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue().strip().splitlines()


@pytest.mark.parametrize("workload", ["hypernerf-train-gaussian",
                                      "n3v-train-feature"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys_and_check(workload, trace, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    line, err = run_cell(workload, tmp_path, trace)
    keys = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == keys
    assert line["correct"] is True
    wl = HB.load_json("workloads", workload)
    names = ([m["name"] for m in wl["end_to_end"]] if not trace
             else wl["per_layer"])
    assert set(line["metrics"]) <= set(names)
    if not trace:
        assert set(line["metrics"]) == set(names)
    for k, v in line["checks"].items():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    # the compared numbers are the last lines of standard error
    assert all(x.startswith("check ") for x in err[-len(line["checks"]):])


def test_no_card_means_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = R.main(["--workload", "hypernerf-train-gaussian", "--seed", "1",
                 "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out.strip() == ""


# ---------------------------------------------------------------- faults


def unchanged_state(monkeypatch, T):
    fn = T.gaussian_phase_step

    def step(state, *a, **k):
        _, metrics = fn(state, *a, **k)
        return state, metrics
    monkeypatch.setattr(T, "gaussian_phase_step", step)


def half_batch(monkeypatch, T):
    l1, ssim = T.l1_loss, T.ssim
    monkeypatch.setattr(T, "l1_loss", lambda a, b: l1(
        a[:, :a.shape[1] // 2], b[:, :b.shape[1] // 2]))
    monkeypatch.setattr(T, "ssim", lambda a, b: ssim(
        a[:, :a.shape[1] // 2], b[:, :b.shape[1] // 2]))


def altered_update(monkeypatch, T):
    fn = T.gaussian_phase_step

    def step(state, *a, **k):
        new, metrics = fn(state, *a, **k)
        p = new.params
        op = state.params.opacity + 2.0 * (p.opacity - state.params.opacity)
        return new._replace(params=p._replace(opacity=op)), metrics
    monkeypatch.setattr(T, "gaussian_phase_step", step)


def other_gt(monkeypatch, T):
    """The GT cache hands a step another view's image."""
    from trase_tpu_torch.engine import loop as L

    fn = L.Trainer._gt_image

    def gt_image(self, cam):
        got = fn(self, cam)
        others = [v for v in self._gt_cache.values() if v is not got]
        return others[0] if others else got
    monkeypatch.setattr(L.Trainer, "_gt_image", gt_image)


@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   altered_update, other_gt])
def test_train_check_fails_on_each_fault(fault, monkeypatch, tmp_path):
    from trase_tpu_torch.engine import trainer as T

    fault(monkeypatch, T)
    line, _ = run_cell("hypernerf-train-gaussian", tmp_path)
    assert line["correct"] is False


def feature_unchanged(monkeypatch, T):
    fn = T.feature_phase_step

    def step(state, *a, **k):
        return state, fn(state, *a, **k)[1]
    monkeypatch.setattr(T, "feature_phase_step", step)


def feature_half_batch(monkeypatch, T):
    fn = T.sample_pixels_and_masks

    def sample(*a, **k):
        s = fn(*a, **k)
        half = torch.arange(s.pixel_valid.numel()) < s.pixel_valid.numel() // 2
        return s._replace(pixel_valid=s.pixel_valid & half.to(
            s.pixel_valid.device))
    monkeypatch.setattr(T, "sample_pixels_and_masks", sample)


def feature_altered(monkeypatch, T):
    fn = T.feature_phase_step

    def step(state, *a, **k):
        new, metrics = fn(state, *a, **k)
        f0, f1 = state.params.gaussian_features, new.params.gaussian_features
        return new._replace(params=new.params._replace(
            gaussian_features=f0 + 2.0 * (f1 - f0))), metrics
    monkeypatch.setattr(T, "feature_phase_step", step)


def other_masks(monkeypatch, T):
    """The mask cache hands a step another view's masks."""
    from trase_tpu_torch.engine import loop as L

    fn = L.Trainer._masks_for

    def masks_for(self, cam):
        got = fn(self, cam)
        others = [v for v in self._mask_cache.values() if v is not got]
        return others[0] if others else got
    monkeypatch.setattr(L.Trainer, "_masks_for", masks_for)


@pytest.mark.parametrize("fault", [feature_unchanged, feature_half_batch,
                                   feature_altered, other_masks])
def test_feature_check_fails_on_each_fault(fault, monkeypatch, tmp_path):
    from trase_tpu_torch.engine import loop as L
    from trase_tpu_torch.engine import trainer as T

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    # fewer stacks cached than views, as in the cell: hits and misses
    monkeypatch.setattr(L, "MASK_CACHE_SIZE", 4)
    monkeypatch.setattr(L, "MASK_CACHE_CAP", 4)
    fault(monkeypatch, T)
    line, _ = run_cell("n3v-train-feature", tmp_path)
    assert line["correct"] is False


@pytest.mark.parametrize("workload", ["hypernerf-train-gaussian",
                                      "n3v-train-feature",
                                      "n3v-train-densify"])
def test_train_control_fails(workload, tmp_path, monkeypatch):
    """The reference in bfloat16, in the program's place, against the
    reference in float32."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    ctx = tiny_context(workload)
    dev = torch.device("cpu")
    run = M.build(torch, ctx.cfg, ctx.traffic, 5, dev)
    prog = M.checked_steps(torch, run, ctx.traffic["first_iteration"])
    cfg = dict(ctx.cfg, _traffic=ctx.traffic)
    ref = M.reference_run(torch, cfg, 5, prog["calls"], dev, torch.float32)
    low = M.reference_run(torch, cfg, 5, prog["calls"], dev, torch.bfloat16)
    ok, _ = HB.judge(M.compare(low, ref)["readings"], ctx.workload["limits"])
    assert not ok
    ok, _ = HB.judge(M.compare(prog, ref)["readings"], ctx.workload["limits"])
    assert ok


@pytest.mark.parametrize("workload", ["hypernerf-train-gaussian",
                                      "n3v-train-feature"])
def test_checked_steps_read_the_filled_caches(workload, tmp_path,
                                               monkeypatch):
    """Set-up loads every view through the loop's fetch path before the
    checked steps: the cache keeps the last views it has room for, and a
    checked step finds its view there exactly when it was kept."""
    from trase_tpu_torch.engine import loop as L

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(L, "MASK_CACHE_SIZE", 4)
    monkeypatch.setattr(L, "MASK_CACHE_CAP", 4)
    monkeypatch.setattr(L, "GT_CACHE_SIZE", 4)
    ctx = tiny_context(workload)
    run = M.build(torch, ctx.cfg, ctx.traffic, 5, torch.device("cpu"))
    prog = M.checked_steps(torch, run, ctx.traffic["first_iteration"])
    kept = set(range(len(run.views) - 4, len(run.views)))
    first = prog["calls"][0]["view"]
    assert len(prog["cache_hits"]) == M.CHECKED_STEPS
    assert prog["cache_hits"][0] == (first in kept)


def test_run_on_the_card(cuda_device, tmp_path):
    ctx = tiny_context("hypernerf-train-gaussian", tmp=str(tmp_path))
    ctx.cfg = HB.load_json("configs", ctx.workload["config"])
    ctx.device = cuda_device
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert R.finish(ctx, torch) == 0
    assert json.loads(out.getvalue().strip().splitlines()[-1])["correct"]


test_run_on_the_card = pytest.mark.cuda(test_run_on_the_card)
