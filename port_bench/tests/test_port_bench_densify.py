"""The port's densification round (engine/trainer.py: densify_step) held
against the plain reference (port_bench/reference/densify.py) on the CPU,
on seeded small states with the same split samples: more candidates than
the round's budget, a table near capacity, oversized and transparent rows
pruned, and a round after the table has grown. A fault planted in the
reference, in the program's place, fails the comparison."""
import math
import re

import pytest
import torch

from port_bench.reference import densify as RD
from test_port_bench_result import altered_update, half_batch, unchanged_state

EXTENT = 4.4
THRESHOLD = 2e-4


def seeded_state(capacity: int, n_alive: int, seed: int, candidates: float):
    """A port TrainState's gaussian part: `n_alive` live rows first, the
    rest parked; about `candidates` of the live rows over the gradient
    threshold, their sizes on both sides of percent_dense x extent; some
    transparent rows, some large on screen and in the world."""
    from trase_tpu_torch.models import gaussians as G

    g = torch.Generator().manual_seed(seed)
    p = G.empty_params(capacity, 3, "cpu")
    n = n_alive
    rn = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    ru = lambda *s: torch.rand(s, generator=g)  # noqa: E731
    live = {
        "xyz": rn(n, 3) * 1.5,
        "features_dc": rn(n, 1, 3),
        "features_rest": rn(n, 15, 3) * 0.1,
        "scaling": math.log(0.004 * EXTENT) + rn(n, 3) * 1.2,
        "rotation": rn(n, 4),
        "opacity": rn(n, 1) * 3.0,
        "gaussian_features": rn(n, 32),
        "cluster_id": torch.randint(0, 9, (n, 1), generator=g).float(),
    }
    p = p._replace(**{k: torch.cat([v, getattr(p, k)[n:]])
                      for k, v in live.items()})
    alive = torch.arange(capacity) < n
    denom = torch.where(alive, torch.randint(0, 4, (capacity,), generator=g)
                        .float(), torch.zeros(capacity))
    per_view = torch.where(ru(capacity) < candidates,
                           THRESHOLD * (1.0 + ru(capacity)),
                           THRESHOLD * 0.9 * ru(capacity))
    aux = G.GaussianAux(alive=alive,
                        max_radii2d=torch.where(alive, ru(capacity) * 30.0,
                                                torch.zeros(capacity)),
                        xyz_gradient_accum=per_view * denom, denom=denom)
    opt = G.GaussianOptState(**{
        k: s._replace(mu=torch.randn(s.mu.shape, generator=g) * 1e-3,
                      nu=torch.rand(s.nu.shape, generator=g) * 1e-6)
        for k, s in G.init_opt_state(p)._asdict().items()})
    return p, aux, opt


def as_dicts(params, aux, opt) -> dict:
    return {"params": params._asdict(), "aux": aux._asdict(),
            "moments": {k: (s.mu, s.nu) for k, s in opt._asdict().items()}}


def both_rounds(params, aux, opt, max_new, max_screen_size, seed,
                fault=None):
    """The port's round and the reference's, on the same state and
    samples -> (program, reference, before) as densify.compare takes
    them, and the port's stats."""
    from trase_tpu_torch.engine import trainer as T
    from trase_tpu_torch.models import gaussians as G

    cfg = G.DensifyConfig(grad_threshold=THRESHOLD, percent_dense=0.01,
                          min_opacity=0.005)
    shape = G.split_sample_shape(params.xyz.shape[0], max_new, cfg)
    samples = torch.randn(shape, generator=torch.Generator().manual_seed(
        seed + 1))
    state = T.TrainState(params=params, aux=aux, opt=opt, deform=[],
                         deform_opt=[])
    new, stats = T.densify_step(state, EXTENT, max_screen_size, cfg=cfg,
                                max_new=max_new, samples=samples)
    before = as_dicts(params, aux, opt)
    kw = dict(extent=EXTENT, max_screen_size=max_screen_size,
              grad_threshold=THRESHOLD, percent_dense=0.01,
              min_opacity=0.005, split_n=2, max_new=max_new, samples=samples)
    if fault == "threshold_halved":
        kw["grad_threshold"] = THRESHOLD / 2
    if fault == "prune_skipped":
        kw.update(min_opacity=0.0, max_screen_size=0.0)
    ref = RD.densify_round(before["params"], before["aux"], before["moments"],
                           **kw)
    return as_dicts(new.params, new.aux, new.opt), ref, before, stats


CASES = {
    # capacity, live rows, candidate share, budget, size threshold
    "more_candidates_than_the_budget": (1024, 600, 0.3, 16, 0.0),
    "near_capacity": (512, 450, 0.3, 40, 0.0),
    "oversized_and_transparent_pruned": (1024, 700, 0.1, 128, 20.0),
    "after_growing_the_table": (512, 500, 0.2, 64, 20.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_the_ports_round_matches_the_reference(case, seed):
    from trase_tpu_torch.models import gaussians as G

    capacity, n_alive, share, max_new, size = CASES[case]
    p, a, o = seeded_state(capacity, n_alive, seed, share)
    if case == "after_growing_the_table":
        p, a, o = G.grow_capacity(p, a, o, capacity * 2)
    prog, ref, before, stats = both_rounds(p, a, o, max_new, size, seed)
    got = RD.compare(prog, ref, before)
    assert got["readings"]["densify_rows_gap"] == 0, got
    assert got["readings"]["densify_gap"] < 1e-6, got
    counts = ref["counts"]
    assert counts["alive"] == int(stats["n_alive"])
    assert counts["clone"] > 0 and counts["split"] > 0
    if case == "more_candidates_than_the_budget":
        assert counts["clone"] == counts["split"] == max_new
        assert counts["waiting"] > 0
    if case == "near_capacity":
        free = capacity - n_alive
        assert counts["clone"] + counts["split"] <= free
        assert counts["waiting"] > 0
    if case == "oversized_and_transparent_pruned":
        assert counts["pruned"] > 0


@pytest.mark.parametrize("fault", ["threshold_halved", "prune_skipped"])
def test_a_planted_fault_fails_the_comparison(fault):
    p, a, o = seeded_state(1024, 700, 5, 0.1)
    prog, ref, before, _ = both_rounds(p, a, o, 128, 20.0, 5, fault)
    # the faulty reference stands in the program's place
    got = RD.compare(ref, prog, before)
    assert got["readings"]["densify_rows_gap"] > 0


def test_the_control_fails_the_comparison():
    """The round's arithmetic in bfloat16, copies kept exact."""
    p, a, o = seeded_state(1024, 700, 7, 0.3)
    prog, ref, before, _ = both_rounds(p, a, o, 128, 20.0, 7)
    kw = dict(extent=EXTENT, max_screen_size=20.0, grad_threshold=THRESHOLD,
              percent_dense=0.01, min_opacity=0.005, split_n=2, max_new=128)
    shape = (2, 128, 3)
    samples = torch.randn(shape, generator=torch.Generator().manual_seed(8))
    low = RD.densify_round(before["params"], before["aux"], before["moments"],
                           samples=samples, dtype=torch.bfloat16, **kw)
    ref = RD.densify_round(before["params"], before["aux"], before["moments"],
                           samples=samples, **kw)
    got = RD.compare(low, ref, before)
    assert got["readings"]["densify_rows_gap"] > 0 or \
        got["readings"]["densify_gap"] > 1e-4


# ------------------------------------------------- the cell, end to end


def densify_context(tmp_path, first_iteration=590, warm_up=8, trace=0,
                    seed=3):
    """The densifying cell at the tests' size: the checked steps
    (first_iteration + 1..3) and a warm-up that holds the round at the
    next multiple of 100, which the check records (600: the phase's
    first, the deform MLP still off, as in the cell)."""
    from tiny import tiny_context

    ctx = tiny_context("n3v-train-densify", seed=seed, seconds=0.6,
                       trace=trace, tmp=str(tmp_path))
    ctx.traffic.update(first_iteration=first_iteration,
                       warm_up_iterations=warm_up)
    return ctx


def run_densify_cell(ctx):
    import contextlib
    import io
    import json

    from port_bench import run as R

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = R.finish(ctx, torch)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue()


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_checks_its_round(trace, tmp_path, monkeypatch):
    from port_bench import harness as HB

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    ctx = densify_context(tmp_path, trace=trace)
    if trace:
        # rounds inside the tests' short window too
        ctx.cfg["recipe"]["densification_interval"] = 5
    line, err = run_densify_cell(ctx)
    assert line["correct"] is True, line["checks"]
    limits = HB.load_json("workloads", "n3v-train-densify")["limits"]
    assert list(line["checks"]) == list(limits)
    assert line["checks"]["densify_rows_gap"]["value"] == 0
    # the round at 600, on the table the traffic grows in set-up (2048 →
    # 4096 rows here) grown again by the loop (the tests' table is small
    # for the round's budget)
    first = 595 if trace else 600
    assert f"'iteration': {first}, 'rows': 8192" in line_of(err, "detail")
    window = line_of(err, "in the window")
    if not trace:
        assert "'capacity': [8192, 8192]" in window
    else:
        assert "densify_ms.train" in line["metrics"]
        # the window's rounds with their counts: [iteration, clones,
        # splits, pruned, live rows after]
        assert re.search(r"'rounds': \[\[\d+, \d+, \d+, \d+, \d+\]", window)


def test_the_window_ends_before_the_step_changes(tmp_path, monkeypatch):
    """The traffic's last_iteration ends the window where it comes before
    the seconds: the window's rate is its iterations over its time."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    ctx = densify_context(tmp_path)
    ctx.args.seconds = 60.0
    last = ctx.traffic["first_iteration"] + 3 + 8 + 4
    ctx.traffic["last_iteration"] = last
    line, err = run_densify_cell(ctx)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] == 4
    assert f"'last_iteration': {last}," in line_of(err, "in the window")


def line_of(err: str, tag: str) -> str:
    return next(x for x in err.splitlines() if f"[port_bench] {tag}" in x)


def threshold_halved(monkeypatch, T):
    fn = T.densify_step

    def step(state, extent, size, *, cfg, **k):
        return fn(state, extent, size,
                  cfg=cfg._replace(grad_threshold=cfg.grad_threshold / 2), **k)
    monkeypatch.setattr(T, "densify_step", step)


def prune_skipped(monkeypatch, T):
    fn = T.densify_step

    def step(state, extent, size, *, cfg, **k):
        return fn(state, extent, 0.0, cfg=cfg._replace(min_opacity=0.0), **k)
    monkeypatch.setattr(T, "densify_step", step)


def stats_dropped(monkeypatch, T):
    """A step that leaves the densification statistics as they were."""
    fn = T.gaussian_phase_step

    def step(state, *a, **k):
        new, metrics = fn(state, *a, **k)
        return new._replace(aux=state.aux), metrics
    monkeypatch.setattr(T, "gaussian_phase_step", step)


def round_altered(monkeypatch, T):
    """The round's new rows placed a thousandth of a unit off."""
    fn = T.densify_step

    def step(state, *a, **k):
        new, stats = fn(state, *a, **k)
        moved = new.aux.alive & ~state.aux.alive
        xyz = new.params.xyz + 1e-3 * moved[:, None]
        return new._replace(params=new.params._replace(xyz=xyz)), stats
    monkeypatch.setattr(T, "densify_step", step)


@pytest.mark.parametrize("fault", [threshold_halved, prune_skipped,
                                   round_altered, stats_dropped,
                                   unchanged_state, half_batch,
                                   altered_update])
def test_the_cell_fails_on_each_fault(fault, tmp_path, monkeypatch):
    from trase_tpu_torch.engine import trainer as T

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    fault(monkeypatch, T)
    line, _ = run_densify_cell(densify_context(tmp_path))
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", [None, unchanged_state, half_batch])
def test_the_mlp_held_off_before_warm_up(fault, tmp_path, monkeypatch):
    """Checked steps 2591-2593, before the recipe's warm_up (3000): the
    loop holds the deform MLP off, and so does the reference (which ran
    it, with its gradient, before: first_grad_gap read 1.0); the round
    at 2600 prunes by opacity alone."""
    from trase_tpu_torch.engine import trainer as T

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    if fault is not None:
        fault(monkeypatch, T)
    ctx = densify_context(tmp_path, first_iteration=2590, warm_up=12)
    assert ctx.traffic["first_iteration"] + 3 < ctx.cfg["recipe"]["warm_up"]
    line, _ = run_densify_cell(ctx)
    assert line["correct"] is (fault is None), line["checks"]
    if fault is None:
        assert line["checks"]["first_grad_gap"]["value"] < 1e-3
