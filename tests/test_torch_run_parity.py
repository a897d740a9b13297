"""Run-level parity (ROADMAP.md north star, parity test 5): the root
train.py and the port's train CLI train on one synthetic dataset (the
n_times rig, 8 train and 2 test views at 32x32, 2 blobs of 24 points)
for 200 iterations: the deform net from 150, a densify (with capacity
growth) at 100.

What the two runs share: the camera shuffle (python's random seeded with
0 before each), the camera and AST draws (numpy, seed 0) and the deform
net's init (trase_tpu's, injected into the port as ROADMAP.md's ground
rules inject draws). What they do not: the densify's split samples
(jax.random against torch.Generator) and float sums in other orders.

Checks: the snapshots at 99 (before the densify and the deform net) agree
within SNAPSHOT_TOL on every field; the final test PSNRs lie within
PSNR_BAND dB. Measured on the CPU over dataset seeds 0, 1, 2 with this
configuration: port - root = -0.32, +0.31, -0.19 dB; snapshot-99 max abs
differences 0.00044, 0.0010, 0.0027 (opacity logits, log-scales and DC
colours; xyz within 4e-5). The band is 3x the largest PSNR difference, the
snapshot tolerance about 2x the largest field difference. Run this file
as a script (below) to measure them again.

The root CLI runs in a subprocess beside the port, with trase_tpu's dense
backend batching 4 tiles at a time (RasterConfig.tile_batch, a speed knob
that changes no value: 32 would pad these 4 tiles to 32) and tensorboard's
TensorFlow-free writer (the one the port uses), which spares the
subprocess TensorFlow's import."""
import contextlib
import io
import os
import random
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_LINE = re.compile(
    r"\[ITER (\d+)\] Evaluating (test|train): L1 ([0-9.]+) PSNR ([0-9.inf]+)")
PSNR_BAND = 1.0
SNAPSHOT_TOL = 0.006
FLAGS = ["--iterations", "200", "--eval", "--quiet", "--sh_degree", "1",
         "--pairs_per_gaussian", "16", "--test_iterations", "200",
         "--save_iterations", "99", "200", "--warm_up", "150",
         "--densify_from_iter", "50", "--densification_interval", "50",
         "--densify_until_iter", "120"]


def run_both(base: str, seed: int = 0, inject: bool = True) -> dict:
    """Write the dataset at `seed` under `base`, run the root CLI (in a
    subprocess) and the port's CLI on it; {name: (model dir, stdout)}.
    inject=False leaves the port's deform init its own."""
    import jax

    import trase_tpu_torch.engine.loop as TL
    from trase_tpu.models import deform as JD
    from trase_tpu_torch import train as t_train
    from trase_tpu_torch.data.synthetic import write_synthetic_dataset
    from trase_tpu_torch.models import deform as TD

    src = os.path.join(base, "data")
    write_synthetic_dataset(src, n_train=8, n_test=2, image_size=32,
                            n_blobs=2, pts_per_blob=24, n_times=4, seed=seed,
                            device="cpu")
    root_mdl, port_mdl = (os.path.join(base, n) for n in ("root", "port"))
    code = (
        "import functools, random, sys, types\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "sys.modules['tensorboard.compat.notf'] = types.ModuleType('notf')\n"
        "import trase_tpu.ops.rasterize as JR\n"
        "JR.RasterConfig = functools.partial(JR.RasterConfig, tile_batch=4)\n"
        "import train\n"
        "random.seed(0)\n"
        f"train.main({['-s', src, '-m', root_mdl] + FLAGS!r})\n")
    root = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def trase_tpu_init(net, generator):
        # trase_tpu's Trainer: PRNGKey(seed), split, init_deform
        _, init_rng = jax.random.split(jax.random.PRNGKey(0))
        variables = JD.init_deform(init_rng,
                                   JD.make_deform_network("DeformNetwork"))
        return TD.load_flax_params(
            net, jax.tree_util.tree_map(np.asarray, variables))

    saved = TL.init_deform
    if inject:
        TL.init_deform = trase_tpu_init
    buf = io.StringIO()
    try:
        random.seed(0)
        with contextlib.redirect_stdout(buf):
            t_train.main(["-s", src, "-m", port_mdl, "--device", "cpu"]
                         + FLAGS)
    finally:
        TL.init_deform = saved
        out, err = root.communicate(timeout=600)
    assert root.returncode == 0, err[-3000:]
    return {"root": (root_mdl, out), "port": (port_mdl, buf.getvalue())}


def snapshot_diffs(runs: dict) -> dict:
    """{field: max abs difference} of the two snapshots at 99."""
    from trase_tpu_torch.models.gaussians_io import load_gaussian_ply

    snaps = {}
    for name, (mdl, _) in runs.items():
        p, _, n, _ = load_gaussian_ply(os.path.join(
            mdl, "point_cloud", "iteration_99", "point_cloud.ply"),
            sh_degree=1, device="cpu")
        snaps[name] = (p, n)
    (a, na), (b, nb) = snaps["root"], snaps["port"]
    assert na == nb == 48
    return {f: float((getattr(a, f)[:na] - getattr(b, f)[:nb]).abs().max())
            for f in a._fields}


def final_psnrs(runs: dict) -> dict:
    """{name: test PSNR at 200} from each CLI's evaluation lines."""
    psnr = {}
    for name, (_, text) in runs.items():
        lines = [m.groups() for m in EVAL_LINE.finditer(text)]
        assert [x[:2] for x in lines] == [("200", "test"),
                                          ("200", "train")], name
        psnr[name] = float(lines[0][3])
    return psnr


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    return run_both(str(tmp_path_factory.mktemp("parity")))


def test_snapshots_agree_before_densify_and_deform(both_runs):
    """After 99 GAUSSIAN steps over the same views, both snapshots hold
    the same gaussians within SNAPSHOT_TOL."""
    for field, diff in snapshot_diffs(both_runs).items():
        assert diff <= SNAPSHOT_TOL, (field, diff)


def test_final_test_psnr_within_band(both_runs):
    """Both CLIs evaluate test and train views at 200; the test PSNRs lie
    within PSNR_BAND dB of each other."""
    psnr = final_psnrs(both_runs)
    assert 15.0 < psnr["root"] < 50.0
    assert abs(psnr["port"] - psnr["root"]) <= PSNR_BAND, psnr


if __name__ == "__main__":
    # measure the band: python tests/test_torch_run_parity.py 0 1 2
    # [--no-inject] (with JAX_PLATFORMS=cpu)
    import argparse
    import tempfile

    sys.path.insert(0, ROOT)
    ap = argparse.ArgumentParser()
    ap.add_argument("seeds", nargs="+", type=int)
    ap.add_argument("--no-inject", action="store_true")
    a = ap.parse_args()
    for seed in a.seeds:
        with tempfile.TemporaryDirectory() as base:
            runs = run_both(base, seed, inject=not a.no_inject)
            psnr = final_psnrs(runs)
            print(seed, psnr, "port - root", psnr["port"] - psnr["root"],
                  "snapshot 99 max diff", max(snapshot_diffs(runs).values()),
                  flush=True)
