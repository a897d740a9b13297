"""The port's mesh trainer (trase_tpu_torch/parallel/trainer.py:
ShardedTrainer) in a world of 2 gloo ranks on the synthetic dataset, the
mirror of tests/test_sharded_trainer.py: its GAUSSIAN iterations track
the single-device Trainer, its checkpoints resume in a single-device run
and the single-device run's in it, and the train CLI trains both phases
with --mesh 2 on the CPU. The ranks run tests/torch_worlds.py."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from trase_tpu_torch.data.synthetic import write_synthetic_dataset
from trase_tpu_torch.engine import trainer as TT

import torch_worlds as TW

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the GAUSSIAN parity run of test_sharded_trainer.py: 8 iterations, the
# deform net on from 3, no features, no densify
GAUSS_FLAGS = ["--is_blender", "--eval", "--sh_degree", "1", "--iterations",
               "8", "--warm_up", "3", "--warm_up_3d_features", "100",
               "--densify_until_iter", "0", "--pairs_per_gaussian", "16",
               "--test_iterations", "8", "--save_iterations", "8"]
# both phases in 10 iterations: FEATURE blocks from 4, densifies at 5 and 8
RUN_FLAGS = ["--is_blender", "--eval", "--sh_degree", "1", "--iterations",
             "10", "--warm_up", "3", "--warm_up_3d_features", "4",
             "--iterative_opt_interval", "2", "--densify_from_iter", "2",
             "--densification_interval", "3", "--densify_until_iter", "9",
             "--num_sampled_pixels", "64", "--num_sampled_masks", "3",
             "--pairs_per_gaussian", "16", "--test_iterations", "10"]


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sharded") / "data")
    write_synthetic_dataset(d, n_train=4, n_test=2, image_size=32,
                            n_blobs=2, pts_per_blob=24, device="cpu")
    return d


def _single(src, mdl, flags, resume=None):
    tr, args = TW.trainer(None, src, mdl, flags)
    first = tr.load_ckpt(resume) if resume else 0
    loaded = TT.train_state_to_numpy(tr.state) if resume else None
    losses = []
    tr.train(first_iter=first, progress=False,
             on_iteration=lambda t, i, m: losses.append(float(m["loss"])),
             checkpoint_iterations=set(args.checkpoint_iterations))
    return losses, TT.train_state_to_numpy(tr.state), loaded


def _saved_state(path):
    with open(path, "rb") as f:
        return pickle.load(f)["state"]


def _assert_trees_equal(a, b):
    for k in ("params", "aux"):
        for f, x in a[k].items():
            np.testing.assert_array_equal(x, b[k][f], err_msg=f"{k}.{f}")
    for f, s in a["opt"].items():
        for m in ("mu", "nu", "step"):
            np.testing.assert_array_equal(s[m], b["opt"][f][m],
                                          err_msg=f"opt.{f}.{m}")


def test_gaussian_iterations_track_single(src, tmp_path):
    """8 GAUSSIAN iterations from the same state and views: the first 3
    (before the deform net) within 1e-6 relative, all within 0.03 (the
    deform net's bf16 gradients, summed per rank, drift), xyz within
    rtol 0.02 / atol 1e-4, with the rows in their single-device order."""
    single, xyz_single, _ = _single(src, str(tmp_path / "single"),
                                    GAUSS_FLAGS)
    got = TW.run_world(TW.train_loop, 2, tmp_path, dict(
        src=src, mdl=str(tmp_path / "mesh"), flags=GAUSS_FLAGS,
        interleave=False))[0]
    assert len(got["losses"]) == 8 and set(got["phases"]) == {"GAUSSIAN"}
    np.testing.assert_allclose(got["losses"][:3], single[:3], rtol=1e-6)
    np.testing.assert_allclose(got["losses"], single, rtol=0.03)
    np.testing.assert_allclose(got["state"]["params"]["xyz"],
                               xyz_single["params"]["xyz"], rtol=0.02,
                               atol=1e-4)
    # rank 0 wrote the snapshot
    assert os.path.exists(os.path.join(tmp_path, "mesh", "point_cloud",
                                       "iteration_8", "point_cloud.ply"))


def test_checkpoints_cross_between_mesh_and_single(src, tmp_path):
    """A mesh run's checkpoint loads bit for bit in a single-device run
    and trains on; a single-device run's loads bit for bit in a mesh run
    and trains on."""
    flags = RUN_FLAGS + ["--checkpoint_iterations", "6"]
    mesh_mdl = str(tmp_path / "mesh")
    got = TW.run_world(TW.train_loop, 2, tmp_path, dict(
        src=src, mdl=mesh_mdl, flags=flags))[0]
    assert {"GAUSSIAN", "FEATURE"} <= set(got["phases"])
    assert np.isfinite(got["losses"]).all()
    ckpt = os.path.join(mesh_mdl, "chkpnt6.pkl")
    losses, _, loaded = _single(src, str(tmp_path / "single_resumed"),
                                RUN_FLAGS, resume=ckpt)
    _assert_trees_equal(_saved_state(ckpt), loaded)
    assert len(losses) == 4 and np.isfinite(losses).all()

    single_mdl = str(tmp_path / "single")
    _single(src, single_mdl, flags)
    ckpt = os.path.join(single_mdl, "chkpnt6.pkl")
    back = TW.run_world(TW.train_loop, 2, tmp_path, dict(
        src=src, mdl=str(tmp_path / "mesh_resumed"), flags=RUN_FLAGS,
        resume=ckpt))[0]
    _assert_trees_equal(_saved_state(ckpt), back["loaded"])
    assert len(back["losses"]) == 4 and np.isfinite(back["losses"]).all()


def test_cli_mesh_trains_both_phases(src, tmp_path):
    """python -m trase_tpu_torch.train --mesh 2 --device cpu spawns its
    ranks and trains both phases; rank 0 writes the snapshot and cfg."""
    mdl = str(tmp_path / "cli")
    proc = subprocess.run(
        [sys.executable, "-m", "trase_tpu_torch.train", "-s", src, "-m",
         mdl, "--mesh", "2", "--device", "cpu", "--quiet",
         "--save_iterations", "10"] + RUN_FLAGS,
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Training complete" in proc.stdout
    assert "Evaluating test" in proc.stdout
    assert os.path.exists(os.path.join(mdl, "point_cloud", "iteration_10",
                                       "point_cloud.ply"))
    assert os.path.exists(os.path.join(mdl, "cfg_args"))
    assert not [d for d in os.listdir(mdl) if d.startswith(".mesh_")]
