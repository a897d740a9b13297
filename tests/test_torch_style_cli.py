"""The port's style-transfer CLI against the root
train_style_transfer_nnfm.py: the same flags with the same defaults (the
root parser captured as it parses), the --load_iteration -1 error, no
silent fallback to the CPU, the whole-scene fallback when the segment ids
match nothing, and both CLIs run for a few iterations on copies of one
model directory (a snapshot, a deform.pkl, a clusters.pt from the blobs'
ids), with a seeded style image with a flat half. The snapshot the port
writes is read by trase_tpu's Scene (what root render.py loads) and
renders through trase_tpu's renderer within one 8-bit level of the PNG
``python -m trase_tpu_torch.render`` writes from it.

The deform.pkl's output heads are zero: d_xyz, d_rotation and d_scaling
are exactly 0 in both packages, so the bf16 hidden stack, which rounds
at other places in each (tests/test_torch_style.py checks the step with
it on), does not enter the comparison; an unloaded deform.pkl would show
as the port's own random deformation. Tolerance: the saved colours
within 1e-4 of each field's scale after 4 steps; geometry and opacity as
they were (the features, which a snapshot KNN-smooths, within 1e-5 of
trase_tpu's)."""
import argparse
import os
import random
import shutil
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trase_tpu.cluster.clustering import save_clusters
from trase_tpu.data.synthetic import write_synthetic_dataset
from trase_tpu.models import deform as JD
from trase_tpu.models import gaussians as JG
from trase_tpu.models.gaussians_io import (load_gaussian_ply as j_load_ply,
                                           save_checkpoint,
                                           save_gaussian_ply)
from trase_tpu.utils.sh import rgb_to_sh

from trase_tpu_torch import train_style_transfer_nnfm as t_style

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

torch.set_num_threads(2)

IT, STEPS, SIZE = 30, 4, 48
TOL = 1e-4


class _Parsed(Exception):
    """Raised in place of parse_args, to capture the root CLI's parser."""


def _root_parser(monkeypatch):
    import train_style_transfer_nnfm as root_style

    box = {}

    def capture(self, *a, **kw):
        box["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        root_style.main(["-s", "unused", "--reference_img_path", "x.png"])
    monkeypatch.undo()
    return box["parser"]


def _options(parser) -> dict:
    return {opt: a for a in parser._actions for opt in a.option_strings
            if opt not in ("-h", "--help")}


def test_every_root_flag_with_its_default(monkeypatch):
    """Each option of the root CLI is an option of the port's, with the
    same destination, default, arity, type, choices and required flag;
    the port adds --device alone (--data_device names the card, as in
    the port's train CLI)."""
    root = _options(_root_parser(monkeypatch))
    port = _options(t_style.make_parser())
    assert set(port) - set(root) == {"--device"}
    assert not set(root) - set(port)
    for opt, a in root.items():
        b = port[opt]
        want = "cuda" if opt == "--data_device" else a.default
        assert (b.dest, b.default, b.nargs, b.type, b.choices, b.const,
                b.required) == (a.dest, want, a.nargs, a.type, a.choices,
                                a.const, a.required), opt
    assert port["--device"].default == "cuda"


def test_load_iteration_required(capsys, tmp_path):
    assert t_style.main(["-s", str(tmp_path), "-m", str(tmp_path),
                         "--reference_img_path", "x.png"]) is None
    assert "Please load a pretrained scene" in capsys.readouterr().out


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A synthetic dataset; a snapshot at IT with per-blob colours and SH
    rest; a deform.pkl with zero output heads; clusters.pt holding each
    gaussian's blob; the style image."""
    from PIL import Image

    base = tmp_path_factory.mktemp("style")
    src, mdl = str(base / "data"), str(base / "model")
    scene = write_synthetic_dataset(src, n_train=3, n_test=1,
                                    image_size=SIZE, n_blobs=3,
                                    pts_per_blob=32)
    n = scene["xyz"].shape[0]
    rng = np.random.default_rng(21)
    params = JG.empty_params(capacity=n, sh_degree=1)._replace(
        xyz=jnp.asarray(scene["xyz"]),
        features_dc=jnp.asarray(rgb_to_sh(scene["rgb"]))[:, None, :],
        features_rest=jnp.asarray(0.1 * rng.normal(size=(n, 3, 3)).astype(
            np.float32)),
        scaling=jnp.full((n, 3), np.log(scene["scale"])),
        rotation=jnp.zeros((n, 4)).at[:, 0].set(1.0),
        opacity=jnp.full((n, 1), 2.0),
        gaussian_features=jnp.asarray(rng.normal(
            size=(n, JG.FEATURE_DIM)).astype(np.float32)))
    cdir = os.path.join(mdl, "point_cloud", f"iteration_{IT}")
    save_gaussian_ply(os.path.join(cdir, "point_cloud.ply"), params,
                      np.ones(n, bool))
    save_clusters(os.path.join(cdir, "clusters.pt"),
                  scene["blob_id"].astype(np.int64),
                  np.zeros((n, 3), np.float32))
    net = JD.make_deform_network("DeformNetwork", is_blender=True)
    v = jax.tree_util.tree_map(np.array,
                               JD.init_deform(jax.random.PRNGKey(0), net))
    for head in ("Dense_10", "Dense_11", "Dense_12"):
        v["params"][head]["kernel"] = v["params"][head]["kernel"] * 0.0
        v["params"][head]["bias"] = v["params"][head]["bias"] * 0.0
    save_checkpoint(os.path.join(mdl, "deform", f"iteration_{IT}",
                                 "deform.pkl"),
                    {"vars": v, "type": "DeformNetwork"})
    img = rng.uniform(size=(SIZE, SIZE, 3))
    img[: SIZE // 2] = 0.3  # a flat half: tied columns in the NNFM max
    style = str(base / "style.png")
    Image.fromarray((img * 255).astype(np.uint8)).save(style)
    return scene, src, mdl, style


def _argv(src, mdl, style, segment):
    return ["-s", src, "-m", mdl, "--load_iteration", str(IT),
            "--iterations", str(IT + STEPS), "--sh_degree", "1",
            "--is_blender", "--eval", "--quiet", "--segment_ids",
            str(segment), "--reference_img_path", style]


def _ply(mdl, it):
    """The snapshot's live rows as numpy, by field."""
    params, _, n, _ = j_load_ply(os.path.join(
        mdl, "point_cloud", f"iteration_{it}", "point_cloud.ply"),
        sh_degree=1)
    return {k: np.asarray(v)[:n] for k, v in params._asdict().items()}


def test_style_cli_matches_root(model_dir, tmp_path):
    """Both CLIs 4 iterations on blob 1: the saved colours agree, only
    blob 1's colours moved, every other field is as loaded; the snapshot
    loads in trase_tpu's Scene and renders through the port's render
    CLI."""
    import train_style_transfer_nnfm as root_style
    from trase_tpu.data.scene import Scene

    from trase_tpu_torch import render as t_render

    scene, src, mdl, style = model_dir
    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = str(tmp_path / name)
        shutil.copytree(mdl, dirs[name])
        argv = _argv(src, dirs[name], style, 1)
        random.seed(0)  # the root CLI's Scene shuffles with python's random
        if name == "jax":
            root_style.main(argv)
        else:
            tr = t_style.main(argv + ["--device", "cpu"])
            assert np.isfinite(tr.ema_loss) and tr.ema_loss > 0
    before = _ply(mdl, IT)
    got = {k: _ply(v, IT + STEPS) for k, v in dirs.items()}
    obj = scene["blob_id"] == 1
    for k in ("features_dc", "features_rest"):
        a, b, old = got["jax"][k], got["port"][k], before[k]
        err = np.abs(a - b).max() / np.abs(a).max()
        assert err < TOL, (k, err)
        np.testing.assert_array_equal(b[~obj], old[~obj])
        assert (b[obj] != old[obj]).any(), k
    for k in ("xyz", "opacity", "scaling", "rotation"):
        np.testing.assert_array_equal(got["port"][k], before[k], err_msg=k)
    # the snapshot's features are KNN-smoothed in both packages
    np.testing.assert_allclose(got["port"]["gaussian_features"],
                               got["jax"]["gaussian_features"], atol=1e-5)

    class A:
        sh_degree, images, resolution = 1, "images", -1
        white_background, eval, is_blender, is_6dof = False, True, True, False
        load2gpu_on_the_fly = load_mask_on_the_fly = False
        load_image_on_the_fly = mask_black_bg = False
        end_frame = -1
        source_path, model_path = src, dirs["port"]

    sc = Scene(A(), load_iteration=IT + STEPS, shuffle=False)
    assert sc.loaded_iter == IT + STEPS
    t_render.main(["-s", src, "-m", dirs["port"], "--iteration",
                   str(IT + STEPS), "--skip_train", "--sh_degree", "1",
                   "--is_blender", "--eval", "--device", "cpu"])
    renders = os.path.join(dirs["port"], "test", f"ours_{IT + STEPS}",
                           "renders")
    assert sorted(os.listdir(renders)) == ["00000.png"]
    # trase_tpu renders the snapshot it loaded as the port's CLI did (the
    # deformation is zero): within one 8-bit level
    from PIL import Image
    from trase_tpu.renderer import render as j_render

    jimg = j_render(sc.get_test_cameras()[0].to_render_camera(),
                    sc.gaussian_params, sc.gaussian_aux.alive, jnp.zeros(3),
                    sh_degree=1, with_features=False)["render"]
    jimg = np.clip(np.asarray(jimg).transpose(1, 2, 0), 0, 1) * 255
    with Image.open(os.path.join(renders, "00000.png")) as im:
        png = np.asarray(im.convert("RGB"), np.float32)
    assert np.abs(png - jimg).max() <= 1.0 + 1e-3


def test_unmatched_segment_styles_the_whole_scene(model_dir, tmp_path,
                                                  capsys):
    scene, src, mdl, style = model_dir
    copy = str(tmp_path / "m")
    shutil.copytree(mdl, copy)
    argv = _argv(src, copy, style, 99)
    argv[argv.index("--iterations") + 1] = str(IT + 1)
    t_style.main(argv + ["--device", "cpu"])
    assert "match no gaussians; styling the whole scene" in \
        capsys.readouterr().out
    new, old = _ply(copy, IT + 1), _ply(mdl, IT)
    moved = (new["features_dc"] != old["features_dc"]).any(axis=(1, 2))
    assert moved.sum() > 0.5 * len(moved)  # not one blob: the scene


def test_cuda_without_a_card_raises(model_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene, src, mdl, style = model_dir
    copy = str(tmp_path / "m")
    shutil.copytree(mdl, copy)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_style.main(_argv(src, copy, style, 1))
