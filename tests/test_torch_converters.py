"""The port's dataset converters (python -m trase_tpu_torch.neu3d2blender,
.technocolor2blender, .immersive2blender) on tests/test_converters.py's
synthetic fixtures: each case runs the port's CLI and the root CLI on two
copies of one fixture and asserts identical outputs (transforms_*.json,
models_new.json, the extracted or undistorted PNGs and points3d.ply, byte
for byte), then loads the port's output through the port's readers. The
cases keep tests/test_converters.py's slow marks."""
import json
import os
import shutil
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

cv2 = pytest.importorskip("cv2")

from test_converters import H, N_FRAMES, W, _llff_pose_row, _write_video  # noqa: E402


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _both(fixture, tmp_path, run):
    """Copies of the fixture directory for the root CLI and the port's;
    run(cli_name, path) converts one; returns the two paths."""
    paths = {}
    for name in ("root", "port"):
        dst = tmp_path / name / fixture.name
        shutil.copytree(fixture, dst)
        run(name, str(dst))
        paths[name] = dst
    return paths["root"], paths["port"]


def _neu3d_fixture(tmp_path, eyes):
    scene = tmp_path / "fixture" / "flame_toy"
    scene.mkdir(parents=True)
    for i, _ in enumerate(eyes):
        _write_video(str(scene / f"cam{i:02d}.mp4"), seed=i)
    np.save(str(scene / "poses_bounds.npy"),
            np.array([_llff_pose_row(e) for e in eyes]))
    return scene


def _convert_neu3d(scene_fixture, tmp_path):
    import neu3d2blender as root_cli

    from trase_tpu_torch import neu3d2blender as port_cli

    clis = {"root": root_cli, "port": port_cli}
    root, port = _both(scene_fixture, tmp_path, lambda name, p: clis[
        name].main(["--path", p, "--random_points"]))
    got = _tree(port)
    assert got == _tree(root)
    assert {"transforms_train.json", "transforms_test.json",
            "points3d.ply"} <= set(got)
    return port


class _SceneArgs:
    sh_degree = 1
    images = "images"
    resolution = -1
    white_background = False
    eval = True
    load2gpu_on_the_fly = False
    is_blender = False
    is_6dof = False
    load_mask_on_the_fly = False
    load_image_on_the_fly = False
    end_frame = -1
    mask_black_bg = False


@pytest.mark.slow
def test_neu3d_converter(tmp_path):
    from trase_tpu_torch.data.scene import Scene

    eyes = [np.array([0, 0, 4.0]), np.array([1.2, 0.2, 3.8]),
            np.array([-1.2, -0.2, 3.8])]
    scene = _convert_neu3d(_neu3d_fixture(tmp_path, eyes), tmp_path)
    tt = json.loads((scene / "transforms_train.json").read_text())
    assert len(tt["frames"]) == 2 * N_FRAMES  # cams 1,2 train; cam 0 test
    assert {"w", "h", "fl_x", "cx"} <= set(tt.keys())
    assert len([f for f in os.listdir(scene / "images")
                if f.endswith(".png")]) == 3 * N_FRAMES

    a = _SceneArgs()
    a.source_path, a.model_path = str(scene), str(tmp_path / "model")
    sc = Scene(a, resolution_scales=(1.0,), device="cpu")
    assert len(sc.get_train_cameras()) == 2 * N_FRAMES
    assert len(sc.get_test_cameras()) == N_FRAMES
    fids = sorted({c.fid for c in sc.get_train_cameras()})
    assert fids[0] == 0.0 and len(fids) == N_FRAMES
    assert sc.cameras_extent > 0


def test_technicolor_converter(tmp_path, monkeypatch):
    import technocolor2blender as root_cli

    from trase_tpu_torch import technocolor2blender as port_cli
    from trase_tpu_torch.data.readers import read_multi_view_info

    h, w = 1088 // 16, 2048 // 16
    for mod in (root_cli, port_cli):  # small fakes of the full resolution
        monkeypatch.setattr(mod, "H_FULL", h)
        monkeypatch.setattr(mod, "W_FULL", w)
    fixture = tmp_path / "fixture" / "MiniScene"
    fixture.mkdir(parents=True)
    rng = np.random.default_rng(0)
    start, end = 10, 10 + N_FRAMES
    n_cams = 3
    for fr in range(start, end):
        for cam in range(n_cams):
            cv2.imwrite(str(fixture / f"Mini_undist_{fr:05d}_{cam:02d}.png"),
                        rng.integers(0, 255, (h, w, 3), np.uint8))
    with open(fixture / "cameras_parameters.txt", "w") as f:
        f.write("focal cx cy d0 d1 qw qx qy qz tx ty tz\n")
        for cam in range(n_cams):  # camera 1's principal point off centre
            cx = w / 2 + (3 if cam == 1 else 0)
            f.write(f"100.0 {cx} {h / 2} 0 0 1 0 0 0 {0.1 * cam} 0 4.0\n")

    clis = {"root": root_cli, "port": port_cli}
    root, port = _both(fixture, tmp_path, lambda name, p: clis[name].main([
        "--path", p, "--start", str(start), "--end", str(end),
        "--random_points"]))
    got = _tree(port)
    assert got == _tree(root)
    assert len([f for f in got if f.startswith("images/")]) == \
        n_cams * N_FRAMES
    tt = json.loads(got["transforms_train.json"])
    te = json.loads(got["transforms_test.json"])
    assert len(tt["frames"]) == (n_cams - 1) * N_FRAMES
    assert len(te["frames"]) == N_FRAMES
    f0 = tt["frames"][0]
    assert {"fl_x", "cx", "w", "h", "time"} <= set(f0.keys())
    assert f0["cx"] == w / 2  # recentred
    assert "points3d.ply" in got

    # "technicolor" in the path selects the reader's w2c convention
    tech_dir = tmp_path / "technicolor_scene"
    os.rename(port, tech_dir)
    info = read_multi_view_info(str(tech_dir), eval=True)
    assert len(info.train_cameras) == (n_cams - 1) * N_FRAMES
    assert len(info.test_cameras) == N_FRAMES


def test_immersive_converter(tmp_path):
    import immersive2blender as root_cli
    from scipy.spatial.transform import Rotation

    from trase_tpu_torch import immersive2blender as port_cli
    from trase_tpu_torch.data.readers import read_multi_view_info

    fixture = tmp_path / "fixture" / "immersive_toy"
    fixture.mkdir(parents=True)
    n_cams = 3
    models = []
    for i in range(n_cams):
        name = f"camera_{i + 1:04d}"
        _write_video(str(fixture / f"{name}.mp4"), seed=i)
        eye = np.array([1.1 * i - 1.1, 0.1 * i, 4.0])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, np.array([0, 1, 0.0]))
        right /= np.linalg.norm(right)
        dn = np.cross(fwd, right)
        R_w2c = np.stack([right, dn, fwd], axis=0)
        models.append({
            "name": name, "width": W, "height": H, "focal_length": 80.0,
            "principal_point": [W / 2, H / 2],
            "radial_distortion": [0.02, 0.002, 0.0, 0.0],
            "orientation": Rotation.from_matrix(R_w2c).as_rotvec().tolist(),
            "position": eye.tolist(),
        })
    (fixture / "models.json").write_text(json.dumps(models))

    clis = {"root": root_cli, "port": port_cli}
    root, port = _both(fixture, tmp_path, lambda name, p: clis[name].main([
        "--path", p, "--end", str(N_FRAMES), "--random_points"]))
    got = _tree(port)
    assert got == _tree(root)
    meta = json.loads(got["models_new.json"])
    assert len(meta) == n_cams and meta[0]["focal_length"] > 0
    imgs = sorted(f for f in got if f.startswith("images/"))
    assert len(imgs) == n_cams * N_FRAMES
    assert imgs[0] == "images/camera_0001_0000.png"
    tt = json.loads(got["transforms_train.json"])
    te = json.loads(got["transforms_test.json"])
    assert len(tt["frames"]) == (n_cams - 1) * N_FRAMES
    assert len(te["frames"]) == N_FRAMES
    f0 = tt["frames"][0]
    assert {"fl_x", "cx", "w", "h", "time", "transform_matrix"} <= set(f0)
    assert "fl_x" not in tt and f0["time"] == 0.0
    assert "points3d.ply" in got

    info = read_multi_view_info(str(port), eval=True)
    assert len(info.train_cameras) == (n_cams - 1) * N_FRAMES
    assert len(info.test_cameras) == N_FRAMES
    fids = sorted({c.fid for c in info.train_cameras})
    assert len(fids) == N_FRAMES and fids[0] == 0.0


@pytest.mark.slow
def test_neu3d_converter_to_training_pipeline(tmp_path):
    """Synthetic videos + LLFF poses -> the port's neu3d2blender (its
    outputs equal the root CLI's) -> the port's Scene and readers -> a
    50-iteration run of the port's engine/loop.py Trainer on the CPU ->
    snapshot + finite eval."""
    from trase_tpu_torch import train as t_train
    from trase_tpu_torch.config import ModelParams, OptimizationParams
    from trase_tpu_torch.data.scene import Scene
    from trase_tpu_torch.engine.loop import Trainer
    from trase_tpu_torch.ops.rasterize import RasterConfig

    eyes = [np.array([0, 0, 4.0]), np.array([1.2, 0.2, 3.8]),
            np.array([-1.2, -0.2, 3.8]), np.array([0.6, -0.4, 3.9])]
    scene = _convert_neu3d(_neu3d_fixture(tmp_path, eyes), tmp_path)

    model_dir = str(tmp_path / "model")
    args = t_train.parse_args([
        "-s", str(scene), "-m", model_dir, "--eval", "--sh_degree", "1",
        "--iterations", "50", "--warm_up", "10", "--warm_up_3d_features",
        "30", "--iterative_opt_interval", "10", "--densify_from_iter", "15",
        "--densify_until_iter", "40", "--densification_interval", "20",
        "--opacity_reset_interval", "100000", "--position_lr_max_steps",
        "50", "--deform_lr_max_steps", "50", "--device", "cpu"])
    dataset = ModelParams.extract(args)
    os.makedirs(model_dir, exist_ok=True)
    trainer = Trainer(dataset, OptimizationParams.extract(args), None,
                      Scene(dataset, resolution_scales=(1.0,), device="cpu"),
                      raster_cfg=RasterConfig(pairs_per_gaussian=4),
                      device="cpu", seed=0)
    losses = []
    trainer.train(first_iter=0, saving_iterations={50},
                  testing_iterations={50}, progress=False,
                  on_iteration=lambda tr, it, m: losses.append(
                      float(m["loss"])))
    assert len(losses) == 50 and np.isfinite(losses).all()
    assert np.isfinite(trainer.evaluate(50))
    assert int(trainer.state.aux.alive.sum()) > 0
    assert os.path.exists(os.path.join(model_dir, "point_cloud",
                                       "iteration_50", "point_cloud.ply"))
