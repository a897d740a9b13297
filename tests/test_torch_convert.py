"""The port's dataset-conversion core (trase_tpu_torch/tools/convert.py),
its COLMAP writers (data/colmap.py) and safe_state against trase_tpu's on
inputs made from seeds with numpy. Both packages run the same float64
numpy operations in the same order, so every pose result is equal
(np.array_equal, no tolerance), the JSON, PLY and COLMAP files are equal
byte for byte, and the sqlite rows equal."""
import json
import os
import random
import sqlite3
import struct

import numpy as np
import pytest

from trase_tpu.data import colmap as JCM
from trase_tpu.tools import convert as JC
from trase_tpu.utils.general import safe_state as j_safe_state

from trase_tpu_torch.data import colmap as TCM
from trase_tpu_torch.tools import convert as TC
from trase_tpu_torch.utils.general import safe_state as t_safe_state

SEEDS = [0, 1, 2]


def _rotation(rng):
    q = rng.normal(size=4)
    return JCM.qvec2rotmat(q / np.linalg.norm(q))


def _poses_bounds(rng, n):
    """LLFF rows of n cameras on a ring around the origin (H, W, focal in
    the fifth column)."""
    rows = []
    for i in range(n):
        a = 2 * np.pi * i / n + rng.uniform(-0.2, 0.2)
        eye = np.array([3 * np.sin(a), rng.uniform(-0.5, 0.5),
                        3 * np.cos(a)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0, 1.0, 0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        c2w = np.stack([down, right, -fwd, eye], axis=1)
        hwf = np.array([[480.0], [640.0], [rng.uniform(400, 600)]])
        rows.append(np.concatenate([c2w, hwf], 1).reshape(-1).tolist()
                    + [0.5, 8.0])
    return np.array(rows)


@pytest.mark.parametrize("seed", SEEDS)
def test_pose_math_equal(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=3), rng.normal(size=3)
    assert np.array_equal(TC.rotmat(a, b), JC.rotmat(a, b))
    oa, da, ob, db = (rng.normal(size=3) for _ in range(4))
    tp, tw = TC.closest_point_2_lines(oa, da, ob, db)
    jp, jw = JC.closest_point_2_lines(oa, da, ob, db)
    assert np.array_equal(tp, jp) and tw == jw
    pb = _poses_bounds(rng, 5)
    for scale in (1, 2):
        tposes, thwf = TC.llff_to_nerf_poses(pb.copy(), scale)
        jposes, jhwf = JC.llff_to_nerf_poses(pb.copy(), scale)
        assert np.array_equal(tposes, jposes) and thwf == jhwf
    rec = TC.recenter_rescale(tposes.copy())
    assert np.array_equal(rec, JC.recenter_rescale(jposes.copy()))
    assert np.isclose(np.linalg.norm(rec[:, :3, 3], axis=-1).mean(), 4.0)
    R = _rotation(rng)
    assert TC.rotmat2qvec_colmap(R) == JC.rotmat2qvec_colmap(R)
    assert np.array_equal(TCM.rotmat2qvec(R), JCM.rotmat2qvec(R))
    # the quaternion is R's: back through the port's qvec2rotmat
    np.testing.assert_allclose(TCM.qvec2rotmat(TCM.rotmat2qvec(R)), R,
                               atol=1e-12)


def test_safe_state_seeds_like_trase_tpu():
    draws = []
    for fn in (j_safe_state, t_safe_state):
        fn(7)
        draws.append((random.random(), np.random.random(3).tolist()))
    assert draws[0] == draws[1]


def test_write_transforms_equal(tmp_path):
    rng = np.random.default_rng(3)
    frames = [{"file_path": f"images/cam{i:02d}_0000",
               "transform_matrix": rng.normal(size=(4, 4)).tolist(),
               "time": i / 30.0} for i in range(4)]
    shared = {"w": 96, "h": 64, "fl_x": 80.0, "fl_y": 80.0, "cx": 48,
              "cy": 32}
    for name, mod in (("jax", JC), ("port", TC)):
        os.makedirs(tmp_path / name)
        mod.write_transforms(str(tmp_path / name), frames[1:], frames[:1],
                             shared)
    for split in ("train", "test"):
        a = (tmp_path / "jax" / f"transforms_{split}.json").read_bytes()
        b = (tmp_path / "port" / f"transforms_{split}.json").read_bytes()
        assert a == b
    got = json.loads(b)
    assert got["fl_x"] == 80.0 and len(got["frames"]) == 1


@pytest.mark.parametrize("n,seed", [(1, 0), (2000, 5)])
def test_write_random_points_byte_equal(tmp_path, n, seed):
    from trase_tpu_torch.data.ply import read_point_cloud

    a, b = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    JC.write_random_points(a, n=n, radius=1.5, seed=seed)
    TC.write_random_points(b, n=n, radius=1.5, seed=seed)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    pts = read_point_cloud(b)
    assert len(pts[0]) == n and float(np.abs(pts[0]).max()) <= 1.5


def _points3d(rng, n):
    xyz = rng.normal(size=(n, 3))
    rgb = rng.integers(0, 256, size=(n, 3))
    err = rng.uniform(0, 2, size=n)
    return xyz, rgb, err


def _write_points3d_txt(path, xyz, rgb, err):
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        for i, (p, c, e) in enumerate(zip(xyz, rgb, err)):
            x, y, z = (float(v) for v in p)
            f.write(f"{i + 1} {x!r} {y!r} {z!r} {c[0]} {c[1]} {c[2]} "
                    f"{float(e)!r} 1 {i} 2 {i + 1}\n")


def _write_points3d_bin(path, xyz, rgb, err):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i, (p, c, e) in enumerate(zip(xyz, rgb, err)):
            f.write(struct.pack("<QdddBBBd", i + 1, *p, *c.tolist(), e))
            track = [(1, i), (2, i + 1)]
            f.write(struct.pack("<Q", len(track)))
            for image_id, point2d in track:
                f.write(struct.pack("<ii", image_id, point2d))


@pytest.mark.parametrize("kind", ["txt", "bin"])
def test_colmap_points_to_ply_equal(tmp_path, kind):
    from trase_tpu_torch.data.ply import read_point_cloud

    rng = np.random.default_rng(8)
    xyz, rgb, err = _points3d(rng, 37)
    model = tmp_path / "sparse"
    model.mkdir()
    writer = _write_points3d_txt if kind == "txt" else _write_points3d_bin
    writer(str(model / f"points3D.{kind}"), xyz, rgb, err)
    a, b = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    assert JC.colmap_points_to_ply(str(model), a)
    assert TC.colmap_points_to_ply(str(model), b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    got_xyz, got_rgb = read_point_cloud(b)[:2]
    np.testing.assert_array_equal(got_xyz, xyz.astype(np.float32))
    np.testing.assert_array_equal(np.rint(got_rgb * 255.0), rgb)
    # no model: False, no file
    empty = tmp_path / "empty"
    empty.mkdir()
    assert not TC.colmap_points_to_ply(str(empty), str(tmp_path / "x.ply"))
    assert not os.path.exists(tmp_path / "x.ply")


def _camera_db(path, n):
    db = sqlite3.connect(path)
    db.execute("CREATE TABLE cameras (camera_id INTEGER PRIMARY KEY, "
               "model INTEGER, width INTEGER, height INTEGER, params BLOB, "
               "prior_focal_length INTEGER)")
    for i in range(1, n + 1):
        db.execute("INSERT INTO cameras VALUES (?, 2, 10, 10, ?, 0)",
                   (i, np.zeros(4).tobytes()))
    db.commit()
    db.close()


def test_cameras_to_database_equal(tmp_path):
    rng = np.random.default_rng(9)
    lines = ["# Camera list", ""]
    models = ("PINHOLE", "SIMPLE_PINHOLE", "SIMPLE_RADIAL")
    for i, model in enumerate(models, start=1):
        n_par = {"PINHOLE": 4, "SIMPLE_PINHOLE": 3, "SIMPLE_RADIAL": 4}[model]
        par = " ".join(repr(float(x)) for x in rng.uniform(10, 500, n_par))
        lines.append(f"{i} {model} {64 + i} {48 + i} {par}")
    cams = tmp_path / "cameras.txt"
    cams.write_text("\n".join(lines) + "\n")
    rows = {}
    for name, mod in (("jax", JC), ("port", TC)):
        db = str(tmp_path / f"{name}.db")
        _camera_db(db, len(models))
        mod._cameras_to_database(str(cams), db)
        con = sqlite3.connect(db)
        rows[name] = con.execute("SELECT * FROM cameras ORDER BY "
                                 "camera_id").fetchall()
        con.close()
    assert rows["port"] == rows["jax"]
    assert [r[1] for r in rows["port"]] == [1, 0, 2]
    assert all(r[5] == 1 for r in rows["port"])


def _images(rng, n):
    out = {}
    for i in range(1, n + 1):
        k = int(rng.integers(0, 5))
        out[i] = JCM.ColmapImage(
            i, rng.normal(size=4), rng.normal(size=3), int(rng.integers(1, 3)),
            f"cam{i:02d}_0000.png", rng.uniform(0, 100, size=(k, 2)),
            rng.integers(-1, 50, size=k))
    return out


def test_colmap_binary_writers_byte_equal(tmp_path):
    rng = np.random.default_rng(10)
    images = _images(rng, 6)
    cams = {1: JCM.ColmapCamera(1, "PINHOLE", 640, 480,
                                rng.uniform(100, 500, 4)),
            2: JCM.ColmapCamera(2, "SIMPLE_RADIAL", 320, 240,
                                rng.uniform(0, 300, 4)),
            3: JCM.ColmapCamera(3, "OPENCV", 96, 64,
                                rng.uniform(-1, 300, 8))}
    for kind, jw, tw in (("images", JCM.write_images_binary,
                          TCM.write_images_binary),
                         ("cameras", JCM.write_cameras_binary,
                          TCM.write_cameras_binary)):
        obj = images if kind == "images" else cams
        a, b = str(tmp_path / f"j_{kind}.bin"), str(tmp_path / f"t_{kind}.bin")
        jw(obj, a)
        tw(obj, b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), kind
    got = TCM.read_images_binary(str(tmp_path / "t_images.bin"))
    assert sorted(got) == sorted(images)
    for i, img in images.items():
        g = got[i]
        assert g.name == img.name and g.camera_id == img.camera_id
        np.testing.assert_array_equal(g.qvec, img.qvec)
        np.testing.assert_array_equal(g.tvec, img.tvec)
        np.testing.assert_array_equal(g.xys.reshape(-1, 2), img.xys)
        np.testing.assert_array_equal(g.point3D_ids, img.point3D_ids)
    got = TCM.read_cameras_binary(str(tmp_path / "t_cameras.bin"))
    assert sorted(got) == sorted(cams)
    for i, cam in cams.items():
        assert (got[i].model, got[i].width, got[i].height) == (
            cam.model, cam.width, cam.height)
        np.testing.assert_array_equal(got[i].params, cam.params)


def test_triangulate_without_colmap(tmp_path, monkeypatch, capsys):
    """colmap off the PATH: both packages print the skip, return False
    and leave no ply and no workspace."""
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    assert not TC.have_binary("colmap")
    for name, mod in (("jax", JC), ("port", TC)):
        scene = tmp_path / name
        scene.mkdir()
        ply = str(scene / "points3d.ply")
        assert mod.triangulate_known_poses(
            str(scene), str(scene), ["1 PINHOLE 8 8 1 1 4 4"],
            ["1 1 0 0 0 0 0 0 1 a.png"], ply) is False
        assert not os.path.exists(ply)
        assert os.listdir(scene) == []
        assert "colmap binary not found" in capsys.readouterr().out


def test_do_system_and_have_binary(tmp_path):
    assert TC.have_binary("sh") == JC.have_binary("sh") is True
    TC.do_system("true")
    for mod in (JC, TC):
        with pytest.raises(RuntimeError, match="command failed"):
            mod.do_system("exit 3")


def test_video_frames_and_undistort_equal(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(12)
    video = str(tmp_path / "cam00.mp4")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                         (48, 32))
    for _ in range(5):
        vw.write(rng.integers(0, 255, (32, 48, 3), np.uint8))
    vw.release()
    outs = {}
    for name, mod in (("jax", JC), ("port", TC)):
        d = str(tmp_path / name)
        assert mod.extract_video_frames(video, d, "cam00", downscale=2,
                                        start=1, end=4) == 3
        outs[name] = {f: open(os.path.join(d, f), "rb").read()
                      for f in sorted(os.listdir(d))}
    assert list(outs["port"]) == ["cam00_0001.png", "cam00_0002.png",
                                  "cam00_0003.png"]
    assert outs["port"] == outs["jax"]
    K = np.array([[80.0, 0, 48], [0, 80.0, 32], [0, 0, 1]])
    dist = np.array([0.02, 0.002, 0.0, 0.0])
    assert np.array_equal(TC.compute_undistort_intrinsic(K, 64, 96, dist),
                          JC.compute_undistort_intrinsic(K, 64, 96, dist))


def test_rotmat2qvec_colmap_half_turn_fault():
    """A fault of the reference kept by the port: the trace formula of
    rotmat2qvec_colmap returns (5e-7, 0, 0, 0), not a unit quaternion, for
    the half turn R = diag(1, -1, -1) (a camera facing -z in the OpenCV
    convention, what neu3d2blender writes for an identity Blender pose);
    data/colmap.py's eigenvector rotmat2qvec gives (0, 1, 0, 0). Only the
    COLMAP triangulation path reads it."""
    R = np.diag([1.0, -1.0, -1.0])
    got = np.array(TC.rotmat2qvec_colmap(R))
    assert np.array_equal(got, np.array(JC.rotmat2qvec_colmap(R)))
    assert np.array_equal(got, [5e-7, 0, 0, 0])
    assert np.array_equal(TCM.rotmat2qvec(R), [0.0, 1.0, 0.0, 0.0])
