"""Port parity for the viewer: trase_tpu_torch.viewer.HeadlessViewer on the
CPU (the compositor's plain version) against trase_tpu.viewer.HeadlessViewer
(Pallas backend in interpret mode) on one model directory written with
trase_tpu's writers (tests/test_viewer.py's three-blob scene, plus a
deform.pkl and a clusters.pt): the orbit camera and its render buffers,
every mode's frame, click and mask selection, removal, the saved object,
composition, farthest-point sampling, the polyline overlay in both of its
branches, the trajectory frames, the CLI's script mode and the web server.

Tolerances: frames within tests/test_torch_render.py's TOL (the same
weights, float sums associated differently); the Render mode's display
image is the uint8 truncation of the render, so there a difference of
TOL can move a value by one level: the underlying float render is held
to TOL and the display image to one level."""
import io
import json
import os
import sys
import urllib.error
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trase_tpu import cam_utils as JC
from trase_tpu import viewer as JV
from trase_tpu.cluster.clustering import save_clusters
from trase_tpu.data.synthetic import make_blob_scene
from trase_tpu.models import deform as JD
from trase_tpu.models import gaussians as JG
from trase_tpu.models.gaussians_io import save_checkpoint, save_gaussian_ply
from trase_tpu.utils.sh import rgb_to_sh
from trase_tpu.viz import draw_polylines as j_draw_polylines

from trase_tpu_torch import cam_utils as TC
from trase_tpu_torch import viewer as TV
from trase_tpu_torch.models import deform as TD
from trase_tpu_torch.models.gaussians_io import load_gaussian_ply
from trase_tpu_torch.viz import draw_polylines as t_draw_polylines

torch.set_num_threads(2)

IT, SIZE, RADIUS = 100, 64, 3.0
TOL = {"render": 2e-4, "depth": 2e-3}  # tests/test_torch_render.py's
LEVEL = 1.0 / 255.0 + 1e-6  # one step of the uint8 display image


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """tests/test_viewer.py:_make_model_dir's three blobs with per-blob
    feature directions, SH degree 1, plus small deformations (the heads of
    a seeded DeformNetwork scaled by 0.05) and clusters.pt = the blob ids."""
    tmp = str(tmp_path_factory.mktemp("torch_viewer_model"))
    n_blobs = 3
    scene = make_blob_scene(n_blobs, 96, 0)
    n = scene["xyz"].shape[0]
    rng = np.random.default_rng(7)
    dirs = rng.normal(size=(n_blobs, JG.FEATURE_DIM)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    feats = dirs[scene["blob_id"]] + 0.05 * rng.normal(
        size=(n, JG.FEATURE_DIM)).astype(np.float32)
    params = JG.empty_params(capacity=n, sh_degree=1)
    params = params._replace(
        xyz=jnp.asarray(scene["xyz"]),
        features_dc=jnp.asarray(rgb_to_sh(scene["rgb"]))[:, None, :],
        scaling=jnp.full((n, 3), np.log(scene["scale"])),
        rotation=jnp.zeros((n, 4)).at[:, 0].set(1.0),
        opacity=jnp.full((n, 1), 2.0),
        gaussian_features=jnp.asarray(feats))
    it_dir = os.path.join(tmp, "point_cloud", f"iteration_{IT}")
    save_gaussian_ply(os.path.join(it_dir, "point_cloud.ply"), params,
                      np.ones(n, bool))
    net = JD.make_deform_network("DeformNetwork")
    v = jax.tree_util.tree_map(np.asarray,
                               JD.init_deform(jax.random.PRNGKey(0), net))
    for head in ("Dense_8", "Dense_9", "Dense_10"):
        v["params"][head]["kernel"] = v["params"][head]["kernel"] * 0.05
    save_checkpoint(os.path.join(tmp, "deform", f"iteration_{IT}",
                                 "deform.pkl"),
                    {"vars": v, "type": "DeformNetwork"})
    palette = np.array([[0.9, 0.1, 0.1], [0.1, 0.9, 0.1], [0.1, 0.1, 0.9]],
                       np.float32)
    save_clusters(os.path.join(it_dir, "clusters.pt"),
                  scene["blob_id"].astype(np.int64),
                  palette[scene["blob_id"]])
    return scene, tmp


@pytest.fixture(scope="module")
def viewers(model_dir):
    """One viewer of each package on the model directory; each test
    resets their state first (trase_tpu's viewer keeps its compiled frame
    functions, so it is built once)."""
    _, mdir = model_dir
    kw = dict(sh_degree=1, W=SIZE, H=SIZE, radius=RADIUS)
    return (JV.HeadlessViewer.from_model_path(
                mdir, backend="pallas_interpret", **kw),
            TV.HeadlessViewer.from_model_path(mdir, device="cpu", **kw))


def reset(*vs, fid=0.3):
    for v in vs:
        v.cam = type(v.cam)(SIZE, SIZE, r=RADIUS, fovy=60.0)
        v.fid = fid
        v.mode = "Render"
        v.clear_selection()
        v.score_threshold = 0.8
        v.show_trajectory = False
        v._traj = None
        v._pca_rgb = None


def pixel_of(v, point):
    """The pixel a world point projects to (tests/test_viewer.py's)."""
    p = np.array([*point, 1.0], np.float32) @ np.asarray(
        v._render_camera().buffers.full_proj)
    return (((p[0] / p[3] + 1) * v.W - 1) * 0.5,
            ((p[1] / p[3] + 1) * v.H - 1) * 0.5)


def test_loads_the_same_model(viewers):
    jv, tv = viewers
    assert tv.n == jv.n and tv.loaded_iter == jv.loaded_iter == IT
    assert tv.sh_degree == jv.sh_degree == 1
    assert tv.deform_net is not None
    np.testing.assert_array_equal(tv.cluster_ids, jv.cluster_ids)
    np.testing.assert_array_equal(tv.cluster_rgb, jv.cluster_rgb)
    np.testing.assert_array_equal(tv.params.xyz.numpy(),
                                  np.asarray(jv.params.xyz))
    # the float32 deform module against trase_tpu's flax apply
    for a, b in zip(tv._deform(0.4), jv._deform(0.4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


MOVES = {
    "orbit": [("orbit", 400.0, 0.0), ("orbit", -37.5, 120.0)],
    "scale": [("scale", 1.0), ("scale", -2.5)],
    "pan": [("pan", 10.0, 10.0), ("pan", -300.0, 45.0)],
    "all": [("orbit", 400.0, 30.0), ("scale", 1.0), ("pan", 10.0, 10.0),
            ("orbit", -90.0, -15.0)],
}


@pytest.mark.parametrize("moves", list(MOVES))
def test_orbit_camera_and_buffers_equal(moves):
    """OrbitCamera poses after orbit / scale / pan and the render camera
    built from them: equal bit for bit."""
    jc, tc = JC.OrbitCamera(96, 72, r=2.5), TC.OrbitCamera(96, 72, r=2.5)
    for name, *args in MOVES[moves]:
        getattr(jc, name)(*args)
        getattr(tc, name)(*args)
        np.testing.assert_array_equal(tc.pose, jc.pose)
    np.testing.assert_array_equal(tc.view, jc.view)
    assert tc.fovx == jc.fovx
    jr = JC.pose_to_render_camera(jc.pose, 96, 72, jc.fovx, jc.fovy)
    tr = TC.pose_to_render_camera(tc.pose, 96, 72, tc.fovx, tc.fovy,
                                  device="cpu")
    assert (tr.image_height, tr.image_width) == (72, 96)
    for f in tr.buffers._fields:
        np.testing.assert_array_equal(getattr(tr.buffers, f).numpy(),
                                      np.asarray(getattr(jr.buffers, f)),
                                      err_msg=f)


def check_frame(mode, got, ref):
    assert got.shape == ref.shape == (3, SIZE, SIZE), mode
    assert got.dtype == np.float32
    tol = {"Render": LEVEL, "Depth": TOL["depth"]}.get(mode, TOL["render"])
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0, err_msg=mode)


@pytest.mark.parametrize("mode", TV.MODES)
def test_mode_frames(viewers, mode):
    """Every mode at a deformed time and a moved camera; the PCA colours
    of the two feature modes are trase_tpu's (PCA is defined up to the
    sign of each component)."""
    jv, tv = viewers
    reset(jv, tv)
    for v in (jv, tv):
        v.cam.orbit(60.0, 20.0)
    tv._pca_rgb = jv._pca()
    ref = jv.render_frame(mode)
    got = tv.render_frame(mode)
    check_frame(mode, got, ref)
    assert tv.last_frame_ms > 0 and np.isfinite(got).all()
    if mode == "Render":
        jo, _ = jv._raw_frame()
        to, _ = tv._raw_frame()
        np.testing.assert_allclose(to["render"].numpy(),
                                   np.asarray(jo["render"]),
                                   atol=TOL["render"], rtol=0)
        assert to["render_u8"].dtype == torch.uint8
        assert tuple(to["render_u8"].shape) == (SIZE, SIZE, 3)


def test_text_prompt_without_mask_raises(viewers):
    _, tv = viewers
    with pytest.raises(NotImplementedError, match="Grounded-SAM"):
        tv.text_select("the red blob")


@pytest.mark.parametrize("blob", [0, 1, 2])
def test_click_select_and_removal(model_dir, viewers, blob):
    """The pixel over each blob's centre: the same cluster id and the
    same selection mask; then the removal frames agree."""
    scene, _ = model_dir
    jv, tv = viewers
    reset(jv, tv)
    px, py = pixel_of(tv, scene["centers"][blob])
    assert pixel_of(jv, scene["centers"][blob]) == (px, py)
    jid, tid = jv.click_select(px, py), tv.click_select(px, py)
    assert tid == jid and tid is not None
    assert tv.selected_clusters == jv.selected_clusters == [tid]
    np.testing.assert_array_equal(tv.segmented_mask.numpy(),
                                  np.asarray(jv.segmented_mask))
    assert tv.segmented_mask[:tv.n].numpy()[scene["blob_id"] == blob].mean() \
        > 0.8
    for mode in ("Render", "Segmentation"):
        check_frame(mode, tv.render_frame(mode, apply_selection_removal=True),
                    jv.render_frame(mode, apply_selection_removal=True))
    # off-geometry: a corner pixel selects nothing in both
    assert jv.click_select(0, 0) is None and tv.click_select(0, 0) is None


def test_text_select_with_mask(model_dir, viewers):
    scene, _ = model_dir
    jv, tv = viewers
    reset(jv, tv)
    blob1 = jnp.zeros((jv.params.xyz.shape[0],), bool).at[:jv.n].set(
        jnp.asarray(scene["blob_id"] == 1))
    out, _ = jv._raw_frame(mask=blob1)
    mask2d = np.asarray(out["alpha"])[0] > 0.5
    assert mask2d.sum() > 20
    thr = int(mask2d.sum() * 0.3)
    jids = jv.text_select(mask2d=mask2d, threshold=thr)
    tids = tv.text_select(mask2d=mask2d, threshold=thr)
    assert tids == jids and len(tids) >= 1
    np.testing.assert_array_equal(tv.segmented_mask.numpy(),
                                  np.asarray(jv.segmented_mask))
    # the score threshold's post-filter, recomputed in both
    for v in (jv, tv):
        v.score_threshold = 0.99
        v._recompute_mask()
    np.testing.assert_array_equal(tv.segmented_mask.numpy(),
                                  np.asarray(jv.segmented_mask))


def jit_render_composite(monkeypatch):
    """trase_tpu's viewer calls render_composite outside jit, which the
    Pallas interpreter runs op by op; the same function under jit."""
    import trase_tpu.renderer as JR

    fn = JR.render_composite

    def jitted(camera, *args, **kw):
        H, W = camera.image_height, camera.image_width
        return jax.jit(lambda buffers, *a: fn(
            JR.RenderCamera(buffers, H, W), *a, **kw))(camera.buffers, *args)

    monkeypatch.setattr(JR, "render_composite", jitted)


def test_save_object_and_composite(model_dir, viewers, tmp_path,
                                   monkeypatch):
    """save_object / save_without_object write the same gaussians; the
    extracted object composited back (rescaled, rotated, moved, deformed)
    gives the same frame."""
    scene, _ = model_dir
    jv, tv = viewers
    reset(jv, tv)
    jit_render_composite(monkeypatch)
    for v in (jv, tv):
        v.select_clusters([0])
    paths = {}
    for pkg, v in (("j", jv), ("t", tv)):
        paths[pkg] = (v.save_object(str(tmp_path / f"{pkg}_obj.ply")),
                      v.save_without_object(str(tmp_path / f"{pkg}_rest.ply")))
    for j_path, t_path in zip(*paths.values()):
        jp, _, jn, _ = load_gaussian_ply(j_path, sh_degree=1, device="cpu")
        tp, _, tn, _ = load_gaussian_ply(t_path, sh_degree=1, device="cpu")
        assert tn == jn > 0
        for f in tp._fields:
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          getattr(jp, f).numpy(), err_msg=f)
    n_obj = int((scene["blob_id"] == 0).sum())
    assert jv.load_object(paths["j"][0]) == tv.load_object(paths["t"][0])
    assert tv.object_n <= n_obj
    edit = dict(scales_bias=1.3, motion_bias=(0.5, -0.2, 0.1),
                rotation_bias=(0.3, -0.7, 1.1))
    ref = jv.render_composite_frame(**edit)
    got = tv.render_composite_frame(**edit)
    np.testing.assert_allclose(got, np.asarray(ref), atol=TOL["render"],
                               rtol=0)
    assert np.abs(got - tv.render_frame("Render")).max() > 0.05
    assert tv.last_frame_ms > 0


@pytest.mark.parametrize("n,m", [(1, 1), (57, 20), (288, 64)])
def test_farthest_point_sample(n, m):
    """trase_tpu's start index (jax.random.randint from PRNGKey(0), as
    its viewer draws it) injected: the same indices."""
    pts = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    ref = np.asarray(JD.farthest_point_sample(key, jnp.asarray(pts), m))
    start = int(jax.random.randint(key, (), 0, n))
    got = TD.farthest_point_sample(torch.tensor(pts), m, start=start)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    # drawn from a generator: reproducible, and distinct while m <= n
    a = TD.farthest_point_sample(torch.tensor(pts), m,
                                 generator=torch.Generator().manual_seed(3))
    b = TD.farthest_point_sample(torch.tensor(pts), m,
                                 generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and len(set(a.tolist())) == m


@pytest.mark.parametrize("branch", ["cv2", "fallback"])
def test_draw_polylines(monkeypatch, branch):
    """Both packages' overlays, equal pixel for pixel in each branch:
    cv2's line rasterizer, and the numpy fallback with cv2 hidden."""
    if branch == "cv2":
        pytest.importorskip("cv2")
    else:
        monkeypatch.setitem(sys.modules, "cv2", None)
    rng = np.random.default_rng(4)
    tracks = rng.uniform(-20, 90, size=(6, 9, 2)).astype(np.float32)
    tracks[2, 3] = (1e9, -1e9)  # clipped wild coordinate
    colors = rng.uniform(size=(9, 3)).astype(np.float32)
    valid = rng.uniform(size=(6, 9)) > 0.15
    for thickness, v in ((1, None), (2, valid)):
        jr, ja = j_draw_polylines(48, 64, tracks, colors, thickness, valid=v)
        tr, ta = t_draw_polylines(48, 64, tracks, colors, thickness, valid=v)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(ta, ja)
        assert ta.sum() > 0
    r, a = t_draw_polylines(48, 64, tracks[:1], colors)
    assert not r.any() and not a.any()


def test_trajectory_frames(model_dir, viewers, monkeypatch):
    """The overlay over a selection, frames at changing times and views:
    trase_tpu's FPS start index injected, the same tracked gaussians and
    the same frames."""
    jv, tv = viewers
    reset(jv, tv)
    fps = TD.farthest_point_sample

    def injected(pts, m, generator=None, start=None):
        start = int(jax.random.randint(jax.random.PRNGKey(0), (), 0,
                                       pts.shape[0]))
        return fps(pts, m, start=start)

    monkeypatch.setattr(TD, "farthest_point_sample", injected)
    for v in (jv, tv):
        v.select_clusters([1])
        assert v.toggle_trajectory(samp_num=4, gs_num=24)
    first = tv.render_frame("Render")
    jv.render_frame("Render")
    np.testing.assert_array_equal(tv._traj["ids"], jv._traj["ids"])
    drew = False
    for step in range(5):
        for v in (jv, tv):
            v.fid = 0.1 + 0.2 * step
            v.cam.orbit(25.0, 10.0)
        mode = "Point Cloud" if step == 2 else "Render"
        ref, got = jv.render_frame(mode), tv.render_frame(mode)
        check_frame(mode, got, ref)
        drew |= bool(np.abs(got - first).max() > 0)
    assert drew and len(tv._traj["history"]) == 4 == len(jv._traj["history"])
    assert not tv.toggle_trajectory(on=False) and tv._traj is None


def test_cli_script(model_dir, tmp_path):
    """The port's viewer CLI in script mode: tests/test_viewer.py's script
    writes two frames; then every command once."""
    _, mdir = model_dir
    script = tmp_path / "cmds.txt"
    script.write_text(
        "mode Render\nrender\norbit 100 50\nzoom 1\nrender Depth\nfps\n"
        "quit\n")
    out_dir = tmp_path / "frames"
    TV.main(["-m", mdir, "--W", "64", "--H", "64", "--script", str(script),
             "--out", str(out_dir), "--device", "cpu"])
    assert len(sorted(os.listdir(out_dir))) == 2

    from PIL import Image

    mask = np.zeros((64, 64), np.uint8)
    mask[20:44, 20:44] = 255
    Image.fromarray(mask).save(tmp_path / "mask.png")
    obj = tmp_path / "obj.ply"
    script.write_text("\n".join([
        "# every command", "time 0.5", "pan 3 -2", "mode Segmentation",
        "render", "cluster kmeans 3", "click 32 32", "threshold 0.7",
        "remove", f"save_object {obj}", f"save_rest {tmp_path / 'rest.ply'}",
        f"load_object {obj}", "compose 1.2 0.3 0 0 0 0.5 0",
        "trajectory 4 16", "render", "render", "trajectory",
        f"textmask {tmp_path / 'mask.png'}", "text a blob", "clear",
        "bogus", "render Gaussian Clusters"]) + "\n")
    out2 = tmp_path / "frames2"
    TV.main(["-m", mdir, "--W", "64", "--H", "64", "--script", str(script),
             "--out", str(out2), "--device", "cpu", "--radius", "3.0"])
    assert len(os.listdir(out2)) == 6
    assert obj.exists() and (tmp_path / "rest.ply").exists()
    assert os.path.exists(os.path.join(
        mdir, "point_cloud", f"iteration_{IT}", "clusters_kmeans.pt"))


def test_web_viewer_server(model_dir):
    """The browser GUI over a loopback server (tests/test_viewer.py's
    test_web_viewer_server on the port): page, modes, JPEG frames equal
    to a JPEG of render_frame at the same state, the command surface."""
    from PIL import Image

    from trase_tpu_torch.viewer_web import ViewerServer

    scene, mdir = model_dir
    v = TV.HeadlessViewer.from_model_path(mdir, sh_degree=1, W=96, H=96,
                                          radius=3.0, device="cpu")
    srv = ViewerServer(v)
    port = srv.serve(port=0, block=False)
    base = f"http://127.0.0.1:{port}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.headers.get_content_type(), r.read()

    def cmd(**body):
        req = urllib.request.Request(
            base + "/cmd", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    def decoded(frame):
        return np.asarray(Image.open(io.BytesIO(frame)), np.float32)

    def same_as_render_frame(frame):
        img = v.render_frame(apply_selection_removal=srv.removal)
        arr = (np.clip(img.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=90)
        np.testing.assert_array_equal(decoded(frame),
                                      decoded(buf.getvalue()))

    try:
        ctype, page = get("/")
        assert ctype == "text/html" and b"trase_tpu_torch viewer" in page
        assert json.loads(get("/modes")[1]) == list(TV.MODES)
        ctype, frame = get("/frame.jpg")
        assert ctype == "image/jpeg"
        assert Image.open(io.BytesIO(frame)).size == (96, 96)
        same_as_render_frame(frame)
        base_px = decoded(frame)

        assert cmd(cmd="orbit", dx=40, dy=0)["ok"]
        cmd(cmd="zoom", delta=1)
        cmd(cmd="pan", dx=5, dy=-5)
        cmd(cmd="time", fid=0.4)
        assert cmd(cmd="mode", name="Depth")["mode"] == "Depth"
        _, dframe = get("/frame.jpg")
        same_as_render_frame(dframe)
        assert np.abs(decoded(dframe) - base_px).max() > 1
        cmd(cmd="mode", name="Render")

        px, py = pixel_of(v, scene["centers"][0])
        st = cmd(cmd="click", px=float(px), py=float(py))
        assert st["selected"] == [int(v.selected_clusters[0])], st
        st = cmd(cmd="removal", on=True)
        assert st["removal"] is True
        _, removed = get("/frame.jpg")
        same_as_render_frame(removed)
        st = cmd(cmd="threshold", value=0.9)
        assert st["threshold"] == 0.9
        st = cmd(cmd="clear")
        assert st["selected"] == [] and st["removal"] is False

        assert cmd(cmd="trajectory", on=True)["ok"]
        cmd(cmd="orbit", dx=30, dy=10)
        _, tframe = get("/frame.jpg")
        assert Image.open(io.BytesIO(tframe)).size == (96, 96)
        assert cmd(cmd="trajectory", on=False)["ok"]
        assert cmd(cmd="cluster", kmeans=True, k=3)["n_clusters"] == 3
        st = json.loads(get("/state")[1])
        assert st["mode"] == "Render" and st["ms"] > 0

        for bad in ({"cmd": "definitely_not_a_command"},
                    {"cmd": "text", "prompt": "a blob"}):
            with pytest.raises(urllib.error.HTTPError) as e:
                cmd(**bad)
            assert e.value.code == 500
            assert "error" in json.loads(e.value.read())
        with pytest.raises(urllib.error.HTTPError) as e:
            get("/nope")
        assert e.value.code == 404
    finally:
        srv.shutdown()
