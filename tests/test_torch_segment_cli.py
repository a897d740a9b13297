"""The port's segmentation pipeline against the root CLIs:
python -m trase_tpu_torch.cluster -> trase_tpu_torch.render --segment_ids
--text_prompt_mask -> trase_tpu_torch.metrics_segmentation (all with
--device cpu), and cluster.py -> render.py -> metrics_segmentation.evaluate
on a copy of the same model directory (tests/test_render_cli.py::
test_full_segmentation_pipeline's scene plus a deform.pkl).

Tolerances: the same cluster ids; every stream's PNGs within one 8-bit
level (float sums that differ in the last bits round to neighbouring
levels), except where a threshold or a pixel index decides a pixel
(pred_masks, the background of segment_objects and of the text-prompt
objects, the point splats): there at most 0.5 % of a view's pixels may
differ by more; results.json within 1e-4."""
import json
import os
import shutil
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trase_tpu.data.synthetic import write_synthetic_dataset
from trase_tpu.models import deform as JD
from trase_tpu.models import gaussians as JG
from trase_tpu.models.gaussians_io import save_checkpoint, save_gaussian_ply
from trase_tpu.utils.sh import rgb_to_sh

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

torch.set_num_threads(2)

IT = 77
LEVELS = 1  # 8-bit levels
DECIDED_SHARE = 0.005  # of a view's pixels, where a threshold decides
DECIDED = ("pred_masks", "segment_objects", "text_prompt_blob1_mask_objects",
           "pointcloud", "gaussian_feats", "gaussian_clusters")
STREAMS = ("renders", "gt", "canonical", "rendered_feats", "segmentation") \
    + DECIDED
METRICS_TOL = 1e-4


class _Args:
    sh_degree = 1
    images = "images"
    resolution = -1
    white_background = False
    eval = True
    load2gpu_on_the_fly = False
    is_blender = True
    is_6dof = False
    load_mask_on_the_fly = False
    load_image_on_the_fly = False
    end_frame = -1
    mask_black_bg = False


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """Dataset, a snapshot with per-blob features, a deform.pkl with small
    deformations, the text-prompt mask (blob 1 in the first test view)
    and a Mask-Benchmark folder (blob 0 in each test view)."""
    from PIL import Image

    from trase_tpu.data.scene import Scene
    from trase_tpu.renderer import render

    base = tmp_path_factory.mktemp("segment")
    src, mdl = str(base / "data"), str(base / "model")
    scene = write_synthetic_dataset(src, n_train=2, n_test=2, image_size=48,
                                    n_blobs=3, pts_per_blob=32)
    n = scene["xyz"].shape[0]
    rng = np.random.default_rng(11)
    dirs = rng.normal(size=(3, JG.FEATURE_DIM)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    feats = dirs[scene["blob_id"]] + 0.05 * rng.normal(
        size=(n, JG.FEATURE_DIM)).astype(np.float32)
    params = JG.empty_params(capacity=n, sh_degree=1)._replace(
        xyz=jnp.asarray(scene["xyz"]),
        features_dc=jnp.asarray(rgb_to_sh(scene["rgb"]))[:, None, :],
        scaling=jnp.full((n, 3), np.log(scene["scale"])),
        rotation=jnp.zeros((n, 4)).at[:, 0].set(1.0),
        opacity=jnp.full((n, 1), 2.0),
        gaussian_features=jnp.asarray(feats))
    save_gaussian_ply(os.path.join(mdl, "point_cloud", f"iteration_{IT}",
                                   "point_cloud.ply"), params,
                      np.ones(n, bool))
    net = JD.make_deform_network("DeformNetwork", is_blender=True)
    v = jax.tree_util.tree_map(np.asarray,
                               JD.init_deform(jax.random.PRNGKey(0), net))
    for head in ("Dense_10", "Dense_11", "Dense_12"):  # small deformations
        v["params"][head]["kernel"] = v["params"][head]["kernel"] * 0.02
    save_checkpoint(os.path.join(mdl, "deform", f"iteration_{IT}",
                                 "deform.pkl"),
                    {"vars": v, "type": "DeformNetwork"})

    a = _Args()
    a.source_path, a.model_path = src, mdl
    sc = Scene(a, load_iteration=IT, shuffle=False)
    views = sc.get_test_cameras()

    capacity = sc.gaussian_params.xyz.shape[0]

    def coverage(view, blob):
        keep = jnp.zeros((capacity,), bool).at[:n].set(
            jnp.asarray(scene["blob_id"] == blob))
        out = render(view.to_render_camera(), sc.gaussian_params,
                     sc.gaussian_aux.alive, jnp.zeros(3), mask=keep,
                     with_features=False, backend="dense")
        return np.asarray(out["alpha"])[0] > 0.5

    mask2d = coverage(views[0], 1)
    assert mask2d.sum() > 10
    mask_png = str(base / "blob1_mask.png")
    Image.fromarray((mask2d * 255).astype(np.uint8)).save(mask_png)
    bench = base / "benchmark"
    for sub in ("gt_masks", "gt_masks_object"):
        os.makedirs(bench / sub)
    for i, view in enumerate(views):
        m = coverage(view, 0)
        Image.fromarray((m * 255).astype(np.uint8)).save(
            bench / "gt_masks" / f"{i:05d}.png")
        obj = np.asarray(view.image).transpose(1, 2, 0) * m[..., None]
        Image.fromarray((obj * 255).astype(np.uint8)).save(
            bench / "gt_masks_object" / f"{i:05d}.png")
    return scene, src, mdl, mask_png, str(bench), int(mask2d.sum())


def _pngs(folder):
    from PIL import Image

    out = {}
    for f in sorted(os.listdir(folder)):
        if f.endswith(".png"):
            with Image.open(folder + "/" + f) as im:
                out[f] = np.asarray(im, np.int16)
    return out


def test_segmentation_pipeline_matches_root_clis(pipeline, tmp_path):
    import cluster as j_cluster
    import metrics_segmentation as j_metrics
    import render as j_render
    from trase_tpu.cluster.clustering import load_clusters

    from trase_tpu_torch import metrics_segmentation as t_metrics
    from trase_tpu_torch import render as t_render
    from trase_tpu_torch.cluster import __main__ as t_cluster

    scene, src, mdl, mask_png, bench, mask_px = pipeline
    dirs, ids = {}, {}
    for name in ("jax", "port"):
        copy = str(tmp_path / name)
        shutil.copytree(mdl, copy)
        dirs[name] = copy
        dev = [] if name == "jax" else ["--device", "cpu"]
        (j_cluster if name == "jax" else t_cluster).main(
            ["-m", copy, "--sample_percent", "1.0"] + dev)
        ids[name], _ = load_clusters(os.path.join(
            copy, "point_cloud", f"iteration_{IT}", "clusters.pt"))
    np.testing.assert_array_equal(ids["port"], ids["jax"])
    blob0 = int(np.bincount(ids["jax"][scene["blob_id"] == 0]).argmax())

    for name, cli in (("jax", j_render), ("port", t_render)):
        dev = [] if name == "jax" else ["--device", "cpu"]
        cli.main(["-s", src, "-m", dirs[name], "--iteration", str(IT),
                  "--skip_train", "--sh_degree", "1", "--is_blender",
                  "--eval", "--segment_ids", str(blob0),
                  "--text_prompt_mask", mask_png,
                  "--threshold", str(max(int(mask_px * 0.2), 5)),
                  "--max_per_tile", "128", "--pairs_per_gaussian", "16"]
                 + dev)
    outs = {k: os.path.join(v, "test", f"ours_{IT}") for k, v in dirs.items()}
    for stream in STREAMS:
        a = _pngs(os.path.join(outs["jax"], stream))
        b = _pngs(os.path.join(outs["port"], stream))
        count = 1 if stream == "canonical" else 2
        assert sorted(a) == sorted(b) and len(b) == count, stream
        for f in a:
            far = np.abs(a[f] - b[f]).reshape(a[f].shape[0] * a[f].shape[1],
                                              -1).max(axis=1) > LEVELS
            allowed = (DECIDED_SHARE * far.size if stream in DECIDED else 0)
            assert far.sum() <= allowed, (stream, f, int(far.sum()))
    assert sorted(f for f in os.listdir(outs["port"]) if f.endswith(".mp4")) \
        == sorted(f for f in os.listdir(outs["jax"]) if f.endswith(".mp4"))
    # the selections are not empty: the object and the text prompt render
    assert _pngs(os.path.join(outs["port"], "pred_masks"))["00000.png"].any()
    assert _pngs(os.path.join(
        outs["port"], "text_prompt_blob1_mask_objects"))["00000.png"].any()

    j_metrics.evaluate([dirs["jax"]], False, bench)
    t_metrics.main(["-m", dirs["port"], "--benchmark_path", bench,
                    "--device", "cpu"])
    results = {}
    for name, d in dirs.items():
        with open(os.path.join(d, "results.json")) as f:
            results[name] = json.load(f)[f"ours_{IT}"]
    assert set(results["port"]) == set(results["jax"])
    assert results["port"]["LPIPS"] is None is results["jax"]["LPIPS"]
    for k in ("mIOU", "mACC", "SSIM", "PSNR"):
        assert abs(results["port"][k] - results["jax"][k]) <= METRICS_TOL, k
    assert 0.3 < results["port"]["mIOU"] <= 1.0  # the object was found
    with open(os.path.join(dirs["port"], "per_view.json")) as f:
        assert sorted(json.load(f)[f"ours_{IT}"]["IOU"]) == \
            ["00000.png", "00001.png"]


def test_lpips_with_weights_refuses(tmp_path):
    """LPIPS is not ported: asking for it raises instead of reporting a
    column that differs from trase_tpu's."""
    from trase_tpu_torch import metrics_segmentation as t_metrics

    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        t_metrics.evaluate([str(tmp_path)], False, str(tmp_path),
                           vgg_weights="vgg.pth", device="cpu")


def test_text_prompt_without_grounded_sam_warns(capsys):
    """--text_prompt prints trase_tpu's warning and, without a mask file,
    selects nothing."""
    from trase_tpu_torch import render as t_render

    class A:
        text_prompt = "a chair"
        text_prompt_mask = ""

    assert t_render._resolve_text_mask(A()) is None
    assert "Grounded-SAM unavailable" in capsys.readouterr().out


def test_kmeans_cli_matches_root(pipeline, tmp_path):
    """cluster --kmeans on both packages: clusters_kmeans.pt with the same
    ids (k = 3 on the three blobs' features)."""
    import cluster as j_cluster
    from trase_tpu.cluster.clustering import load_clusters

    from trase_tpu_torch.cluster import __main__ as t_cluster

    _, _, mdl, _, _, _ = pipeline
    got = {}
    for name, cli, dev in (("jax", j_cluster, []),
                           ("port", t_cluster, ["--device", "cpu"])):
        copy = str(tmp_path / name)
        shutil.copytree(mdl, copy)
        cli.main(["-m", copy, "--kmeans", "--k", "3"] + dev)
        got[name], _ = load_clusters(os.path.join(
            copy, "point_cloud", f"iteration_{IT}", "clusters_kmeans.pt"))
    np.testing.assert_array_equal(got["port"], got["jax"])
    assert len(np.unique(got["port"])) == 3
