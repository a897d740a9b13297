"""The port's synthetic dataset writer (trase_tpu_torch/data/synthetic.py)
against trase_tpu's at 32x32, both through the all-pairs oracle, on the
default (monocular) rig and on an n_times multi-view rig; and the port's
fast GT (the tiled compositor's plain version on the CPU) against its
oracle. Bounds: PNGs within one 8-bit level, masks differing on at most
0.5 % of pixels, transforms JSON and points3d.ply equal."""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from trase_tpu.data.synthetic import write_synthetic_dataset as j_write
from trase_tpu_torch.data import synthetic as TS
from trase_tpu_torch.data.masks import decode_mask_file

torch.set_num_threads(2)

PNG_LEVELS = 1
MASK_SHARE = 0.005
RIGS = {"monocular": dict(n_train=4, n_test=2),
        "n_times": dict(n_train=6, n_test=3, n_times=3)}


def _compare(a: str, b: str):
    """Both dataset directories hold the same views within the bounds;
    returns the number of views compared."""
    views = 0
    for split in ("train", "test"):
        with open(os.path.join(a, f"transforms_{split}.json")) as f:
            ja = json.load(f)
        with open(os.path.join(b, f"transforms_{split}.json")) as f:
            jb = json.load(f)
        assert ja == jb, split
        for frame in ja["frames"]:
            name = os.path.basename(frame["file_path"])
            ia = np.asarray(Image.open(os.path.join(a, "images",
                                                    f"{name}.png")), np.int32)
            ib = np.asarray(Image.open(os.path.join(b, "images",
                                                    f"{name}.png")), np.int32)
            assert ia.shape == ib.shape
            assert np.abs(ia - ib).max() <= PNG_LEVELS, name
            ma = decode_mask_file(os.path.join(a, "images", "masks",
                                               f"{name}.npz"))
            mb = decode_mask_file(os.path.join(b, "images", "masks",
                                               f"{name}.npz"))
            assert ma.shape == mb.shape and ma.any(), name
            assert (ma != mb).mean() <= MASK_SHARE, name
            views += 1
    with open(os.path.join(a, "points3d.ply"), "rb") as f:
        pa = f.read()
    with open(os.path.join(b, "points3d.ply"), "rb") as f:
        assert f.read() == pa
    return views


@pytest.mark.parametrize("rig", sorted(RIGS))
def test_writer_matches_trase_tpu(tmp_path, rig):
    kw = RIGS[rig]
    j_scene = j_write(str(tmp_path / "jax"), image_size=32, **kw)
    t_scene = TS.write_synthetic_dataset(str(tmp_path / "port"),
                                         image_size=32, device="cpu", **kw)
    for k in ("xyz", "rgb", "blob_id", "centers"):
        np.testing.assert_array_equal(t_scene[k], j_scene[k], err_msg=k)
    assert _compare(str(tmp_path / "jax"), str(tmp_path / "port")) == \
        kw["n_train"] + kw["n_test"]


@pytest.mark.parametrize("rig", sorted(RIGS))
def test_fast_gt_matches_oracle(tmp_path, rig):
    """fast_gt=True renders through rasterize_tiled (composite_inputs +
    composite; the blob one-hot padded to 32 features-only channels)."""
    kw = RIGS[rig]
    TS.write_synthetic_dataset(str(tmp_path / "oracle"), image_size=32,
                               device="cpu", **kw)
    TS.write_synthetic_dataset(str(tmp_path / "fast"), image_size=32,
                               fast_gt=True, device="cpu", **kw)
    assert _compare(str(tmp_path / "oracle"), str(tmp_path / "fast")) == \
        kw["n_train"] + kw["n_test"]


def test_fast_gt_blob_limit():
    """The fast GT composites the one-hot as 32 features: 33 blobs raise,
    32 render one mask each."""
    R, T = TS._look_at(np.array([0.0, 0.9, 3.0]), np.zeros(3))
    scene = TS.make_blob_scene(n_blobs=33, pts_per_blob=2)
    with pytest.raises(ValueError, match="at most 32 blobs"):
        TS.render_gt(scene, 0.0, R, T, 0.8, 0.8, 16, 16, fast=True,
                     device="cpu")
    scene = TS.make_blob_scene(n_blobs=32, pts_per_blob=2)
    img, masks = TS.render_gt(scene, 0.0, R, T, 0.8, 0.8, 16, 16, fast=True,
                              device="cpu")
    assert img.shape == (3, 16, 16) and masks.shape == (32, 16, 16)


def test_fast_gt_pair_budget_at_256():
    """At 256x256 a blob gaussian covers more than 8 tiles: trase_tpu's
    fast GT (RasterConfig()'s K = 8) drops tiles and lands far from its
    oracle; the port's sizes K to the largest tile rectangle and stays
    within 2 levels of its oracle (the tails the tiled compositor culls
    outside a gaussian's exact-support rect: chip_smoke.py's bound) and
    within the mask bound."""
    from trase_tpu.data import synthetic as JS

    scene = TS.make_blob_scene(3, 48, 0)
    R, T = TS._look_at(3.0 * np.array([1.0, 0.3, 0.0]), np.zeros(3))

    def levels(a, b):
        q = [(np.clip(x, 0, 1) * 255).astype(np.uint8).astype(int)
             for x in (a, b)]
        return int(np.abs(q[0] - q[1]).max())

    args = (scene, 0.5, R, T, 0.8, 0.8, 256, 256)
    ja, _ = JS.render_gt(*args, fast=False)
    jb, _ = JS.render_gt(*args, fast=True)
    assert levels(np.asarray(ja), np.asarray(jb)) > 8
    ta, ma = TS.render_gt(*args, fast=False, device="cpu")
    tb, mb = TS.render_gt(*args, fast=True, device="cpu")
    assert levels(ta, tb) <= 2
    assert (ma != mb).mean() <= MASK_SHARE
