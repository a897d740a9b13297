"""The scene, view, ground-truth and traffic generators repeat bit for
bit for a seed, give every seed the same sizes, and take seeds past 32
bits."""
import numpy as np
import pytest
import torch

from port_bench import harness as HB
from port_bench.scene import generate as SG
from tiny import tiny_context

SEEDS = [0, 7, 2 ** 31 + 11, 3 * 10 ** 9 + 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_scene_repeats_for_a_seed(seed):
    ctx = tiny_context("n3v-train-feature")
    cfg, dev = ctx.cfg, torch.device("cpu")
    a = SG.make_gaussians(cfg["scene"], cfg["capacity"], cfg["n_alive"],
                          cfg["sh_degree"], cfg["feature_dim"], seed, dev)
    b = SG.make_gaussians(cfg["scene"], cfg["capacity"], cfg["n_alive"],
                          cfg["sh_degree"], cfg["feature_dim"], seed, dev)
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    assert torch.equal(a[1], b[1]) and int(a[1].sum()) == cfg["n_alive"]
    wa = SG.make_deform_weights(cfg["deform"], seed, dev)
    wb = SG.make_deform_weights(cfg["deform"], seed, dev)
    assert all(torch.equal(x, y) for x, y in zip(wa, wb))
    assert [tuple(x.shape) for x in wa[0::2]] == SG.deform_shapes(
        cfg["deform"])


def test_seeds_differ_in_values_not_sizes():
    ctx = tiny_context("n3v-train-feature")
    cfg, dev = ctx.cfg, torch.device("cpu")
    a, _ = SG.make_gaussians(cfg["scene"], cfg["capacity"], cfg["n_alive"],
                             cfg["sh_degree"], cfg["feature_dim"], 1, dev)
    b, _ = SG.make_gaussians(cfg["scene"], cfg["capacity"], cfg["n_alive"],
                             cfg["sh_degree"], cfg["feature_dim"], 2, dev)
    assert {k: v.shape for k, v in a.items()} == \
        {k: v.shape for k, v in b.items()}
    assert not torch.equal(a["xyz"], b["xyz"])


@pytest.mark.parametrize("workload", ["n3v-train-feature",
                                      "hypernerf-train-gaussian"])
def test_views_and_ground_truth_repeat(workload):
    ctx = tiny_context(workload)
    cfg, tr = ctx.cfg, ctx.traffic
    v1, v2 = SG.make_views(cfg, tr), SG.make_views(cfg, tr)
    assert len(v1) == tr["cameras"] * tr["frames"]
    for x, y in zip(v1, v2):
        assert (x["R"] == y["R"]).all() and (x["T"] == y["T"]).all()
        assert x["fid"] == y["fid"]
    dev = torch.device("cpu")
    g = SG.make_gt(len(v1), cfg["image_height"], cfg["image_width"], 5, dev)
    assert torch.equal(g, SG.make_gt(len(v1), cfg["image_height"],
                                      cfg["image_width"], 5, dev))
    # one view regenerates alone, as the check regenerates it
    last = len(v1) - 1
    one = SG.make_gt(len(v1), cfg["image_height"], cfg["image_width"], 5,
                     dev, first=last, count=1)
    assert torch.equal(one[0], g[last])
    assert float(g.min()) >= 0.0 and float(g.max()) <= 1.0


def test_the_full_size_views_keep_the_published_layout():
    for w, n in (("n3v-train-feature", 160), ("hypernerf-train-gaussian",
                                              100)):
        wl = HB.load_json("workloads", w)
        cfg = HB.load_json("configs", wl["config"])
        views = SG.make_views(cfg, HB.load_json("traffic", wl["traffic"]))
        assert len(views) == n
        assert {(v["width"], v["height"]) for v in views} == {
            (cfg["image_width"], cfg["image_height"])}


def test_masks_repeat_and_regenerate_alone(tmp_path):
    ctx = tiny_context("n3v-train-feature")
    cfg, dev = ctx.cfg, torch.device("cpu")
    a = SG.make_masks(cfg["masks"], 48, 64, 9, 2, dev)
    assert torch.equal(a, SG.make_masks(cfg["masks"], 48, 64, 9, 2, dev))
    assert not torch.equal(a, SG.make_masks(cfg["masks"], 48, 64, 9, 3, dev))
    assert a.shape == (cfg["masks"]["per_view"], 48, 64)
    # packed on the device as np.packbits packs them, in the loader's format
    assert (SG.pack_masks(a) == np.packbits(a.reshape(-1).numpy())).all()
    path = str(tmp_path / "m.npz")
    SG.write_masks(path, SG.pack_masks(a), tuple(a.shape))
    from trase_tpu_torch.data.masks import decode_mask_file, load_padded_masks

    assert (decode_mask_file(path) == a.numpy()).all()
    padded = load_padded_masks(path, a.shape[0] + 2)
    assert (padded.masks[:a.shape[0]] == a.numpy()).all()
    assert padded.valid.tolist() == [True] * a.shape[0] + [False, False]
