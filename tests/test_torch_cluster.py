"""Port parity for clustering (trase_tpu_torch/cluster): the port's
mirror of tests/test_cluster.py, and the port against trase_tpu's
clustering on the same numpy-seeded features: HDBSCAN ids equal, k-means
ids equal and centers within 1e-5 (float32 sums in another order),
postprocessing and seg_score_assign within 1e-6, and a clusters.pt
written by either package read by the other."""
import numpy as np
import pytest
import torch

from trase_tpu.cluster import clustering as JC
from trase_tpu_torch.cluster import clustering as TC

torch.set_num_threads(2)


def _blobby_features(n_per=200, k=4, dim=32, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, dim)) * 3
    feats, labels = [], []
    for i, c in enumerate(centers):
        feats.append(c + rng.normal(0, 0.05, size=(n_per, dim)))
        labels.append(np.full(n_per, i))
    return (np.concatenate(feats).astype(np.float32),
            np.concatenate(labels))


def _purity(pred, true):
    total = 0
    for p in np.unique(pred):
        _, counts = np.unique(true[pred == p], return_counts=True)
        total += counts.max()
    return total / len(true)


def test_hdbscan_recovers_blobs():
    feats, true = _blobby_features()
    ids, rgb, centers, k = TC.hdbscan_cluster(feats, sample_percent=1.0)
    assert ids.shape == (len(feats),) and rgb.shape == (len(feats), 3)
    assert centers.shape == (k, 32)
    assert _purity(ids, true) > 0.95


def test_kmeans_recovers_blobs():
    feats, true = _blobby_features()
    ids, rgb, centers = TC.kmeans_cluster(feats, k=4, iters=30, device="cpu")
    assert _purity(ids, true) > 0.95
    assert centers.shape == (4, 32) and rgb.shape == (len(feats), 3)


def test_postprocessing_threshold():
    feats, true = _blobby_features(n_per=50)
    mask = TC.postprocessing(feats, feats[true == 2].mean(axis=0),
                             score_threshold=0.9)
    assert mask[true == 2].all()
    assert not mask[true != 2].any()


@pytest.mark.parametrize("sample_percent", [1.0, 0.3])
def test_hdbscan_matches_trase_tpu(sample_percent):
    """The same subsample draws, labels, centers and assignment."""
    feats, _ = _blobby_features(n_per=120, k=5, seed=3)
    a = JC.hdbscan_cluster(feats, sample_percent=sample_percent, seed=2)
    b = TC.hdbscan_cluster(feats, sample_percent=sample_percent, seed=2)
    np.testing.assert_array_equal(b[0], a[0])
    np.testing.assert_array_equal(b[1], a[1])
    np.testing.assert_array_equal(b[2], a[2])
    assert b[3] == a[3]


@pytest.mark.parametrize("k,iters", [(4, 30), (6, 12)])
def test_kmeans_matches_trase_tpu(k, iters):
    """The same k-means++ draws and Lloyd steps on k blobs: ids equal,
    centers within 1e-5 (the member sums associate differently). With
    more centers than blobs, points midway between two centers of one
    blob could go either way on float rounding."""
    feats, _ = _blobby_features(k=k, seed=1)
    ja = JC.kmeans_cluster(feats, k=k, iters=iters, seed=5)
    tb = TC.kmeans_cluster(feats, k=k, iters=iters, seed=5, device="cpu")
    np.testing.assert_array_equal(tb[0], ja[0])
    np.testing.assert_array_equal(tb[1], ja[1])
    np.testing.assert_allclose(tb[2], np.asarray(ja[2]), atol=1e-5, rtol=0)


def test_scores_match_trase_tpu():
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(300, 32)).astype(np.float32)
    centers = TC._normalize(rng.normal(size=(6, 32))).astype(np.float32)
    np.testing.assert_allclose(TC.seg_score_assign(feats, centers),
                               JC.seg_score_assign(feats, centers),
                               atol=1e-6, rtol=0)
    for th in (0.0, 0.2):
        np.testing.assert_array_equal(
            TC.postprocessing(feats, feats[3], th),
            JC.postprocessing(feats, feats[3], th))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cluster_files_cross_read(writer, tmp_path):
    """clusters.pt as either package writes it loads in both, in the
    reference's {"id", "rgb"} layout."""
    ids = np.arange(10, dtype=np.int64)
    rgb = np.random.default_rng(0).random((10, 3)).astype(np.float32)
    p = str(tmp_path / "clusters.pt")
    (TC if writer == "port" else JC).save_clusters(p, ids, rgb)
    for mod in (TC, JC):
        got_ids, got_rgb = mod.load_clusters(p)
        np.testing.assert_array_equal(got_ids, ids)
        np.testing.assert_array_equal(got_rgb, rgb)
    obj = torch.load(p, map_location="cpu", weights_only=True)
    assert set(obj.keys()) == {"id", "rgb"}
