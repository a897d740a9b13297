"""Unsupervised object clustering of the 32-dim gaussian feature field.

Counterpart of trase_tpu/cluster/clustering.py (reference gui.py:248-319
and the query-time refinement of gui.py:456-464, render.py:97-104):

- ``hdbscan_cluster``: L2-normalize the features, subsample 2 % with the
  same ``default_rng(seed)`` draws, HDBSCAN on the host (sklearn), one
  normalized center per label (noise included), then every gaussian
  assigned to its best center by cosine (``seg_score_assign``);
- ``kmeans_cluster``: the same k-means++ init in numpy (the same RNG
  calls), then Lloyd iterations in torch, float32, on `device`;
- ``postprocessing``: cosine of every feature against a query, thresholded;
- ``save_clusters`` / ``load_clusters``: the {"id", "rgb"} torch file
  (clusters.pt, clusters_kmeans.pt) both packages read and write.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device

# the reference colors labels with a fixed random palette (gui.py:170)
_PALETTE = np.random.default_rng(0).random((1000, 3))


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)


def seg_score_assign(features: np.ndarray,
                     centers: np.ndarray) -> np.ndarray:
    """Cosine score of every gaussian against every cluster center
    (gui.py:288: einsum('nc,bc->bn')). Returns (N, K) scores; numpy on
    the host, as the clustering tools run there."""
    f = np.asarray(_normalize(features), np.float32)
    c = np.asarray(centers, np.float32)
    return f @ c.T


def hdbscan_cluster(features: np.ndarray, sample_percent: float = 0.02,
                    min_cluster_size: int = 10,
                    cluster_selection_epsilon: float = 0.01, seed: int = 0,
                    min_samples: int | None = None):
    """HDBSCAN on a subsample + cosine assignment of all gaussians.

    Returns (ids (N,), rgb (N,3), centers (K,32), n_clusters)."""
    from sklearn.cluster import HDBSCAN

    rng = np.random.default_rng(seed)
    normed = _normalize(features)
    keep = rng.random(features.shape[0]) > (1 - sample_percent)
    if keep.sum() < max(min_cluster_size * 2, 32):
        keep = np.ones(features.shape[0], bool)  # tiny scenes: use all
    sampled = _normalize(features[keep])

    labels = HDBSCAN(min_cluster_size=min_cluster_size,
                     cluster_selection_epsilon=cluster_selection_epsilon,
                     min_samples=min_samples, n_jobs=-1).fit_predict(
                         sampled.astype(np.float64))
    uniq = np.unique(labels)  # sorted; -1 (noise) first when present
    k = len(uniq)
    # one center per sorted label: the reference's center loop
    # (gui.py:285-287) when noise is present, without dropping the last
    # cluster when it is not
    centers = np.zeros((k, sampled.shape[-1]), np.float32)
    for i, lab in enumerate(uniq):
        members = sampled[labels == lab]
        if len(members):
            centers[i] = _normalize(members.mean(axis=0))

    ids = seg_score_assign(normed, centers).argmax(axis=-1).astype(np.int64)
    return ids, _PALETTE[ids].astype(np.float32), centers, k


def kmeans_init(x: np.ndarray, k: int, seed: int) -> np.ndarray:
    """k-means++ (greedy D^2 sampling) on normalized float32 rows, with
    trase_tpu's RNG calls in its order: (k, F) float32 centers."""
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    centers = [x[rng.integers(n)]]
    d2_min = np.full(n, np.inf, np.float32)
    for _ in range(k - 1):
        d2_min = np.minimum(d2_min, ((x - centers[-1]) ** 2).sum(axis=1))
        probs = d2_min / max(d2_min.sum(), 1e-12)
        centers.append(x[rng.choice(n, p=probs)])
    return np.stack(centers)


def lloyd(x: torch.Tensor, centers: torch.Tensor, iters: int):
    """`iters` Lloyd steps (float32, TF32 off): assign each row to its
    nearest center by ||x||^2 - 2 x.c + ||c||^2, then move each center to
    its members' mean (an empty cluster keeps its center). Returns
    (centers (k, F), assignment (N,) int64 of the last step)."""
    k = centers.shape[0]
    xx = (x * x).sum(dim=1, keepdim=True)
    assign = None
    for _ in range(iters):
        d2 = xx - 2.0 * (x @ centers.T) + (centers * centers).sum(dim=1)[None]
        assign = torch.argmin(d2, dim=1)
        sums = torch.zeros_like(centers).index_add_(0, assign, x)
        counts = torch.bincount(assign, minlength=k).to(x.dtype)[:, None]
        centers = torch.where(counts > 0, sums / torch.clamp(counts, min=1),
                              centers)
    return centers, assign


def kmeans_cluster(features: np.ndarray, k: int = 64, iters: int = 50,
                   seed: int = 0, device="cuda"):
    """Lloyd k-means on normalized features: the k-means++ init on the
    host, the iterations on `device`.

    Returns (ids (N,), rgb (N,3), centers (k,32))."""
    dev = resolve_device(device)
    xn = np.asarray(_normalize(features), np.float32)
    init = kmeans_init(xn, k, seed)
    x = torch.from_numpy(xn).to(dev)
    centers, assign = lloyd(x, torch.from_numpy(init).to(dev), iters)
    ids = assign.cpu().numpy().astype(np.int64)
    return ids, _PALETTE[ids].astype(np.float32), centers.cpu().numpy()


def postprocessing(features: np.ndarray, query_feature: np.ndarray,
                   score_threshold: float = 0.8) -> np.ndarray:
    """Cosine-threshold refinement (render.py:97-104). Returns bool (N,)."""
    f = _normalize(np.asarray(features, np.float32))
    q = _normalize(np.asarray(query_feature, np.float32).reshape(-1))
    return f @ q >= score_threshold


def save_clusters(path: str, ids: np.ndarray, rgb: np.ndarray):
    """clusters.pt layout: {"id": (N,) int tensor, "rgb": (N,3)}."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"id": torch.from_numpy(np.asarray(ids)),
                "rgb": torch.from_numpy(np.asarray(rgb))}, path)


def load_clusters(path: str):
    """Returns (ids (N,), rgb (N,3)) from clusters.pt, or from the
    <path>.npz trase_tpu writes where torch is missing."""
    if os.path.exists(path):
        obj = torch.load(path, map_location="cpu", weights_only=True)
        return (np.asarray(obj["id"]).reshape(-1), np.asarray(obj["rgb"]))
    z = np.load(path if path.endswith(".npz") else path + ".npz")
    return np.asarray(z["id"]).reshape(-1), np.asarray(z["rgb"])
