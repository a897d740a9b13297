"""3D feature and rigidity regularizers.

Counterpart of trase_tpu/losses/losses_3d.py (reference
utils/loss_utils.py:89-221): loss_cls_3d (KL against the top-k feature
neighbours), loss_reg_3d_feature (sigmoid-KL against the k spatial
neighbours), loss_feature3d (near / far cosine terms) and the
per-neighbourhood ARAP rigid-body loss (Procrustes through an SVD).
Defined but not wired, in the reference and in trase_tpu alike.

Where trase_tpu draws a subsample with jax.random.permutation, these take
a torch.Generator (on the points' device), or the permutation's indices
precomputed (``subsample_idx``, ``sample_idx``): a test passes
trase_tpu's permutations through them.
"""
from __future__ import annotations

import torch

from ..ops.knn import knn


def _subsample(n: int, max_points: int, generator, idx):
    if idx is not None:
        return idx
    dev = generator.device if generator is not None else "cpu"
    return torch.randperm(n, generator=generator, device=dev)[:max_points]


def loss_cls_3d(features, predictions, k=5, lambda_val=2.0,
                max_points=200000, sample_size=800, generator=None,
                subsample_idx=None, sample_idx=None):
    """Neighbourhood-consistency KL over the top-k feature neighbours of
    `sample_size` sampled points (after a subsample to `max_points`)."""
    n = features.shape[0]
    dev = features.device
    if n > max_points:
        idx = _subsample(n, max_points, generator, subsample_idx).to(dev)
        features, predictions = features[idx], predictions[idx]
        n = max_points
    s_idx = _subsample(n, sample_size, generator, sample_idx).to(dev)
    sample_f = features[s_idx]
    sample_p = predictions[s_idx]
    _, nn_idx = knn(sample_f, features, k)
    neigh_p = predictions[nn_idx]  # (S, k, C)
    kl = sample_p[:, None] * (torch.log(sample_p[:, None] + 1e-10)
                              - torch.log(neigh_p + 1e-10))
    loss = kl.sum(-1).mean()
    return lambda_val * loss / predictions.shape[1]


def loss_reg_3d_feature(gaussian_feats, gaussian_xyz, k):
    """KL between the sigmoid features of each point and of its k
    spatial nearest neighbours."""
    _, idx = knn(gaussian_xyz, gaussian_xyz, k + 1)
    neigh = idx[:, 1:]  # (N, k)
    f = torch.sigmoid(gaussian_feats)
    fn = f[neigh]  # (N, k, F)
    eps = 1e-10
    kl = f[:, None] * (torch.log(f[:, None] + eps) - torch.log(fn + eps))
    return kl.mean()


def loss_feature3d(gaussian_feats, gaussian_xyz, kp=16, kn=4,
                   max_points=10000, lambda_p=1.0, lambda_n=1.0,
                   generator=None, subsample_idx=None):
    """Near neighbours should agree, far points should not."""
    n = gaussian_feats.shape[0]
    if n > max_points:
        idx = _subsample(n, max_points, generator, subsample_idx).to(
            gaussian_feats.device)
        gaussian_feats, gaussian_xyz = gaussian_feats[idx], gaussian_xyz[idx]
    d2 = torch.sum((gaussian_xyz[:, None] - gaussian_xyz[None, :]) ** 2,
                   dim=-1)
    nn_idx = torch.topk(-d2, kp, dim=1).indices
    fn_idx = torch.topk(d2, kn, dim=1).indices

    def cos(a, b):
        return torch.sum(a * b, -1) / (
            torch.linalg.vector_norm(a, dim=-1)
            * torch.linalg.vector_norm(b, dim=-1) + 1e-12)

    near = torch.sigmoid(
        1 - cos(gaussian_feats[:, None], gaussian_feats[nn_idx])).mean()
    far = torch.sigmoid(
        cos(gaussian_feats[:, None], gaussian_feats[fn_idx])).mean()
    return lambda_p * near + lambda_n * far


def rigid_body_motion_loss(xyz1, xyz2, neighbor_idx):
    """ARAP rigidity: each point's edges to its neighbours at t1 and t2
    should differ by a rotation, R = V U^T of the SVD of their
    cross-covariance (as trase_tpu: no reflection fix). neighbor_idx:
    (N, K) precomputed KNN of xyz1."""
    e1 = xyz1[:, None, :] - xyz1[neighbor_idx]  # (N, K, 3)
    e2 = xyz2[:, None, :] - xyz2[neighbor_idx]
    S = torch.einsum("nki,nkj->nij", e1, e2)
    U, _, Vh = torch.linalg.svd(S)
    R = torch.einsum("nji,nkj->nik", Vh, U)  # V @ U^T
    e2_rot = torch.einsum("nij,nkj->nki", R, e2)
    return ((e1 - e2_rot) ** 2).sum(-1).sum(-1).mean()
