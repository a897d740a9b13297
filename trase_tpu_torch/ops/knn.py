"""K-nearest-neighbour ops: chunked dense distances + top-k.

Counterpart of trase_tpu/ops/knn.py (the reference's simple_knn distCUDA2
and pytorch3d knn_points): ``knn``, ``mean_dist3_sq`` for gaussian
initialisation, and the FEATURE step's feature smoothing
(``build_feature_smooth_map``, ``smooth_features``). Chunked
(chunk x N) distance matrices keep memory bounded; the distances are
||q||^2 + ||p||^2 - 2 q.p, a float32 matrix product (TF32 is off).
"""
from __future__ import annotations

import torch

# share of the neighbour slots a FEATURE step's smoothing averages over
# (trase_tpu's loop passes smooth_dropout=0.5)
SMOOTH_DROPOUT = 0.5


def knn(queries: torch.Tensor, points: torch.Tensor, k: int,
        chunk: int = 4096):
    """Exact KNN: for each query, the k nearest points. Returns
    (dists2 (Q, k), idx (Q, k) int64), ascending by squared distance.
    Points at equal distance may come in another order than
    jax.lax.top_k gives them."""
    sq = (points * points).sum(dim=1)
    dists, idx = [], []
    for lo in range(0, queries.shape[0], chunk):
        q = queries[lo:lo + chunk]
        d2 = (q * q).sum(dim=1, keepdim=True) + sq[None, :] \
            - 2.0 * (q @ points.T)
        d2 = torch.clamp(d2, min=0.0)
        top = torch.topk(d2, k=k, dim=1, largest=False)
        dists.append(top.values)
        idx.append(top.indices)
    return torch.cat(dists), torch.cat(idx)


def mean_dist3_sq(points: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """Mean squared distance to the 3 nearest neighbours (excluding
    self). points: (N,3) -> (N,)."""
    d2, _ = knn(points, points, k=min(4, points.shape[0]), chunk=chunk)
    return d2[:, 1:].mean(dim=1)


def build_feature_smooth_map(xyz: torch.Tensor, k: int,
                             chunk: int = 4096) -> torch.Tensor:
    """Neighbour index map for feature smoothing (self included, as
    knn_points with query == ref): (N, k) int64."""
    return knn(xyz, xyz, k=k, chunk=chunk)[1]


def smooth_features(features: torch.Tensor, neighbor_idx: torch.Tensor,
                    perm: torch.Tensor | None = None,
                    generator: torch.Generator | None = None
                    ) -> torch.Tensor:
    """KNN-smoothed, L2-normalized gaussian features
    (GaussianModel.get_smoothed_gaussian_features): normalize each row,
    average it over a subset of its neighbour slots shared by all
    gaussians. The subset is `perm` (slot indices) when given, else the
    first max(int(K * SMOOTH_DROPOUT), 1) slots of a permutation drawn
    from `generator`, else every slot. trase_tpu draws
    the permutation from a jax key; a test passes that one as `perm`.

    features: (N, F); neighbor_idx: (N, K). Returns (N, F)."""
    # safe norm: dead slots are all-zero
    normed = features / torch.sqrt(
        torch.sum(features * features, dim=-1, keepdim=True) + 1e-12)
    return smooth_rows(normed, neighbor_idx,
                       smooth_slots(neighbor_idx.shape[1], perm, generator))


def smooth_slots(k: int, perm: torch.Tensor | None = None,
                 generator: torch.Generator | None = None):
    """The neighbour slots a smoothing averages over: `perm` when given,
    else the first max(int(k * SMOOTH_DROPOUT), 1) slots of a permutation
    drawn from `generator`, else None (every slot)."""
    if perm is None and generator is not None:
        n_sel = max(int(k * SMOOTH_DROPOUT), 1)
        perm = torch.randperm(k, generator=generator,
                              device=generator.device)[:n_sel]
    return perm


def smooth_rows(normed: torch.Tensor, neighbor_idx: torch.Tensor,
                slots: torch.Tensor | None) -> torch.Tensor:
    """Each row of `neighbor_idx`'s mean of the `normed` rows it names,
    over the neighbour `slots` (None: every slot)."""
    sel = neighbor_idx if slots is None else \
        neighbor_idx[:, slots.to(neighbor_idx.device)]
    return normed[sel].mean(dim=1)
