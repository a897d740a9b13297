"""Nearest-neighbour distances for gaussian initialisation.

Counterpart of ``mean_dist3_sq`` in trase_tpu/ops/knn.py (the
reference's simple_knn distCUDA2). Chunked (chunk x N) distance
matrices keep memory bounded. The smoothing / prompt-lookup KNN belongs
to the training and editing slices.
"""
from __future__ import annotations

import torch


def mean_dist3_sq(points: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """Mean squared distance to the 3 nearest neighbours (excluding
    self). points: (N,3) -> (N,)."""
    sq = (points * points).sum(dim=1)
    out = []
    for lo in range(0, points.shape[0], chunk):
        q = points[lo:lo + chunk]
        d2 = (q * q).sum(dim=1, keepdim=True) + sq[None, :] - 2.0 * (q @ points.T)
        d2 = torch.clamp(d2, min=0.0)
        nearest = torch.topk(d2, k=min(4, points.shape[0]), dim=1,
                             largest=False).values
        out.append(nearest[:, 1:].mean(dim=1))
    return torch.cat(out)
