"""Visualization helpers for the render CLI.

Counterpart of trase_tpu/viz.py:15,69-112 (reference render.py:46-106):
QR+SVD PCA of 3D gaussian features to RGB, float-to-uint8 conversion
and the threaded PNG writer. The point splat and video streams belong
to a later slice.
"""
from __future__ import annotations

import numpy as np
import torch


def feature3d_to_rgb(x: torch.Tensor, n_components: int = 3) -> torch.Tensor:
    """(N, F) features -> (N, 3) PCA colors in [0, 1]."""
    x = torch.as_tensor(x, dtype=torch.float32)
    centered = x - x.mean(dim=0)
    q, r = torch.linalg.qr(centered)
    u, s, _ = torch.linalg.svd(r, full_matrices=False)
    compress = u[:, :n_components] @ torch.diag(s[:n_components])
    pca = q @ compress
    return (pca - pca.min()) / (pca.max() - pca.min() + 1e-12)


def to8b(x) -> np.ndarray:
    """(3,H,W) float (array or tensor) -> (H,W,3) uint8 (render.py:106)."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8).transpose(
        1, 2, 0)


def save_image(path: str, img) -> None:
    from PIL import Image

    Image.fromarray(to8b(img)).save(path)


class AsyncImageWriter:
    """Thread-pool PNG writer (reference multithread_write,
    render.py:61-81); serial when `multithread` is False."""

    def __init__(self, workers: int = 8, multithread: bool = True):
        self._pool = None
        if multithread:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=workers)
        self._futures = []

    def submit(self, path: str, img) -> None:
        arr = to8b(img)  # convert on the caller thread (device tensor)

        def _write():
            from PIL import Image

            Image.fromarray(arr).save(path)

        if self._pool is None:
            _write()
        else:
            self._futures.append(self._pool.submit(_write))

    def close(self) -> None:
        for f in self._futures:
            f.result()
        if self._pool is not None:
            self._pool.shutdown()
