"""Visualization helpers for the render CLI.

Counterpart of trase_tpu/viz.py (reference render.py:46-106, 246-296,
gui.py:1168-1190): QR+SVD PCA of 3D gaussian features (``feature3d_to_rgb``) and of
a rendered feature map (``feature_to_rgb``), the one-pixel point splat of
the pointcloud / gaussian_clusters / gaussian_feats streams, float-to-
uint8 conversion, the threaded PNG writer, mp4 videos, the jet
colormap and the viewer's trajectory overlay (``draw_polylines``).
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


def feature_to_rgb(feats: torch.Tensor, n_components: int = 3) -> torch.Tensor:
    """(F, H, W) rendered feature map -> (3, H, W) PCA visualization."""
    f, h, w = feats.shape
    rgb = feature3d_to_rgb(feats.reshape(f, -1).T, n_components)  # (HW, 3)
    return rgb.T.reshape(3, h, w)


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def point_splat(points3d, full_proj, image_height: int, image_width: int,
                colors=None, white_background: bool = False) -> np.ndarray:
    """One-pixel point rendering (render.py:246-296) on the host:
    points3d (N, 3) deformed positions, full_proj (4, 4) row-vector
    projection, colors (N, 3) or None (white on black, black on white).
    Returns (3, H, W) float32."""
    pts = _np(points3d)
    hom = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=1)
    p = hom @ _np(full_proj)
    xy = p[:, :2] / (p[:, 3:4] + 1e-9)
    xy = (xy + 1) / 2 * np.array([image_width, image_height])

    bg = 1.0 if white_background else 0.0
    img = np.full((3, image_height, image_width), bg, np.float32)
    ok = ((xy[:, 0] > 0) & (xy[:, 0] < image_width)
          & (xy[:, 1] > 0) & (xy[:, 1] < image_height) & (p[:, 3] > 0))
    xs = xy[ok, 0].astype(np.int64)
    ys = xy[ok, 1].astype(np.int64)
    if colors is None:
        img[:, ys, xs] = 0.0 if white_background else 1.0
    else:
        c = _np(colors)[ok]
        img[0, ys, xs] = c[:, 0]
        img[1, ys, xs] = c[:, 1]
        img[2, ys, xs] = c[:, 2]
    return img


def to8b(x) -> np.ndarray:
    """(3,H,W) float (array or tensor) -> (H,W,3) uint8 (render.py:106)."""
    return (255 * np.clip(_np(x), 0, 1)).astype(np.uint8).transpose(1, 2, 0)


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


def write_video(path: str, frames, fps: int = 30) -> None:
    """frames: list of (H,W,3) uint8; every second frame to an mp4, via
    imageio where it is installed, else cv2; a failed write is reported
    and skipped, as trase_tpu's."""
    if not frames:
        return
    try:
        import imageio

        imageio.mimwrite(path, frames[::2], fps=fps, quality=8)
        return
    except Exception:  # noqa: BLE001 — no imageio, or no ffmpeg backend
        pass
    try:
        import cv2

        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
        for f in frames[::2]:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()
    except Exception as e:  # noqa: BLE001
        print(f"[viz] video write failed ({e}); skipping {path}")


def jet_colors(n: int) -> np.ndarray:
    """(n, 3) jet colormap in [0,1] (reference gui.py:1168 cm 'jet');
    matplotlib's where it is installed, else the piecewise-linear jet."""
    try:
        from matplotlib import cm

        return np.array([cm.get_cmap("jet")(i / max(1, n - 1))[:3]
                         for i in range(n)], np.float32)
    except Exception:  # noqa: BLE001 — matplotlib-free fallback
        x = np.linspace(0.0, 1.0, n, dtype=np.float32)
        r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
        g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
        b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
        return np.stack([r, g, b], axis=1)


def draw_polylines(h: int, w: int, tracks: np.ndarray,
                   colors: np.ndarray, thickness: int = 1,
                   valid: np.ndarray | None = None):
    """Rasterize per-track polylines (reference gui.py:1184-1190).

    tracks: (T, M, 2) pixel (x, y) positions of M tracks over T frames;
    colors: (M, 3) in [0,1]; valid: optional (T, M) bool — segments
    touching an invalid sample (e.g. behind-camera projections) are not
    drawn. Returns (rgb (H,W,3), alpha (H,W)) float32 overlay buffers.
    cv2 where it is installed; dense segment sampling in numpy otherwise
    (the two draw different pixels: cv2's line rasterizer against 48
    rounded samples a segment)."""
    rgb = np.zeros((h, w, 3), np.float32)
    alpha = np.zeros((h, w), np.float32)
    if tracks.shape[0] < 2:
        return rgb, alpha
    if valid is None:
        valid = np.ones(tracks.shape[:2], bool)
    seg_ok = valid[:-1] & valid[1:]  # (T-1, M)
    # wild coordinates (near w~0) overflow int32 in cv2: clip to a
    # generous off-screen box so clipped segments stay geometric
    tracks = np.clip(tracks, -4.0 * max(h, w), 4.0 * max(h, w))
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        for i in range(tracks.shape[1]):
            c = colors[i]
            col = (float(c[0]), float(c[1]), float(c[2]))
            # draw each maximal run of valid samples as one polyline
            runs = np.flatnonzero(np.diff(np.concatenate(
                [[False], valid[:, i], [False]]).astype(np.int8)))
            for r0, r1 in zip(runs[::2], runs[1::2]):
                if r1 - r0 < 2:
                    continue
                pts = tracks[r0:r1, i].astype(np.int32).reshape(-1, 1, 2)
                cv2.polylines(rgb, [pts], isClosed=False, color=col,
                              thickness=thickness)
                cv2.polylines(alpha, [pts], isClosed=False, color=1.0,
                              thickness=thickness)
        return rgb, alpha
    # vectorized fallback: sample every valid segment densely
    p0 = tracks[:-1].reshape(-1, 2)
    p1 = tracks[1:].reshape(-1, 2)
    keep = seg_ok.reshape(-1)
    seg_colors = np.broadcast_to(
        colors[None], (tracks.shape[0] - 1,) + colors.shape).reshape(-1, 3)
    p0, p1, seg_colors = p0[keep], p1[keep], seg_colors[keep]
    if p0.shape[0] == 0:
        return rgb, alpha
    t = np.linspace(0.0, 1.0, 48, dtype=np.float32)[None, :, None]
    pts = p0[:, None, :] * (1 - t) + p1[:, None, :] * t  # (S, 48, 2)
    cols = np.repeat(seg_colors, t.shape[1], axis=0)
    xs = np.round(pts[..., 0].ravel()).astype(np.int64)
    ys = np.round(pts[..., 1].ravel()).astype(np.int64)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    rgb[ys[ok], xs[ok]] = cols[ok]
    alpha[ys[ok], xs[ok]] = 1.0
    return rgb, alpha
