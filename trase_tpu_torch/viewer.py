"""Headless interactive viewer (the GUI replacement) and its CLI.

Counterpart of trase_tpu/viewer.py and the repository root's viewer.py
(reference gui.py / gui_standalone.py), re-exposed as a programmable
object instead of a dearpygui window:

- orbit camera navigation (cam_utils.OrbitCamera, the same math);
- render modes Render / Rendered Features / Gaussian Features /
  Gaussian Clusters / Segmentation / Point Cloud / Depth
  (gui.py:672-677, mode dispatch gui.py:975-1083);
- clustering -> ``cluster(...)`` writing clusters{,_kmeans}.pt
  (gui.py:248-319);
- click-prompt selection: pixel -> rendered depth -> unprojection by the
  inverse full projection -> nearest deformed gaussian -> its cluster,
  with the cosine score-threshold post-filter (gui.py:754-839, 456-464);
- text-prompt selection from a 2D mask (``text_select(mask2d=...)``,
  the CLI's ``textmask``), or from a text prompt alone through
  Grounded-SAM (ext/grounded_sam.py), which raises ImportError where
  groundingdino / segment_anything are not installed;
- removal (render with mask=~segmented, gui.py:414-417, 1070) and object
  save (save_ply(mask=...), gui.py:617-651);
- composition of an extracted object with the scene in one
  rasterization (``load_object``, ``render_composite_frame``);
- per-frame ms / FPS readout (gui.py:1104-1124), taken after the frame's
  host copy, so it includes the device work;
- the gaussian-motion trajectory overlay: farthest-point-sampled tracks
  drawn as jet-coloured polylines over the frame (gui.py:1154-1191).

Every frame composites through ``renderer.render`` at 4 values (rgb +
depth): on the card the compositor kernel (csrc/composite_fwd.cu), one
launch a frame; the deformation runs the float32 module, as trase_tpu's
viewer does. The display image is quantized to uint8 on the device before
its host copy, as trase_tpu quantizes it.

    python -m trase_tpu_torch.viewer -m <model> --serve 8000   # browser
    python -m trase_tpu_torch.viewer -m <model> --script cmds.txt --out f/
    python -m trase_tpu_torch.viewer -m <model>                # REPL

REPL / script commands:
  render [mode]          render the current view; writes a frame to --out
  mode <name>            Render | Rendered Features | Gaussian Features
                         | Gaussian Clusters | Segmentation
                         | Point Cloud | Depth
  orbit <dx> <dy>        rotate (pixels of drag, gui sensitivity)
  zoom <delta>           radius *= 1.1^-delta
  pan <dx> <dy>          pan the target point
  time <fid>             set the normalized timestamp [0, 1]
  cluster [kmeans [K]]   run HDBSCAN (or k-means) and save clusters.pt
  click <px> <py>        select the cluster under a pixel
  text <prompt>          Grounded-SAM text selection (needs its packages)
  textmask <png>         text selection from a precomputed 2D mask
  threshold <t>          cosine score threshold for selection
  clear                  clear selection
  remove                 render with the selected object removed
  save_object [path]     write point_cloud_object.ply of the selection
  save_rest [path]       write point_cloud_wo_object.ply
  load_object <ply>      load an extracted object for composition
  compose [s dx dy dz rx ry rz]
                         composite the object (rescale/translate/rotate)
                         with this model in one rasterization
  fps                    print last frame time / FPS
  trajectory [T [M]]     toggle the gaussian-motion overlay: track M
                         FPS-sampled gaussians over the last T frames
  quit
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from . import resolve_device

MODES = ("Render", "Rendered Features", "Gaussian Features",
         "Gaussian Clusters", "Segmentation", "Point Cloud", "Depth")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class HeadlessViewer:
    """One trained scene on one device, its camera, mode and selection.

    `deform_net` is a DeformNetwork with its weights loaded, or None for a
    static scene (zero deformation)."""

    def __init__(self, params, aux, n_gaussians, deform_net=None, W=800,
                 H=800, radius=2.0, fovy=60.0, white_background=False,
                 is_6dof=False, sh_degree=3, model_dir=None,
                 loaded_iter=None, raster_cfg=None, device="cuda"):
        from .cam_utils import OrbitCamera
        from .ops.rasterize import RasterConfig

        self.device = resolve_device(device)
        self.params = params
        self.aux = aux
        self.n = n_gaussians
        self.deform_net = deform_net
        self.cam = OrbitCamera(W, H, r=radius, fovy=fovy)
        self.W, self.H = W, H
        self.white_background = white_background
        self.is_6dof = is_6dof
        self.sh_degree = sh_degree
        self.model_dir = model_dir
        self.loaded_iter = loaded_iter
        self.raster_cfg = raster_cfg or RasterConfig(pairs_per_gaussian=16)
        self.bg = torch.tensor(
            [1.0, 1.0, 1.0] if white_background else [0.0, 0.0, 0.0],
            device=self.device)

        self.mode = "Render"
        self.fid = 0.0
        self.score_threshold = 0.8
        self.cluster_ids = None  # (capacity,) int64, -1 = none
        self.cluster_rgb = None
        self.selected_clusters: list[int] = []
        self.segmented_mask = None  # (capacity,) bool tensor on the device
        self.last_frame_ms = float("nan")
        self._pca_rgb = None
        self.show_trajectory = False
        self._traj = None  # dict(ids, colors, history) once enabled
        self._traj_cfg = (32, 512, 1)  # samp_num, gs_num, thickness
        self.object_params = None

    # ---------- model loading ----------

    @classmethod
    def from_model_path(cls, model_path, iteration=-1,
                        model_type="DeformNetwork", is_blender=False,
                        is_6dof=False, sh_degree=3, device="cuda", **kw):
        """Standalone load from point_cloud.ply + deform weights +
        clusters, no dataset needed (gui_standalone.py:597-605)."""
        from .cluster.clustering import load_clusters
        from .models.deform import load_flax_params, make_deform_network
        from .models.gaussians_io import load_checkpoint, load_gaussian_ply
        from .utils.general import search_for_max_iteration

        dev = resolve_device(device)
        pc_dir = os.path.join(model_path, "point_cloud")
        if iteration >= 0:
            it = iteration
        elif os.path.isdir(pc_dir) and os.listdir(pc_dir):
            it = search_for_max_iteration(pc_dir)
        else:
            raise FileNotFoundError(f"no snapshots under {pc_dir}")
        ply = os.path.join(pc_dir, f"iteration_{it}", "point_cloud.ply")
        params, aux, n, _ = load_gaussian_ply(ply, sh_degree=sh_degree,
                                              device=dev)
        # the loader infers the file's true SH degree; render with it
        sh_degree = int(round(np.sqrt(params.features_rest.shape[1] + 1))) - 1

        net = None
        dpath = os.path.join(model_path, "deform", f"iteration_{it}",
                             "deform.pkl")
        if os.path.exists(dpath):
            net = make_deform_network(model_type, is_blender=is_blender,
                                      is_6dof=is_6dof, device=dev)
            load_flax_params(net, load_checkpoint(dpath)["vars"])
            net.eval()

        v = cls(params, aux, n, deform_net=net, is_6dof=is_6dof,
                sh_degree=sh_degree, model_dir=model_path, loaded_iter=it,
                device=dev, **kw)
        for name in ("clusters.pt", "clusters_kmeans.pt"):
            p = os.path.join(pc_dir, f"iteration_{it}", name)
            if os.path.exists(p) or os.path.exists(p + ".npz"):
                ids, rgb = load_clusters(p)
                v.set_clusters(ids, rgb)
                break
        return v

    def set_clusters(self, ids, rgb):
        capacity = self.params.xyz.shape[0]
        self.cluster_ids = np.full(capacity, -1, np.int64)
        self.cluster_ids[:len(ids)] = np.asarray(ids).reshape(-1)
        self.cluster_rgb = np.zeros((capacity, 3), np.float32)
        self.cluster_rgb[:len(rgb)] = np.asarray(rgb)

    # ---------- clustering (gui.py:248-319) ----------

    def cluster(self, kmeans=False, k=64, save=True, **kw):
        """HDBSCAN on the host, or k-means with its iterations on the
        viewer's device; sets the clusters and, with `save`, writes
        clusters.pt / clusters_kmeans.pt beside the snapshot. Returns the
        number of distinct ids."""
        from .cluster.clustering import (
            hdbscan_cluster, kmeans_cluster, save_clusters,
        )

        feats = _host(self.params.gaussian_features)[:self.n]
        if kmeans:
            ids, rgb, _ = kmeans_cluster(feats, k=k, device=self.device,
                                         **kw)
            fname = "clusters_kmeans.pt"
        else:
            ids, rgb, _, k = hdbscan_cluster(feats, **kw)
            fname = "clusters.pt"
        self.set_clusters(ids, rgb)
        if save and self.model_dir and self.loaded_iter is not None:
            out = os.path.join(self.model_dir, "point_cloud",
                               f"iteration_{self.loaded_iter}", fname)
            save_clusters(out, ids, rgb)
        return int(np.unique(ids).size)

    # ---------- rendering ----------

    def _render_camera(self):
        from .cam_utils import pose_to_render_camera

        return pose_to_render_camera(
            self.cam.pose, self.W, self.H, self.cam.fovx, self.cam.fovy,
            self.cam.near, self.cam.far, device=self.device)

    @torch.no_grad()
    def _deform(self, fid, xyz=None):
        """(d_xyz, d_rotation, d_scaling) of every slot of `xyz` (the
        scene's by default) at time `fid`, zeros without a deform net."""
        from .models.deform import deform_step

        xyz = self.params.xyz if xyz is None else xyz
        capacity = xyz.shape[0]
        if self.deform_net is None:
            z3 = torch.zeros((capacity, 3), device=self.device)
            return z3, torch.zeros((capacity, 4), device=self.device), z3
        t = torch.full((capacity, 1), float(fid), device=self.device)
        return deform_step(self.deform_net, xyz, t)

    @torch.no_grad()
    def _raw_frame(self, override_color=None, mask=None, fid=None):
        """One composite of the scene (rgb + depth, no features) and the
        frame's d_xyz; the output also holds render_u8, the (H, W, 3)
        uint8 display image quantized on the device."""
        from .renderer import render

        fid = self.fid if fid is None else fid
        camera = self._render_camera()
        d_xyz, d_rot, d_scale = self._deform(fid)
        if override_color is not None:
            override_color = torch.as_tensor(
                np.asarray(override_color, np.float32), device=self.device)
        out = render(camera, self.params, self.aux.alive, self.bg, d_xyz,
                     d_rot, d_scale, is_6dof=self.is_6dof,
                     sh_degree=self.sh_degree, override_color=override_color,
                     mask=mask, with_features=False,
                     raster_cfg=self.raster_cfg)
        # quantize on the device so that the host copy moves (H, W, 3)
        # uint8, a quarter of the float32 image; .to(uint8) truncates, as
        # trase_tpu's astype
        out["render_u8"] = torch.clamp(
            out["render"].permute(1, 2, 0) * 255.0, 0, 255).to(torch.uint8)
        return out, d_xyz

    def render_frame(self, mode=None, apply_selection_removal=False):
        """One frame in the given mode -> (3, H, W) float32 image in [0,1].

        Updates the ms/FPS readout (gui.py:1104-1124); every mode ends on
        a host copy of the frame's device results."""
        from .viz import point_splat

        mode = mode or self.mode
        t0 = time.perf_counter()
        mask = None
        if apply_selection_removal and self.segmented_mask is not None:
            mask = ~self.segmented_mask

        d_xyz = None
        if mode == "Render":
            out, d_xyz = self._raw_frame(mask=mask)
            img = _host(out["render_u8"]).transpose(2, 0, 1)
            img = img.astype(np.float32) / 255.0
        elif mode == "Depth":
            out, d_xyz = self._raw_frame(mask=mask)
            depth = _host(out["depth"])[0]
            img = np.broadcast_to(
                (depth / max(depth.max(), 1e-9))[None], (3,) + depth.shape
            ).copy()
        elif mode == "Rendered Features":
            img, d_xyz = self._feature_render(mask)
        elif mode == "Segmentation":
            if self.cluster_rgb is None:
                raise RuntimeError("run .cluster() first")
            out, d_xyz = self._raw_frame(
                override_color=self.cluster_rgb, mask=mask)
            img = _host(out["render"])
        elif mode in ("Point Cloud", "Gaussian Features",
                      "Gaussian Clusters"):
            _, d_xyz = self._raw_frame(mask=mask)
            deformed = _host(self.params.xyz + d_xyz)[:self.n]
            fp = _host(self._render_camera().buffers.full_proj)
            colors = None
            if mode == "Gaussian Features":
                colors = self._pca()[:self.n]
            elif mode == "Gaussian Clusters":
                if self.cluster_rgb is None:
                    raise RuntimeError("run .cluster() first")
                colors = self.cluster_rgb[:self.n]
            img = point_splat(deformed, fp, self.H, self.W, colors,
                              self.white_background)
        else:
            raise ValueError(f"unknown mode {mode!r}; one of {MODES}")

        if self.show_trajectory and d_xyz is not None:
            img = self._apply_trajectory(img, d_xyz)
        self.last_frame_ms = (time.perf_counter() - t0) * 1000.0
        return img

    def toggle_trajectory(self, on=None, samp_num=32, gs_num=512,
                          thickness=1):
        """'Visualize Trajectory' checkbox (gui.py:1154-1191): track
        farthest-point-sampled gaussians across rendered frames and
        overlay their motion as jet-coloured polylines. Tracks are
        (re)seeded from the current selection (if any) on enable."""
        self.show_trajectory = ((not self.show_trajectory)
                                if on is None else bool(on))
        self._traj = None
        self._traj_cfg = (samp_num, gs_num, thickness)
        return self.show_trajectory

    def _apply_trajectory(self, img, d_xyz):
        from .models import gaussians as G
        from .models.deform import farthest_point_sample
        from .viz import draw_polylines, jet_colors

        samp_num, gs_num, thickness = self._traj_cfg
        if self._traj is None:
            # seed: opacity > .1 among alive (gui.py:1159), restricted
            # to the selection when one exists (gui.py:1163-1166)
            alive = _host(self.aux.alive)
            keep = alive & (_host(G.get_opacity(self.params))[:, 0] > 0.1)
            if self.segmented_mask is not None:
                sel = keep & _host(self.segmented_mask)
                if sel.sum() >= 4:
                    keep = sel
            cand = np.flatnonzero(keep)
            if cand.size == 0:
                cand = np.flatnonzero(alive)
            m = min(gs_num, cand.size)
            pts = self.params.xyz[torch.as_tensor(cand, device=self.device)]
            fps_idx = _host(farthest_point_sample(
                pts, m, generator=torch.Generator().manual_seed(0)))
            ids = cand[fps_idx]
            self._traj = {"ids": ids,
                          "ids_dev": torch.as_tensor(ids, device=self.device),
                          "colors": jet_colors(m), "history": []}
        tr = self._traj
        ids = tr["ids_dev"]
        if self.is_6dof and getattr(d_xyz, "ndim", 0) == 3:
            # 6-DoF deform: d_xyz is a batch of homogeneous transforms
            # (renderer.apply_deformation), not a displacement
            xyz = _host(self.params.xyz[ids])
            T = _host(d_xyz[ids])
            hom = np.concatenate([xyz, np.ones_like(xyz[:, :1])], axis=1)
            out4 = np.einsum("nij,nj->ni", T, hom)
            pos = out4[:, :3] / np.where(
                np.abs(out4[:, 3:4]) < 1e-9, 1e-9, out4[:, 3:4])
        else:
            pos = _host(self.params.xyz[ids] + d_xyz[ids])  # (M, 3)
        tr["history"].append(pos)
        if len(tr["history"]) > samp_num:
            tr["history"] = tr["history"][-samp_num:]
        if len(tr["history"]) < 2:
            return img
        fp = _host(self._render_camera().buffers.full_proj)
        world = np.stack(tr["history"])  # (T, M, 3)
        hom = np.concatenate(
            [world, np.ones_like(world[..., :1])], axis=-1)
        p = hom @ fp
        xy = p[..., :2] / np.where(
            np.abs(p[..., 3:4]) < 1e-9, 1e-9, p[..., 3:4])
        xy = (xy + 1) / 2 * np.array([self.W, self.H], np.float32)
        # behind-camera samples (w <= 0) project to mirrored pixels: drop
        # the segments touching them (point_splat's p[:, 3] > 0 guard)
        valid = p[..., 3] > 1e-6  # (T, M)
        rgb, alpha = draw_polylines(self.H, self.W, xy, tr["colors"],
                                    thickness, valid=valid)
        a = alpha[None]  # (1, H, W) over the (3, H, W) frame
        return img * (1 - a) + rgb.transpose(2, 0, 1) * a

    def _pca(self):
        """(capacity, 3) PCA colours of the 3D features (cached)."""
        from .viz import feature3d_to_rgb

        if self._pca_rgb is None:
            capacity = self.params.xyz.shape[0]
            pca = _host(feature3d_to_rgb(
                self.params.gaussian_features[:self.n]))
            full = np.zeros((capacity, 3), np.float32)
            full[:self.n] = pca
            self._pca_rgb = full
        return self._pca_rgb

    def _feature_render(self, mask):
        """Composite the gaussians' PCA colours ('Rendered Features'
        mode). Returns (img, d_xyz)."""
        out, d_xyz = self._raw_frame(override_color=self._pca(), mask=mask)
        return _host(out["render"]), d_xyz

    @property
    def fps(self):
        return 1000.0 / self.last_frame_ms if self.last_frame_ms else 0.0

    # ---------- selection (gui.py:754-839, 456-464) ----------

    def _clip_z(self, d):
        """Clip-space z of view depth d (the projection's z row)."""
        znear, zfar = self.cam.near, self.cam.far
        return zfar / (zfar - znear) * d - zfar * znear / (zfar - znear)

    def _inverse_full_proj(self):
        return np.linalg.inv(_host(self._render_camera().buffers.full_proj))

    def click_select(self, px, py, add=True):
        """Select the cluster under pixel (px, py) at the current view
        and time. Returns the cluster id (or None off-geometry)."""
        if self.cluster_ids is None:
            raise RuntimeError("run .cluster() first")
        out, d_xyz = self._raw_frame()
        depth_img = _host(out["depth"])[0]
        alpha = _host(out["alpha"])[0]
        ph, pw = int(py), int(px)
        if alpha[ph, pw] <= 1e-3:
            return None
        d = depth_img[ph, pw] / max(alpha[ph, pw], 1e-6)
        # the reference's half-pixel convention: (p - 0.5) / W * 2 - 1
        uvz = np.array([((pw - 0.5) / self.W * 2 - 1) * d,
                        ((ph - 0.5) / self.H * 2 - 1) * d, self._clip_z(d),
                        d], np.float32)[None]
        p3d = (uvz @ self._inverse_full_proj())[0, :3]

        deformed = _host(self.params.xyz + d_xyz)
        # dead slots never win the nearest-gaussian search
        deformed = np.where(_host(self.aux.alive)[:, None], deformed,
                            np.inf)
        idx = int(np.linalg.norm(deformed - p3d, axis=-1).argmin())
        cid = int(self.cluster_ids[idx])
        if add and cid not in self.selected_clusters:
            self.selected_clusters.append(cid)
        self._recompute_mask()
        return cid

    def select_clusters(self, ids):
        self.selected_clusters = [int(i) for i in ids]
        self._recompute_mask()

    def text_select(self, text=None, mask2d=None, threshold=500):
        """Text-prompt selection (gui.py:1032-1064): a 2D mask -> depth
        unprojection -> nearest gaussian (KNN on the device) -> the
        clusters holding more than `threshold` of the mask's pixels.
        Without `mask2d` the mask comes from Grounded-SAM
        (ext/grounded_sam.py) on the current frame, its networks on the
        viewer's device; without those packages that raises ImportError
        (the CLI's 'textmask <png>' passes a mask)."""
        from .ops.knn import knn

        if self.cluster_ids is None:
            raise RuntimeError("run .cluster() first")
        out, d_xyz = self._raw_frame()
        if mask2d is None:
            from .ext.grounded_sam import grounded_sam_mask

            mask2d = grounded_sam_mask(text, _host(out["render"]),
                                       device=self.device)
        depth = _host(out["depth"])[0]
        ys, xs = np.nonzero(np.asarray(mask2d))
        if len(ys) == 0:
            return []
        d = depth[ys, xs]
        uvz = np.stack([((xs - 0.5) / self.W * 2 - 1) * d,
                        ((ys - 0.5) / self.H * 2 - 1) * d, self._clip_z(d),
                        d], axis=1)
        pts3d = (uvz @ self._inverse_full_proj())[:, :3]
        _, nn_idx = knn(
            torch.as_tensor(np.asarray(pts3d, np.float32),
                            device=self.device),
            self.params.xyz + d_xyz, k=1)
        cls = self.cluster_ids[_host(nn_idx)[:, 0]]
        counts = np.bincount(cls[cls >= 0])
        ids = np.nonzero(counts > threshold)[0].tolist()
        self.select_clusters(ids)
        return ids

    def _recompute_mask(self):
        """Cluster membership + cosine post-filter (gui.py:823-839)."""
        from .cluster.clustering import postprocessing

        if not self.selected_clusters:
            self.segmented_mask = None
            return
        feats = _host(self.params.gaussian_features)
        seg = None
        for cid in self.selected_clusters:
            pre = self.cluster_ids == cid
            if not pre.any():
                continue
            post = pre & postprocessing(
                feats, feats[pre].mean(axis=0),
                score_threshold=self.score_threshold)
            seg = post if seg is None else seg | post
        self.segmented_mask = (None if seg is None else
                               torch.as_tensor(seg, device=self.device))

    def clear_selection(self):
        self.selected_clusters = []
        self.segmented_mask = None

    # ---------- editing (gui.py:617-651) ----------

    def _save(self, path, default_name, rest):
        """The selection (or with `rest` all but it) as a snapshot ply."""
        from .models.gaussians_io import save_gaussian_ply

        if self.segmented_mask is None:
            raise RuntimeError("nothing selected")
        mask = _host(self.segmented_mask)
        if path is None:
            path = os.path.join(self.model_dir, "point_cloud",
                                f"iteration_{self.loaded_iter}",
                                default_name)
        save_gaussian_ply(path, self.params, self.aux.alive,
                          mask=~mask if rest else mask)
        return path

    def save_object(self, path=None):
        """save_ply(mask=segmented) -> point_cloud_object.ply."""
        return self._save(path, "point_cloud_object.ply", rest=False)

    def save_without_object(self, path=None):
        """save_ply(mask=~segmented) -> point_cloud_wo_object.ply."""
        return self._save(path, "point_cloud_wo_object.ply", rest=True)

    # ---------- composition (gaussian_renderer/__init__.py:251-331,
    # Scene(load_object=...), scene/__init__.py:106-119) ----------

    def load_object(self, ply_path):
        """Load an extracted object ply as the dynamic set for
        composition; this viewer's model becomes the background."""
        from .models.gaussians_io import load_gaussian_ply

        params, aux, n, _ = load_gaussian_ply(
            ply_path, sh_degree=self.sh_degree, device=self.device)
        self.object_params = params
        self.object_alive = aux.alive
        self.object_n = n
        return n

    @torch.no_grad()
    def render_composite_frame(self, scales_bias=1.0,
                               motion_bias=(0.0, 0.0, 0.0),
                               rotation_bias=(0.0, 0.0, 0.0), fid=None):
        """Composite the loaded object (rescaled / rotated / translated,
        deformed by this model's deform field) with the background set in
        one rasterization. Returns (3, H, W) float32."""
        from .renderer import render_composite

        if self.object_params is None:
            raise RuntimeError("load_object() first")
        t0 = time.perf_counter()
        camera = self._render_camera()
        fid = self.fid if fid is None else fid
        if self.deform_net is not None:
            d_xyz, d_rot, d_scale = self._deform(fid, self.object_params.xyz)
        else:
            d_xyz = d_rot = d_scale = 0.0
        out = render_composite(
            camera, self.params, self.aux.alive,
            self.object_params, self.object_alive,
            d_xyz, d_rot, d_scale, self.bg,
            scales_bias=scales_bias, motion_bias=motion_bias,
            rotation_bias=rotation_bias, sh_degree=self.sh_degree,
            raster_cfg=self.raster_cfg)
        img = _host(out["render"])
        self.last_frame_ms = (time.perf_counter() - t0) * 1000.0
        return img


# ------------------------------------------------------------------ CLI


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Headless viewer of a trained scene: REPL, script or "
        "browser GUI.")
    ap.add_argument("--model_path", "-m", required=True)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--model_type", default="DeformNetwork")
    ap.add_argument("--is_blender", action="store_true")
    ap.add_argument("--is_6dof", action="store_true")
    ap.add_argument("--sh_degree", type=int, default=3)
    ap.add_argument("--W", type=int, default=800)
    ap.add_argument("--H", type=int, default=800)
    ap.add_argument("--radius", type=float, default=2.0)
    ap.add_argument("--white_background", action="store_true")
    ap.add_argument("--out", default=None,
                    help="frame output dir (default <model>/viewer)")
    ap.add_argument("--script", default=None,
                    help="file of commands to run instead of stdin")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve the browser GUI on this port instead of "
                         "the REPL (trase_tpu_torch/viewer_web.py)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    return ap


def main(argv=None):
    from .viz import save_image

    args = build_parser().parse_args(argv)
    v = HeadlessViewer.from_model_path(
        args.model_path, iteration=args.iteration,
        model_type=args.model_type, is_blender=args.is_blender,
        is_6dof=args.is_6dof, sh_degree=args.sh_degree, W=args.W, H=args.H,
        radius=args.radius, white_background=args.white_background,
        device=args.device)

    if args.serve is not None:
        from .viewer_web import ViewerServer

        ViewerServer(v).serve(port=args.serve, host=args.host)
        return
    out_dir = args.out or os.path.join(args.model_path, "viewer")
    os.makedirs(out_dir, exist_ok=True)
    frame_idx = 0

    def write(img):
        nonlocal frame_idx
        path = os.path.join(out_dir, f"frame_{frame_idx:04d}.png")
        save_image(path, img)
        frame_idx += 1
        return path

    def do_render(mode=None, removal=False):
        img = v.render_frame(mode, apply_selection_removal=removal)
        path = write(img)
        print(f"{v.last_frame_ms:.1f} ms ({v.fps:.1f} FPS) -> {path}")

    if args.script:
        with open(args.script) as f:
            lines = f.read().splitlines()
    else:
        print(f"loaded iteration {v.loaded_iter}; modes: {', '.join(MODES)}")
        lines = None

    def input_iter():
        if lines is not None:
            yield from lines
        else:
            while True:
                try:
                    yield input("viewer> ")
                except EOFError:
                    return

    for line in input_iter():
        toks = line.strip().split()
        if not toks or toks[0].startswith("#"):
            continue
        cmd, rest = toks[0], toks[1:]
        try:
            if cmd == "quit":
                break
            elif cmd == "render":
                do_render(" ".join(rest) if rest else None)
            elif cmd == "mode":
                v.mode = " ".join(rest)
            elif cmd == "orbit":
                v.cam.orbit(float(rest[0]), float(rest[1]))
            elif cmd == "zoom":
                v.cam.scale(float(rest[0]))
            elif cmd == "pan":
                v.cam.pan(float(rest[0]), float(rest[1]))
            elif cmd == "time":
                v.fid = float(rest[0])
            elif cmd == "cluster":
                use_km = bool(rest) and rest[0] == "kmeans"
                k = int(rest[1]) if len(rest) > 1 else 64
                print(f"{v.cluster(kmeans=use_km, k=k)} clusters")
            elif cmd == "click":
                cid = v.click_select(float(rest[0]), float(rest[1]))
                print(f"selected cluster {cid}; "
                      f"selection = {v.selected_clusters}")
            elif cmd == "text":
                print("clusters:", v.text_select(" ".join(rest)))
            elif cmd == "textmask":
                from PIL import Image

                with Image.open(rest[0]) as im:
                    m = np.asarray(im.convert("L")) > 127
                print("clusters:", v.text_select(mask2d=m))
            elif cmd == "threshold":
                v.score_threshold = float(rest[0])
                v._recompute_mask()
            elif cmd == "clear":
                v.clear_selection()
            elif cmd == "remove":
                do_render(removal=True)
            elif cmd == "save_object":
                print("->", v.save_object(rest[0] if rest else None))
            elif cmd == "save_rest":
                print("->", v.save_without_object(rest[0] if rest else None))
            elif cmd == "load_object":
                print(f"{v.load_object(rest[0])} gaussians loaded")
            elif cmd == "compose":
                vals = [float(x) for x in rest] + [0.0] * 7
                img = v.render_composite_frame(
                    scales_bias=vals[0] if rest else 1.0,
                    motion_bias=tuple(vals[1:4]),
                    rotation_bias=tuple(vals[4:7]))
                print(f"{v.last_frame_ms:.1f} ms -> {write(img)}")
            elif cmd == "fps":
                print(f"{v.last_frame_ms:.1f} ms ({v.fps:.1f} FPS)")
            elif cmd == "trajectory":
                on = v.toggle_trajectory(
                    samp_num=int(rest[0]) if rest else 32,
                    gs_num=int(rest[1]) if len(rest) > 1 else 512)
                print(f"trajectory overlay {'on' if on else 'off'}")
            else:
                print(f"unknown command {cmd!r}")
        except Exception as e:  # noqa: BLE001 — the REPL goes on
            print(f"error: {e}")


if __name__ == "__main__":
    main()
