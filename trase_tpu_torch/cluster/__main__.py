"""Clustering CLI of the port: ``python -m trase_tpu_torch.cluster``.

Counterpart of the repository's root cluster.py, with the same flags plus
``--device``: reads point_cloud/iteration_N/point_cloud.ply of a model
directory and writes clusters.pt (HDBSCAN on the host) or, with
``--kmeans``, clusters_kmeans.pt (k-means++ init on the host, Lloyd
iterations on ``--device``: ``cuda``, the default, or ``cpu``). The
shell pipeline is

    python -m trase_tpu_torch.train -> python -m trase_tpu_torch.cluster
      -> python -m trase_tpu_torch.render --segment_ids
      -> python -m trase_tpu_torch.metrics_segmentation
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    from ..data.ply import read_ply
    from ..utils.general import search_for_max_iteration
    from .clustering import hdbscan_cluster, kmeans_cluster, save_clusters

    ap = argparse.ArgumentParser(description="Cluster gaussian features")
    ap.add_argument("--model_path", "-m", required=True)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--kmeans", action="store_true",
                    help="k-means instead of HDBSCAN (gui.py:248-269)")
    ap.add_argument("--k", type=int, default=64,
                    help="k-means cluster count (gui.py:171 default)")
    ap.add_argument("--sample_percent", type=float, default=0.02)
    ap.add_argument("--min_cluster_size", type=int, default=10)
    ap.add_argument("--cluster_selection_epsilon", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the k-means iterations run: cuda (the "
                         "card, default) or cpu")
    args = ap.parse_args(argv)

    pc_dir = os.path.join(args.model_path, "point_cloud")
    it = args.iteration
    if it < 0:
        it = search_for_max_iteration(pc_dir)
        if it is None:
            raise SystemExit(f"no snapshots under {pc_dir}")
    ply_path = os.path.join(pc_dir, f"iteration_{it}", "point_cloud.ply")
    if not os.path.exists(ply_path):
        raise SystemExit(f"snapshot not found: {ply_path}")

    props = read_ply(ply_path)
    feat_names = sorted((k for k in props if k.startswith("gaussian_feats_")),
                        key=lambda s: int(s.split("_")[-1]))
    if not feat_names:
        raise SystemExit(f"{ply_path} has no gaussian_feats_* properties")
    feats = np.stack([props[k] for k in feat_names], axis=1).astype(
        np.float32)
    print(f"Loaded {feats.shape[0]} gaussians x {feats.shape[1]}-dim "
          f"features from {ply_path}")

    if args.kmeans:
        ids, rgb, _ = kmeans_cluster(feats, k=args.k, seed=args.seed,
                                     device=args.device)
        out = os.path.join(pc_dir, f"iteration_{it}", "clusters_kmeans.pt")
        n_clusters = args.k
    else:
        ids, rgb, _, n_clusters = hdbscan_cluster(
            feats, sample_percent=args.sample_percent,
            min_cluster_size=args.min_cluster_size,
            cluster_selection_epsilon=args.cluster_selection_epsilon,
            seed=args.seed)
        out = os.path.join(pc_dir, f"iteration_{it}", "clusters.pt")

    save_clusters(out, ids, rgb)
    sizes = np.bincount(ids, minlength=n_clusters)
    print(f"{n_clusters} clusters -> {out}")
    print("cluster sizes:", sizes[:32].tolist(),
          "..." if n_clusters > 32 else "")


if __name__ == "__main__":
    main()
