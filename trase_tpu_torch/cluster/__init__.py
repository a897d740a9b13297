from .clustering import (  # noqa: F401
    hdbscan_cluster,
    kmeans_cluster,
    load_clusters,
    postprocessing,
    save_clusters,
    seg_score_assign,
)
