from deep_cartograph_torch.cluster.clustering import (
    assign_nearest_neighbor,
    cluster_data,
    clustering_scores,
    find_centroids,
    hdbscan_clustering,
    hdbscan_fit,
    hierarchical_clustering,
    kmeans_clustering,
    optimize_clustering,
)
