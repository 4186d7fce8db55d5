"""Figures (matplotlib, on the host).

The port of the JAX package's figures/plots.py: FES and CV plots, cluster
scatter and size plots, line plots of data series, sensitivity bars and
training-metric curves. Where the JAX package passes a DataFrame, the
port passes a dict of numpy columns.

matplotlib is imported inside the drawing functions only (`pyplot`), so
the port imports and runs without it. A figure asked for without
matplotlib raises an ImportError that names the package.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def pyplot():
    """matplotlib.pyplot on the Agg backend; raises, naming matplotlib,
    when it is not installed."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(
            "Drawing this figure needs matplotlib, which is not installed. "
            "Install matplotlib, or turn the figure off in the configuration "
            "(figures.plot, traj_projection.plot, fes.compute, plot_loss)."
        ) from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_metrics(
    metrics: Dict[str, List],
    keys: Sequence[str],
    labels: Sequence[str],
    yscale: Optional[str] = "log",
    path: Optional[str] = None,
    ylabel: str = "Loss",
):
    """Training-metric curves against the epoch."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    x = metrics.get("epoch", list(range(len(metrics[keys[0]]))))
    for key, label in zip(keys, labels):
        ax.plot(x[: len(metrics[key])], metrics[key], label=label)
    if yscale and yscale != "linear":
        try:
            ax.set_yscale(yscale)
        except ValueError:
            pass
    ax.set_xlabel("Epoch")
    ax.set_ylabel(ylabel)
    ax.legend()
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return None
    return ax


def plot_sensitivity_results(
    results: Dict,
    modes: Sequence[str] = ("barh",),
    output_folder: str = ".",
    max_features: int = 25,
) -> None:
    """Horizontal bars of the largest feature sensitivities."""
    plt = pyplot()
    names = results["feature_names"]
    sens = np.asarray(results["sensitivity"]["Dataset"])
    order = np.argsort(sens)[-max_features:]
    fig, ax = plt.subplots(figsize=(7, max(3, 0.3 * len(order))))
    ax.barh([names[i] for i in order], sens[order], color="#4878d0")
    ax.set_xlabel("Sensitivity")
    fig.savefig(
        os.path.join(output_folder, "sensitivity_barh.png"),
        dpi=150,
        bbox_inches="tight",
    )
    plt.close(fig)


def plot_data(
    y_data: Dict[str, np.ndarray],
    x_data: Dict[str, np.ndarray],
    title: str,
    y_label: str,
    x_label: str,
    figure_path: str,
) -> None:
    """Several data series as lines on one plot."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(7, 4))
    for key, y in y_data.items():
        ax.plot(np.asarray(x_data[key]), np.asarray(y), label=key, linewidth=1)
    ax.set_title(title)
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label)
    if len(y_data) > 1:
        ax.legend(fontsize=7)
    fig.savefig(figure_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def generate_colors(num_colors: int, cmap_name: str = "turbo") -> List:
    """Evenly spaced colors of a colormap."""
    cmap = pyplot().get_cmap(cmap_name)
    if num_colors == 1:
        return [cmap(0.5)]
    return [cmap(i / (num_colors - 1)) for i in range(num_colors)]


def plot_clusters_size(
    cluster_labels: np.ndarray, cluster_colors: List, output_folder: str
) -> None:
    """Bars of the cluster populations."""
    plt = pyplot()
    labels, counts = np.unique(cluster_labels, return_counts=True)
    fig, ax = plt.subplots(figsize=(6, 4))
    colors = cluster_colors if len(cluster_colors) >= len(labels) else None
    ax.bar([str(l) for l in labels], counts, color=colors)
    ax.set_xlabel("Cluster")
    ax.set_ylabel("Number of samples")
    fig.savefig(
        os.path.join(output_folder, "clusters_size.png"), dpi=150, bbox_inches="tight"
    )
    plt.close(fig)


def gradient_scatter_plot(
    data: Mapping[str, np.ndarray],
    column_labels: Sequence[str],
    color_label: str,
    settings: Dict,
    file_path: str,
) -> None:
    """2-D scatter of two columns colored by a third (the frame number)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 5))
    sc = ax.scatter(
        data[column_labels[0]],
        data[column_labels[1]],
        c=data[color_label],
        cmap=settings.get("cmap", "turbo"),
        alpha=settings.get("alpha", 0.8),
        s=settings.get("marker_size", 5),
    )
    fig.colorbar(sc, ax=ax, label=color_label)
    ax.set_xlabel(column_labels[0])
    ax.set_ylabel(column_labels[1])
    fig.savefig(file_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def clusters_scatter_plot(
    data: Mapping[str, np.ndarray],
    column_labels: Sequence[str],
    cluster_label: str,
    settings: Dict,
    file_path: str,
    cluster_colors: Optional[List] = None,
) -> None:
    """2-D scatter colored by cluster, the centroids marked."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 5))
    cluster_column = np.asarray(data[cluster_label])
    clusters = np.unique(cluster_column)
    colors = cluster_colors or generate_colors(
        len(clusters), settings.get("cmap", "turbo")
    )
    x = np.asarray(data[column_labels[0]])
    y = np.asarray(data[column_labels[1]])
    for i, cl in enumerate(clusters):
        rows = cluster_column == cl
        ax.scatter(
            x[rows],
            y[rows],
            color=colors[i % len(colors)],
            alpha=settings.get("alpha", 0.8),
            s=settings.get("marker_size", 5),
            label=f"cluster {cl}",
        )
    if "centroid" in data:
        cents = np.asarray(data["centroid"], bool)
        if cents.any():
            ax.scatter(x[cents], y[cents], marker="x", color="black", s=60,
                       label="centroids")
    ax.set_xlabel(column_labels[0])
    ax.set_ylabel(column_labels[1])
    ax.legend(fontsize=7, markerscale=2)
    fig.savefig(file_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def create_cv_plot(
    fes: np.ndarray,
    grid,
    cv_data: np.ndarray,
    cv_labels: Sequence[str],
    settings: Dict,
    file_path: str,
) -> None:
    """FES contours with the projected CV samples on top."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 5))
    if fes.ndim == 2:
        cs = ax.contourf(
            grid[0], grid[1], fes.T, levels=settings.get("num_fes_levels", 10),
            cmap="viridis",
        )
        fig.colorbar(cs, ax=ax, label="FES (kJ/mol)")
        ax.scatter(cv_data[:, 0], cv_data[:, 1], s=2, c="white", alpha=0.3)
        ax.set_xlabel(cv_labels[0])
        ax.set_ylabel(cv_labels[1])
    fig.savefig(file_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def get_ranges(X: np.ndarray, X_ref=None) -> list:
    """Data range per dimension with a margin: 0.5 % in 1-D, 5 % in N-D
    (a column vector counts as 1-D)."""
    X = np.asarray(X)
    if X.ndim == 1 or (X.ndim == 2 and X.shape[1] == 1):
        lo, hi = float(np.min(X)), float(np.max(X))
        if X_ref is not None:
            for ref in X_ref:
                lo = min(lo, float(np.min(ref)))
                hi = max(hi, float(np.max(ref)))
        offset = 0.005 * (hi - lo)
        return (lo - offset, hi + offset)
    ranges = []
    for i in range(X.shape[1]):
        lo, hi = float(np.min(X[:, i])), float(np.max(X[:, i]))
        if X_ref is not None:
            for ref in X_ref:
                lo = min(lo, float(np.min(ref[:, i])))
                hi = max(hi, float(np.max(ref[:, i])))
        offset = 0.05 * (hi - lo)
        ranges.append((lo - offset, hi + offset))
    return ranges


def generate_cmap(num_colors: int, cmap_name: str = "turbo"):
    """A ListedColormap of evenly spaced colors."""
    colors = generate_colors(num_colors, cmap_name)
    return pyplot().matplotlib.colors.ListedColormap(colors)
