from deep_cartograph_torch.figures.plots import (
    clusters_scatter_plot,
    create_cv_plot,
    generate_cmap,
    generate_colors,
    get_ranges,
    gradient_scatter_plot,
    plot_clusters_size,
    plot_data,
    plot_metrics,
    plot_sensitivity_results,
)
