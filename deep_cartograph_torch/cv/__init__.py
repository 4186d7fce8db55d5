"""CV calculators of the port and their registry (`cv_calculators_map`,
which `CVCalculator.load` reads a model.zip's `cv_name` against)."""

from deep_cartograph_torch.cv.base import CVCalculator, cv_components_map, cv_names_map
from deep_cartograph_torch.cv.deep import (
    AECalculator,
    DeepTICACalculator,
    NonLinear,
    VAECalculator,
)
from deep_cartograph_torch.cv.linear import (
    HTICACalculator,
    LinearCalculator,
    PCACalculator,
    TICACalculator,
)
from deep_cartograph_torch.cv.umap_cv import UMAP


cv_calculators_map = {
    "pca": PCACalculator,
    "ae": AECalculator,
    "tica": TICACalculator,
    "htica": HTICACalculator,
    "deep_tica": DeepTICACalculator,
    "vae": VAECalculator,
    "umap": UMAP,
}

__all__ = [
    "CVCalculator", "LinearCalculator", "NonLinear", "PCACalculator",
    "TICACalculator", "HTICACalculator", "DeepTICACalculator", "AECalculator",
    "VAECalculator", "UMAP", "cv_calculators_map", "cv_names_map",
    "cv_components_map",
]
