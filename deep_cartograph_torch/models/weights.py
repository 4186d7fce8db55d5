"""Carry trained CVs across from the JAX package, as numpy arrays.

Flax `Dense` stores `kernel` (in, out); `torch.nn.Linear` stores `weight`
(out, in), so every kernel is transposed. The JAX side's parameter tree of
a deep-TICA calculator is {"nn": {"dense_<i>": {"kernel", "bias"},
"bn_scale_<i>", "bn_bias_<i>"}}.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from deep_cartograph_torch.deploy import DeepTICAProjection, LinearProjection
from deep_cartograph_torch.models.networks import DeepTICANet


def _tensor(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


def _feedforward_state(tree: Dict, n_transitions: int) -> Dict[str, torch.Tensor]:
    state = {}
    for i in range(n_transitions):
        dense = tree[f"dense_{i}"]
        state[f"dense.{i}.weight"] = _tensor(dense["kernel"]).T.contiguous()
        state[f"dense.{i}.bias"] = _tensor(dense["bias"])
        if f"bn_scale_{i}" in tree:
            state[f"bn_scale.{i}"] = _tensor(tree[f"bn_scale_{i}"])
            state[f"bn_bias.{i}"] = _tensor(tree[f"bn_bias_{i}"])
    return state


def deep_tica_from_jax(
    params: Dict,
    architecture: Dict,
    tica_evecs: Optional[np.ndarray],
    post_mean: Optional[np.ndarray],
    post_range: Optional[np.ndarray],
) -> DeepTICAProjection:
    """A `DeepTICAProjection` computing what the JAX deep-TICA calculator
    projects. `params` is the calculator's parameter tree as numpy arrays;
    `architecture` its architecture dict (layers, encoder_options,
    norm_mean, norm_range)."""
    layers = list(architecture["layers"])
    net = DeepTICANet(
        layers,
        architecture.get("encoder_options") or {},
        norm_mean=architecture.get("norm_mean"),
        norm_range=architecture.get("norm_range"),
    )
    net.nn.load_state_dict(_feedforward_state(params["nn"], len(layers) - 1))
    return DeepTICAProjection(net, tica_evecs, post_mean, post_range)


def linear_from_jax(
    features_norm_mean: np.ndarray,
    features_norm_range: np.ndarray,
    cv: np.ndarray,
    cv_norm_mean: np.ndarray,
    cv_norm_range: np.ndarray,
) -> LinearProjection:
    """A `LinearProjection` from a JAX linear calculator's arrays."""
    return LinearProjection(
        features_norm_mean, features_norm_range, cv, cv_norm_mean, cv_norm_range
    )
