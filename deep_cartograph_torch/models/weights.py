"""Carry network parameters between the JAX package's layout and the port's.

The JAX side's parameter tree of a deep-TICA calculator is {"nn":
{"dense_<i>": {"kernel", "bias"}, "bn_scale_<i>", "bn_bias_<i>"}}. The
port's parameters are the same tree flattened to "nn/dense_<i>/kernel"
keys, with Flax's (in, out) kernels, so they carry across unchanged, with
or without a leading tries axis. A model.zip stores them as the JAX
package does, in Flax's msgpack layout (`flax_params.msgpack`), through
`models/msgpack.py`: `save_params` / `load_params`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from deep_cartograph_torch.deploy import DeepTICAProjection, LinearProjection
from deep_cartograph_torch.models import msgpack
from deep_cartograph_torch.models.networks import DeepTICANet


def flatten_tree(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """{"nn": {"dense_0": {"kernel": a}}} -> {"nn/dense_0/kernel": a}."""
    flat = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            flat.update(flatten_tree(value, f"{prefix}{key}/"))
        else:
            flat[f"{prefix}{key}"] = value
    return flat


def unflatten_tree(flat: Dict) -> Dict:
    tree: Dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def params_from_flax(tree: Dict) -> Dict[str, torch.Tensor]:
    """A Flax parameter tree (numpy leaves; e.g. the JAX side's
    `_init_params_stack` output, leading tries axis kept) -> the port's
    flat float32 parameters."""
    return {k: _tensor(v) for k, v in flatten_tree(tree).items()}


def params_to_flax(params: Dict[str, torch.Tensor]) -> Dict:
    """The port's flat parameters -> a Flax parameter tree of numpy arrays,
    which the JAX package's modules `apply` unchanged."""
    return unflatten_tree(
        {k: v.detach().cpu().numpy() for k, v in params.items()}
    )


def save_params(params: Dict[str, torch.Tensor], path: str) -> None:
    """The port's parameters as a Flax msgpack file (what Flax's
    `to_bytes` writes for the same tree)."""
    with open(path, "wb") as fh:
        fh.write(msgpack.packb(params_to_flax(params)))


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """A Flax msgpack parameter file as the port's parameters."""
    with open(path, "rb") as fh:
        return params_from_flax(msgpack.unpackb(fh.read()))


def _tensor(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


def deep_tica_from_jax(
    params: Dict,
    architecture: Dict,
    tica_evecs: Optional[np.ndarray],
    post_mean: Optional[np.ndarray],
    post_range: Optional[np.ndarray],
) -> DeepTICAProjection:
    """A `DeepTICAProjection` computing what a JAX deep-TICA calculator
    projects. `params` is the calculator's parameter tree, as numpy arrays;
    `architecture` its architecture dict (layers, encoder_options,
    norm_mean, norm_range)."""
    net = DeepTICANet(
        architecture["layers"],
        architecture.get("encoder_options") or {},
        params_from_flax(params),
        norm_mean=architecture.get("norm_mean"),
        norm_range=architecture.get("norm_range"),
    )
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
