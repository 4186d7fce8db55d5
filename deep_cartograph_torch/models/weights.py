"""Carry network parameters between the JAX package's layout and the port's.

The JAX side's parameter tree of a deep CV calculator is Flax's: deep-TICA
{"nn": {"dense_<i>": {"kernel", "bias"}, "bn_scale_<i>", "bn_bias_<i>"}};
the autoencoder {"encoder": {...}, "decoder": {...}}; the VAE {"encoder",
"mean_nn": {"kernel", "bias"}, "log_var_nn", "decoder"}. The port's
parameters are the same tree flattened to "nn/dense_<i>/kernel" keys, with
Flax's (in, out) kernels, so they carry across unchanged, with or without
a leading tries axis. A model.zip stores them as the JAX
package does, in Flax's msgpack layout (`flax_params.msgpack`), through
`models/msgpack.py`: `save_params` / `load_params`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from deep_cartograph_torch.deploy import LinearProjection, NetProjection
from deep_cartograph_torch.models import msgpack
from deep_cartograph_torch.models.networks import (
    DeepTICAStack,
    TrainedNet,
    stack_from_architecture,
)


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
) -> NetProjection:
    """A `NetProjection` computing what a JAX deep-TICA calculator
    projects. `params` is the calculator's parameter tree, as numpy arrays;
    `architecture` its architecture dict (layers, encoder_options,
    norm_mean, norm_range)."""
    stack = DeepTICAStack(architecture["layers"], architecture.get("encoder_options") or {},
                          architecture.get("norm_mean"), architecture.get("norm_range"))
    return NetProjection(TrainedNet(stack, params_from_flax(params)), tica_evecs,
                         post_mean, post_range)


def _autoencoder_from_jax(params: Dict, architecture: Dict, kind: str) -> NetProjection:
    if architecture["kind"] != kind:
        raise ValueError(f"expected a {kind} architecture, got {architecture['kind']}")
    net = TrainedNet(stack_from_architecture(architecture), params_from_flax(params))
    return NetProjection(net, None, architecture.get("post_mean"),
                         architecture.get("post_range"))


def ae_from_jax(params: Dict, architecture: Dict) -> NetProjection:
    """A `NetProjection` computing what a JAX autoencoder calculator
    projects (the encoder's latent, then the post normalization). `params`
    is the calculator's parameter tree, as numpy arrays; `architecture` its
    architecture dict, post_mean and post_range included."""
    return _autoencoder_from_jax(params, architecture, "ae")


def vae_from_jax(params: Dict, architecture: Dict) -> NetProjection:
    """As `ae_from_jax`, for a JAX VAE calculator (the latent mean)."""
    return _autoencoder_from_jax(params, architecture, "vae")


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
