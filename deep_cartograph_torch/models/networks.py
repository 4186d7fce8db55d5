"""Network building blocks for deep collective variables (PyTorch).

The port of the JAX package's models/networks.py: the mlcolvar feed-forward
options (per-layer activation / dropout / batchnorm, input normalization
"norm_in") carry over so configs translate 1:1. Batchnorm is stateless: it
uses the statistics of the batch it is given, in training and in
evaluation alike (no running averages), as on the JAX side.

One forward, `feedforward_stack`, owns the layer rules. Parameters are a
flat dict of tensors named like the Flax tree ("nn/dense_0/kernel") with a
leading tries axis T: kernels (T, in, out), biases (T, out). The forward is
one `torch.baddbmm` per layer over (T, B, in) inputs; this replaces the JAX
side's `vmap` over `init` and over the epoch program. `DeepTICAStack` is
the deep-TICA net of a training run's T seeded tries; `DeepTICANet` is one
trained try as an `nn.Module` for serving (`deploy.py`), the same forward
with T = 1.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS: dict = {
    None: lambda x: x,
    "linear": lambda x: x,
    "relu": F.relu,
    "elu": F.elu,
    "tanh": torch.tanh,
    "softplus": F.softplus,
    "shifted_softplus": lambda x: F.softplus(x) - math.log(2.0),
    "custom_sigmoid": torch.sigmoid,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.01),
}


Params = Dict[str, torch.Tensor]

# Flax's truncated normal keeps [-2, 2] standard deviations; dividing by the
# std of the truncated unit normal restores the variance 1/fan_in.
_TRUNCATED_NORMAL_STD = 0.87962566103423978


def lecun_normal_(tensor: torch.Tensor, fan_in: int, generator) -> torch.Tensor:
    """Flax `Dense`'s default kernel init (`lecun_normal`): a truncated
    normal of variance 1/fan_in. (`torch.nn.Linear` uses kaiming-uniform.)"""
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_NORMAL_STD
    return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def init_feedforward_stack(
    layers: Sequence[int], batchnorm: Sequence[bool], seeds: Sequence[int],
    prefix: str = "",
) -> Params:
    """Flax-like initial parameters for one try per seed, stacked on a
    leading tries axis: kernels from a CPU `torch.Generator` seeded per try
    (so the CPU and the card start from the same numbers), zero biases,
    batchnorm scale 1 and bias 0."""
    gens = [torch.Generator().manual_seed(int(s)) for s in seeds]
    T = len(gens)
    params: Params = {}
    for i in range(len(layers) - 1):
        fan_in, fan_out = layers[i], layers[i + 1]
        kernel = torch.empty((T, fan_in, fan_out))
        for t, gen in enumerate(gens):
            lecun_normal_(kernel[t], fan_in, gen)
        params[f"{prefix}dense_{i}/kernel"] = kernel
        params[f"{prefix}dense_{i}/bias"] = torch.zeros((T, fan_out))
        if i < len(batchnorm) and batchnorm[i]:
            params[f"{prefix}bn_scale_{i}"] = torch.ones((T, fan_out))
            params[f"{prefix}bn_bias_{i}"] = torch.zeros((T, fan_out))
    return params


def _dropout_stack(x: torch.Tensor, rate: float, generators) -> torch.Tensor:
    """Dropout on (T, B, F) with try t's mask drawn from generators[t]."""
    keep = torch.stack([
        torch.rand(x.shape[1:], generator=g, device=x.device) for g in generators
    ]) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def feedforward_stack(
    params: Params,
    x: torch.Tensor,
    activation: Sequence[Optional[str]],
    dropout: Sequence[Optional[float]],
    batchnorm: Sequence[bool],
    train: bool = False,
    generators: Optional[List[torch.Generator]] = None,
    prefix: str = "",
) -> torch.Tensor:
    """The MLP of T tries at once: x (T, B, in) -> (T, B, out).

    Batchnorm takes each try's statistics over its whole batch (padded rows
    of a ragged batch included, as on the JAX side). Dropout is active
    only with `train=True` and then needs one generator per try."""
    n = sum(1 for k in params if k.startswith(prefix) and k.endswith("/kernel"))
    for i in range(n):
        x = torch.baddbmm(
            params[f"{prefix}dense_{i}/bias"].unsqueeze(1), x,
            params[f"{prefix}dense_{i}/kernel"],
        )
        if i < len(batchnorm) and batchnorm[i]:
            mu = x.mean(1, keepdim=True)
            var = x.var(1, keepdim=True, unbiased=False)
            x = (x - mu) / torch.sqrt(var + 1e-5)
            x = (x * params[f"{prefix}bn_scale_{i}"].unsqueeze(1)
                 + params[f"{prefix}bn_bias_{i}"].unsqueeze(1))
        x = ACTIVATIONS[activation[i] if i < len(activation) else None](x)
        rate = dropout[i] if i < len(dropout) else None
        if rate and train:
            x = _dropout_stack(x, rate, generators)
    return x


def _pad_options(options: dict, n_transitions: int) -> dict:
    """Extend per-layer option lists to the number of transitions."""
    out = {}
    for key, default in (("activation", None), ("dropout", None), ("batchnorm", False)):
        vals = list(options.get(key) or [])
        while len(vals) < n_transitions:
            vals.append(default)
        out[key] = vals[:n_transitions]
    return out


def _optional_buffer(module: nn.Module, name: str, value) -> None:
    module.register_buffer(
        name, None if value is None else torch.as_tensor(value, dtype=torch.float32)
    )


class DeepTICAStack(nn.Module):
    """The deep-TICA network of T seeded tries: norm_in, then the stacked
    MLP under the parameter names of the Flax `DeepTICANet` ("nn/...").
    The module holds only the fixed input normalization; the trained
    parameters are passed to each call."""

    def __init__(self, layers: Sequence[int], options: dict,
                 norm_mean=None, norm_range=None):
        super().__init__()
        self.layers = list(layers)
        self.options = _pad_options(options, len(self.layers) - 1)
        _optional_buffer(self, "norm_mean", norm_mean)
        _optional_buffer(self, "norm_range", norm_range)

    def init(self, seeds: Sequence[int]) -> Params:
        return init_feedforward_stack(
            self.layers, self.options["batchnorm"], seeds, prefix="nn/"
        )

    def forward(self, params: Params, x: torch.Tensor, train: bool = False,
                generators: Optional[List[torch.Generator]] = None):
        """x (T, B, in) -> (T, B, n_cvs)."""
        if self.norm_mean is not None:
            x = (x - self.norm_mean) / self.norm_range
        return feedforward_stack(params, x, train=train, generators=generators,
                                 prefix="nn/", **self.options)


class DeepTICANet(nn.Module):
    """One trained deep-TICA net, (B, in) -> (B, n_cvs): `DeepTICAStack`
    with a single try. `params` are one try's, without the tries axis. The
    linear TICA combination on top is applied outside the module
    (deploy.DeepTICAProjection)."""

    def __init__(self, layers: Sequence[int], options: dict, params: Params,
                 norm_mean=None, norm_range=None):
        super().__init__()
        self.stack = DeepTICAStack(layers, options, norm_mean, norm_range)
        self.names = list(params)
        for i, name in enumerate(self.names):
            self.register_buffer(f"param_{i}", params[name].detach()
                                 .to(torch.float32).unsqueeze(0).clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = {name: getattr(self, f"param_{i}")
                  for i, name in enumerate(self.names)}
        return self.stack(params, x.unsqueeze(0))[0]
