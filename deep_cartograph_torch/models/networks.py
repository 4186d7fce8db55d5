"""Network building blocks for deep collective variables (PyTorch).

The port of the JAX package's models/networks.py: the mlcolvar feed-forward
options (per-layer activation / dropout / batchnorm, input normalization
"norm_in") carry over so configs translate 1:1. Batchnorm is stateless: it
uses the statistics of the batch it is given, in training and in
evaluation alike (no running averages), as on the JAX side.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

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


class Normalization(nn.Module):
    """Fixed affine input normalization: (x - mean) / range.

    Equivalent to mlcolvar's norm_in transform; the parameters are constant
    buffers set at construction (not trained)."""

    def __init__(self, mean, range_):
        super().__init__()
        self.register_buffer("mean", torch.as_tensor(mean, dtype=torch.float32))
        self.register_buffer("range_", torch.as_tensor(range_, dtype=torch.float32))

    def forward(self, x):
        return (x - self.mean) / self.range_


class FeedForward(nn.Module):
    """MLP with per-layer activation / dropout / batchnorm lists.

    layers: full layer widths INCLUDING input and output dims,
    e.g. [in, h1, h2, out]. activation/dropout/batchnorm lists apply to each
    transition (len == len(layers) - 1); None entries are identity.
    Dropout is active only in training mode (`module.train()`).
    """

    def __init__(
        self,
        layers: Sequence[int],
        activation: Sequence[Optional[str]],
        dropout: Sequence[Optional[float]],
        batchnorm: Sequence[bool],
    ):
        super().__init__()
        self.layers = list(layers)
        n = len(self.layers) - 1
        self.activation = [activation[i] if i < len(activation) else None for i in range(n)]
        self.dropout = [dropout[i] if i < len(dropout) else None for i in range(n)]
        self.batchnorm = [bool(batchnorm[i]) if i < len(batchnorm) else False for i in range(n)]
        self.dense = nn.ModuleList(
            nn.Linear(self.layers[i], self.layers[i + 1]) for i in range(n)
        )
        self.bn_scale = nn.ParameterDict({
            str(i): nn.Parameter(torch.ones(self.layers[i + 1]))
            for i in range(n) if self.batchnorm[i]
        })
        self.bn_bias = nn.ParameterDict({
            str(i): nn.Parameter(torch.zeros(self.layers[i + 1]))
            for i in range(n) if self.batchnorm[i]
        })

    def forward(self, x):
        for i, dense in enumerate(self.dense):
            x = dense(x)
            if self.batchnorm[i]:
                # Stateless batch normalization (batch statistics at both
                # train and eval; no running averages).
                mu = torch.mean(x, dim=0, keepdim=True)
                var = torch.var(x, dim=0, keepdim=True, unbiased=False)
                x = (x - mu) / torch.sqrt(var + 1e-5)
                x = x * self.bn_scale[str(i)] + self.bn_bias[str(i)]
            x = ACTIVATIONS[self.activation[i]](x)
            if self.dropout[i]:
                x = F.dropout(x, p=self.dropout[i], training=self.training)
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


class DeepTICANet(nn.Module):
    """DeepTICA network: norm_in -> MLP -> n_cvs nonlinear basis functions.

    The linear TICA combination on top of the basis functions is applied
    outside the module (deploy.DeepTICAProjection).
    """

    def __init__(
        self,
        layers: Sequence[int],
        options: dict,
        norm_mean=None,
        norm_range=None,
    ):
        super().__init__()
        self.layers = list(layers)
        o = _pad_options(options, len(self.layers) - 1)
        self.nn = FeedForward(self.layers, **o)
        self.norm_in = (
            Normalization(norm_mean, norm_range) if norm_mean is not None else None
        )

    def forward(self, x):
        if self.norm_in is not None:
            x = self.norm_in(x)
        return self.nn(x)
