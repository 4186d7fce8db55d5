"""TorchScript weights of a trained deep CV (`cv_weights.pt` in model.zip).

PLUMED's PYTORCH_MODEL action loads a deep CV as TorchScript, so model.zip
carries one. The JAX package rebuilds a torch module from its Flax
parameters to trace it; the port's CV already is a torch module
(`deploy.DeepTICAProjection`: input normalization, network, TICA
combination, post-normalization), so it is traced as it is, on the CPU.
`TorchScriptProjector` serves a model.zip that holds only TorchScript
weights (one written by the reference toolkit).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from deep_cartograph_torch.utils.device import DeviceLike, resolve_device


def save_torchscript(projection: nn.Module, n_features: int, path: str) -> None:
    """Trace a CPU copy of `projection` on a (1, n_features) input and save
    it."""
    module = copy.deepcopy(projection).cpu().eval()
    example = torch.zeros(1, n_features, dtype=torch.float32)
    with torch.no_grad():
        traced = torch.jit.trace(module, example)
    traced.save(path)


class TorchScriptProjector:
    """Projection through TorchScript weights, on `device` (None means
    CUDA, raising without a card; "cpu" runs on the host)."""

    def __init__(self, weights_path: str, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.module = torch.jit.load(weights_path, map_location=self.device).eval()

    def __call__(self, data) -> np.ndarray:
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.asarray(data, np.float32))
        x = data.to(self.device, torch.float32)
        with torch.no_grad():
            return self.module(x).cpu().numpy()
