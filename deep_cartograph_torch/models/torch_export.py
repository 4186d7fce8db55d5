"""TorchScript weights of a trained deep CV (`cv_weights.pt` in model.zip,
`<cv>_weights.pt` in the PLUMED files).

PLUMED's PYTORCH_MODEL action loads a deep CV as TorchScript, so model.zip
and the PLUMED zips carry one. The JAX package rebuilds a torch module from
its Flax parameters to trace it; the port's CV already is a torch module
(`deploy.NetProjection`: input normalization, network, deep-TICA's TICA
combination, post-normalization), so it is traced as it is, on the device
asked for, and saved with its tensors on the CPU, where PLUMED loads it.
`TorchScriptProjector` serves a model.zip that holds only TorchScript
weights (one written by the reference toolkit).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from deep_cartograph_torch.utils.device import DeviceLike, resolve_device


def check_exportable(architecture: Optional[Dict]) -> None:
    """Refuse an architecture that still has batchnorm flags: its net
    normalizes with the statistics of each batch it sees, so a trace of it
    would deploy another CV. Trained nets fold batchnorm before they are
    saved (`cv/deep.py::NonLinear._fold_batchnorm_for_eval`)."""
    for key in ("encoder_options", "decoder_options"):
        opts = (architecture or {}).get(key) or {}
        if any(bool(b) for b in opts.get("batchnorm", [])):
            raise ValueError(
                f"TorchScript export of unfolded batchnorm layers is not supported "
                f"({key} has active batchnorm); fold it into the dense layers first."
            )


def save_torchscript(projection: nn.Module, n_features: int, path: str,
                     device: DeviceLike = None) -> None:
    """Trace a copy of `projection` on a (1, n_features) input on `device`
    (None means CUDA, raising without a card; "cpu" runs on the host) and
    save it with its tensors on the CPU."""
    dev = resolve_device(device)
    module = copy.deepcopy(projection).to(dev).eval()
    example = torch.zeros(1, n_features, dtype=torch.float32, device=dev)
    with torch.no_grad():
        traced = torch.jit.trace(module, example)
    traced.cpu().save(path)


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
