"""Serving: frames -> CV values on the device.

The port of the JAX package's deploy.py: `FramesToCV` featurizes a chunk of
frames with a `PlanEvaluator` and projects the features through a trained
CV, without leaving the device between the two steps:

    pipeline = FramesToCV(projection, topology, features_list)
    cv_values = pipeline(coords_chunk)      # (C, A, 3) -> (C, dim)

A projection is one of the two modules below; `models/weights.py` builds
them from a trained CV's arrays.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from deep_cartograph_torch.features.grammar import compile_plan
from deep_cartograph_torch.geom.kernels import PlanEvaluator
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.models.networks import DeepTICANet
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device


def _buffer(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


class LinearProjection(nn.Module):
    """Linear CV (PCA/TICA/HTICA): normalize features, project, normalize."""

    def __init__(self, features_norm_mean, features_norm_range, cv,
                 cv_norm_mean, cv_norm_range):
        super().__init__()
        self.register_buffer("fmean", _buffer(features_norm_mean))
        self.register_buffer("frange", _buffer(features_norm_range))
        self.register_buffer("weights", _buffer(cv))
        self.register_buffer("cmean", _buffer(cv_norm_mean))
        self.register_buffer("crange", _buffer(cv_norm_range))

    def forward(self, features):
        normalized = (features - self.fmean) / self.frange
        return (normalized @ self.weights - self.cmean) / self.crange


class DeepTICAProjection(nn.Module):
    """Deep-TICA CV: network, then the TICA combination of its outputs,
    then the min-max post normalization (each optional, as on the JAX
    side)."""

    def __init__(self, net: DeepTICANet, tica_evecs=None, post_mean=None,
                 post_range=None):
        super().__init__()
        self.net = net
        for name, value in (("tica_evecs", tica_evecs), ("post_mean", post_mean),
                            ("post_range", post_range)):
            self.register_buffer(name, None if value is None else _buffer(value))

    def forward(self, features):
        out = self.net(features)
        if self.tica_evecs is not None:
            out = out @ self.tica_evecs
        if self.post_mean is not None:
            out = (out - self.post_mean) / self.post_range
        return out


class FramesToCV:
    """Featurize + project pipeline for a trained CV on one topology."""

    def __init__(
        self,
        projection: nn.Module,
        topology: Topology,
        features_list: List[str],
        device: DeviceLike = None,
    ):
        """`device`: None means CUDA (raises without a card); "cpu" runs on
        the host."""
        self.device = resolve_device(device)
        self.topology = topology
        self.plan = compile_plan(list(features_list), topology)
        self.evaluator = PlanEvaluator(self.plan, device=self.device)
        self.projection = projection.to(self.device).eval()

    @torch.no_grad()
    def eval_raw(self, coords) -> torch.Tensor:
        """(C, A, 3) Angstrom frames -> (C, cv_dimension) device tensor."""
        return self.projection(self.evaluator.eval_raw(coords))

    def __call__(self, coords) -> np.ndarray:
        """(C, A, 3) Angstrom frames -> (C, cv_dimension) CV values."""
        return self.eval_raw(coords).cpu().numpy()
