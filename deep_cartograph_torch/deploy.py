"""Serving: frames -> CV values on the device.

The port of the JAX package's deploy.py: `FramesToCV` featurizes a chunk of
frames (geom/engine.py's `ShardedChunkEvaluator`) and projects the features
through a trained CV, without leaving the device between the two steps:

    pipeline = FramesToCV(projection, topology, features_list)
    cv_values = pipeline(coords_chunk)      # (C, A, 3) -> (C, dim)

A projection is one of the two modules below (linear CVs; deep-TICA, AE
and VAE); `models/weights.py` builds them from a trained CV's arrays, and
a trained calculator gives its own (`projection()`).
`FramesToCV.from_model_zip` serves a saved model.zip of any family:

    pipeline = FramesToCV.from_model_zip("model.zip", "topology.pdb")

Every batch is sharded by frames over `parallel.mesh.mesh_for(device)`
(the device alone unless the caller set a mesh with
`parallel.mesh.use_mesh`): each device's worker copies its slice up,
featurizes it (K1) and projects it through the device's own copy of the
projection, and the CV values are gathered in frame order on the mesh's
first device. Host frames go up a chunk at a time, only the atoms the
features read, through the pinned ring of the device's evaluator
(geom/kernels.py): a chunk is copied while the device featurizes and
projects the one before, its CV rows are written into the call's output,
and the whole feature matrix is never held at once.
"""

from __future__ import annotations

import copy
import tempfile
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from deep_cartograph_torch.features.grammar import compile_plan
from deep_cartograph_torch.geom.engine import ShardedChunkEvaluator
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.models.networks import TrainedNet
from deep_cartograph_torch.parallel.mesh import mesh_for, split
from deep_cartograph_torch.parallel.sharding import all_gather
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device
from deep_cartograph_torch.utils.profiling import annotate


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


class NetProjection(nn.Module):
    """Deep CV (deep-TICA, AE, VAE): a single-try net (`TrainedNet`), then
    deep-TICA's TICA combination of its outputs, then the min-max post
    normalization (each optional, as on the JAX side)."""

    def __init__(self, net: TrainedNet, tica_evecs=None, post_mean=None,
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
        the host. Batches shard over `mesh_for(device)`."""
        self.device = resolve_device(device)
        self.topology = topology
        self.plan = compile_plan(list(features_list), topology)
        self.projection = projection.to(self.device).eval()
        self.mesh = mesh_for(self.device)
        self.evaluator = ShardedChunkEvaluator(self.plan, self.mesh)
        self._projections = {self.mesh.devices[0]: self.projection}
        for dev in self.mesh.devices:
            if dev not in self._projections:
                self._projections[dev] = copy.deepcopy(projection).to(dev).eval()

    @torch.no_grad()
    def eval_raw(self, coords) -> torch.Tensor:
        """(C, A, 3) Angstrom frames -> (C, cv_dimension) device tensor."""

        def project(features):   # each chunk's features, as they come
            with annotate("serve.project"):
                return self._projections[features.device](features)

        cvs = self.evaluator.eval_local(split(coords, self.mesh), project)
        return all_gather(cvs, self.mesh.local())

    @annotate("serve.call")
    def __call__(self, coords) -> np.ndarray:
        """(C, A, 3) Angstrom frames -> (C, cv_dimension) CV values."""
        cvs = self.eval_raw(coords)
        with annotate("transfer.d2h"):
            return cvs.cpu().numpy()

    @classmethod
    def from_model_zip(
        cls,
        model_path: str,
        topology_path: str,
        output_path: Optional[str] = None,
        device: DeviceLike = None,
    ) -> "FramesToCV":
        """Serve a model.zip (written by the port or by the JAX package) on
        `topology_path`: the model's features are translated from its
        reference topology onto this one. `device`: None means CUDA.
        Without `output_path` the model is unpacked into a temporary
        directory that is removed once the pipeline is built."""
        if output_path is None:
            with tempfile.TemporaryDirectory() as tmp:
                return cls.from_model_zip(model_path, topology_path, tmp, device)

        from deep_cartograph_torch.cv.base import CVCalculator
        from deep_cartograph_torch.features.translator import Translator

        calculator = CVCalculator.load(model_path, output_path, device=device)
        if calculator.ref_topology_path is None:
            raise ValueError(f"{model_path} holds no reference topology to translate "
                             "its features from.")
        translated = Translator(calculator.ref_topology_path, topology_path,
                                calculator.features_ref_labels).run()
        if None in translated:
            raise ValueError(
                "Some model features cannot be translated to the serving topology."
            )
        return cls(calculator.projection(), Topology.from_file(topology_path),
                   translated, device=device)
