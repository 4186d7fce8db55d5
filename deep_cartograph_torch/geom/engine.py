"""The featurization engine: trajectory -> feature matrix, on one device.

The port of the JAX package's geom/engine.py: frames are decoded on the host
in chunks, copied to the device, and every feature of every frame in the
chunk is evaluated there (geom/kernels.py). Chunks keep their natural
length: the kernels mask the ragged last chunk, so nothing is padded.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from deep_cartograph_torch.features.grammar import compile_plan
from deep_cartograph_torch.geom.kernels import PlanEvaluator
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.io.traj import iter_frame_chunks
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

# Soft budget for per-chunk intermediates on device (bytes).
_CHUNK_BYTE_BUDGET = 1 << 30


def auto_chunk_size(requested: int, n_atoms: int, n_features: int) -> int:
    """Clamp the frame-chunk size so per-chunk intermediates stay in budget."""
    bytes_per_frame = 4 * (12 * n_atoms + 16 * max(n_features, 1))
    max_frames = max(64, _CHUNK_BYTE_BUDGET // max(bytes_per_frame, 1))
    return int(max(1, min(requested, max_frames)))


class Featurizer:
    """Featurization of frame batches for one (feature list, topology) pair."""

    def __init__(
        self,
        topology: Topology,
        features_list: List[str],
        fit_template: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        device: DeviceLike = None,
    ):
        """fit_template: optional (reference_positions, align_weights) applied
        before coordinate features (PLUMED FIT_TO_TEMPLATE equivalent).

        `device`: None means CUDA (raises without a card); "cpu" runs on the
        host."""
        self.topology = topology
        self.features_list = list(features_list)
        self.plan = compile_plan(self.features_list, topology)
        ref, weights = (None, None) if fit_template is None else fit_template
        if self.plan.needs_fit and ref is None:
            raise ValueError(
                "Features contain coordinates but no fit template was provided."
            )
        self.device = resolve_device(device)
        self.evaluator = PlanEvaluator(
            self.plan,
            fit_reference=ref if self.plan.needs_fit else None,
            fit_weights=weights if self.plan.needs_fit else None,
            device=self.device,
        )

    def __call__(self, coords: np.ndarray) -> np.ndarray:
        return self.evaluator(coords)

    def featurize_trajectory(
        self,
        trajectory_path: str,
        traj_stride: int = 1,
        frame_chunk: int = 2048,
        timeout: Optional[float] = None,
    ) -> np.ndarray:
        """Stream a trajectory through the device chunk by chunk.

        Returns the (n_frames, n_features) matrix (nm / radians). `timeout`
        (seconds) bounds the wall clock like the reference's PLUMED
        subprocess timeout.
        """
        chunk = auto_chunk_size(
            frame_chunk, self.topology.n_atoms, self.plan.n_features
        )
        outputs: List[torch.Tensor] = []
        t0 = time.time()
        n_frames = 0
        for block in iter_frame_chunks(
            trajectory_path, chunk, self.topology.source_path, stride=traj_stride
        ):
            if timeout is not None and time.time() - t0 > timeout:
                raise TimeoutError(
                    f"Featurization exceeded the configured timeout of "
                    f"{timeout} s after {n_frames} frames."
                )
            n_frames += block.shape[0]
            # The blocking copy up waits for the work queued before it (the
            # previous chunk's kernels) and for its own bytes; this chunk's
            # kernels are then only queued and run while the host decodes
            # the next chunk. Outputs stay on the device until one download
            # at the end.
            outputs.append(self.evaluator.eval_raw(block))
        if outputs:
            result = torch.cat(outputs).cpu().numpy()
        else:
            result = np.zeros((0, self.plan.n_features), np.float32)
        dt = time.time() - t0
        logger.info(
            "Featurized %d frames x %d features in %.2fs (%.0f frames/s)",
            n_frames,
            self.plan.n_features,
            dt,
            n_frames / max(dt, 1e-9),
        )
        return result
