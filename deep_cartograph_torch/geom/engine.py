"""The featurization engine: trajectory -> feature matrix.

The port of the JAX package's geom/engine.py: frames are decoded on the host
in chunks, copied to the device, and every feature of every frame in the
chunk is evaluated there (geom/kernels.py). Chunks keep their natural
length: the kernels mask the ragged last chunk, so nothing is padded.

The Featurizer shards the frames of every chunk over
`parallel.mesh.mesh_for(device)` (`ShardedChunkEvaluator`; the device
alone unless the caller set a mesh with `parallel.mesh.use_mesh`): each
device's worker copies its contiguous slice of frames up and featurizes
it through K1, and the outputs are gathered in frame order on the mesh's
first device.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from deep_cartograph_torch.features.grammar import compile_plan
from deep_cartograph_torch.geom.kernels import PlanEvaluator
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.io.traj import iter_frame_chunks
from deep_cartograph_torch.io.upload import resolve_upload_mode, upload_coords_sharded
from deep_cartograph_torch.parallel.mesh import Mesh, get_mesh, mesh_for, run_per_device, split
from deep_cartograph_torch.parallel.sharding import all_gather
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device
from deep_cartograph_torch.utils.profiling import annotate

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
        host. Each call shards its frames over `mesh_for(device)`: the
        caller's mesh, else the device alone (the JAX package shards over
        every device)."""
        self.topology = topology
        self.features_list = list(features_list)
        self.plan = compile_plan(self.features_list, topology)
        ref, weights = (None, None) if fit_template is None else fit_template
        if self.plan.needs_fit and ref is None:
            raise ValueError(
                "Features contain coordinates but no fit template was provided."
            )
        self.device = resolve_device(device)
        self._fit = (ref, weights) if self.plan.needs_fit else (None, None)
        self._evaluators: dict = {}

    @property
    def evaluator(self) -> "ShardedChunkEvaluator":
        """The evaluator of a call made now, over `mesh_for(self.device)`."""
        return self._evaluator_for(mesh_for(self.device))

    def _evaluator_for(self, mesh: Mesh) -> "ShardedChunkEvaluator":
        if mesh.devices not in self._evaluators:
            self._evaluators[mesh.devices] = ShardedChunkEvaluator(self.plan, mesh, *self._fit)
        return self._evaluators[mesh.devices]

    def __call__(self, coords: np.ndarray) -> np.ndarray:
        return self.evaluator(coords)

    def featurize_frames_sharded(self, coords, mesh: Optional[Mesh] = None
                                 ) -> Tuple[List[torch.Tensor], int]:
        """Featurize a frame batch with the frame axis sharded over `mesh`
        (default `get_mesh()`): each device evaluates its contiguous slice
        of frames through K1, and the outputs stay there. Returns (the
        per-device outputs in frame order, the frame count);
        `torch.cat` of the outputs on one device is the feature matrix."""
        mesh = mesh or get_mesh()
        return self._evaluator_for(mesh).eval_local(split(coords, mesh)), len(coords)

    @annotate("featurize.trajectory")
    def featurize_trajectory(
        self,
        trajectory_path: str,
        traj_stride: int = 1,
        frame_chunk: int = 2048,
        timeout: Optional[float] = None,
        upload: str = "float32",
    ) -> np.ndarray:
        """Stream a trajectory through the device chunk by chunk.

        Returns the (n_frames, n_features) matrix (nm / radians). `timeout`
        (seconds) bounds the wall clock like the reference's PLUMED
        subprocess timeout. `upload` picks the host-to-device transport:
        "float32" (exact, the default), "int16" (fixed point, half the
        bytes, io/upload.py) or "auto" (DC_TPU_UPLOAD, float32 when unset).
        The setting is read only where a caller passes "auto": a
        DC_TPU_UPLOAD set for a JAX run leaves the default exact.
        """
        upload_mode = resolve_upload_mode(upload)
        chunk = auto_chunk_size(
            frame_chunk, self.topology.n_atoms, self.plan.n_features
        )
        evaluator = self.evaluator
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
            # The staged copy up (geom/kernels.py) returns once the chunk's
            # atoms are in a pinned slot; its copy and kernels are only
            # queued and run while the host decodes the next chunk. Outputs
            # stay on the device until one download at the end. An int16
            # upload quantizes the chunk on the host and dequantizes it on
            # the device (io/upload.py). (The JAX package pads a short last
            # chunk by repeating its last frame before quantizing: that
            # moves no axis' minimum or maximum, so the unpadded chunk has
            # the same codes.)
            if upload_mode == "int16":
                outputs.append(_eval_quantized(evaluator, block))
            else:
                outputs.append(evaluator.eval_raw(block))
        if outputs:
            result = torch.cat(outputs)
            with annotate("transfer.d2h"):
                result = result.cpu().numpy()
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

    def featurize_trajectories(
        self,
        trajectory_paths: List[str],
        traj_stride: int = 1,
        frame_chunk: int = 2048,
        timeout: Optional[float] = None,
    ) -> List[np.ndarray]:
        """Batch form of iter_featurize_trajectories (original order)."""
        return [
            feats
            for _, feats in self.iter_featurize_trajectories(
                trajectory_paths, traj_stride, frame_chunk, timeout
            )
        ]

    def iter_featurize_trajectories(
        self,
        trajectory_paths: List[str],
        traj_stride: int = 1,
        frame_chunk: int = 2048,
        timeout: Optional[float] = None,
    ) -> Iterator[Tuple[str, np.ndarray]]:
        """Stream N same-topology trajectories through shared chunks: a chunk
        may span a trajectory seam, so only the batch's last chunk is short.

        Yields (path, (n_frames_i, n_features) matrix) per trajectory as soon
        as its last frame has been evaluated (delayed by at most
        `pipeline_depth` chunks), so callers can persist each result as it
        comes and memory stays bounded: at most `pipeline_depth` chunk
        outputs live on the device, and host buffers hold one trajectory's
        features plus one chunk. `timeout` (seconds) applies per trajectory.
        """
        chunk = auto_chunk_size(
            frame_chunk, self.topology.n_atoms, self.plan.n_features
        )
        n_feat = self.plan.n_features
        pipeline_depth = 2
        evaluator = self.evaluator

        buf = np.empty((chunk, self.topology.n_atoms, 3), np.float32)
        fill = 0
        pending: deque = deque()   # device outputs awaiting download
        host_parts: List[np.ndarray] = []
        host_avail = 0             # frames currently in host_parts
        dispatched = 0             # frames sent to the device so far
        consumed = 0               # frames already emitted to trajectories
        finished: deque = deque()  # (path, end_offset)
        t_start = time.time()

        def flush_oldest():
            nonlocal host_avail
            with annotate("transfer.d2h"):
                part = pending.popleft().cpu().numpy()
            host_parts.append(part)
            host_avail += part.shape[0]

        def dispatch():
            nonlocal fill, dispatched
            pending.append(evaluator.eval_raw(buf[:fill]))
            dispatched += fill
            fill = 0
            while len(pending) > pipeline_depth:
                flush_oldest()

        def take(n: int) -> np.ndarray:
            nonlocal host_avail, consumed
            parts: List[np.ndarray] = []
            need = n
            while need:
                head = host_parts[0]
                if head.shape[0] <= need:
                    parts.append(host_parts.pop(0))
                    need -= parts[-1].shape[0]
                else:
                    parts.append(head[:need])
                    host_parts[0] = head[need:]
                    need = 0
            host_avail -= n
            consumed += n
            if not parts:
                return np.zeros((0, n_feat), np.float32)
            return parts[0] if len(parts) == 1 else np.concatenate(parts)

        def ready():
            while finished and finished[0][1] <= dispatched:
                path, end = finished.popleft()
                while host_avail < end - consumed:
                    flush_oldest()
                yield path, take(end - consumed)

        offset = 0
        for path in trajectory_paths:
            t0 = time.time()
            for block in iter_frame_chunks(
                path, chunk, self.topology.source_path, stride=traj_stride
            ):
                if timeout is not None and time.time() - t0 > timeout:
                    raise TimeoutError(
                        f"Featurization of {path} exceeded the configured "
                        f"timeout of {timeout} s."
                    )
                offset += block.shape[0]
                pos = 0
                while pos < block.shape[0]:
                    n = min(chunk - fill, block.shape[0] - pos)
                    buf[fill : fill + n] = block[pos : pos + n]
                    fill += n
                    pos += n
                    if fill == chunk:
                        dispatch()
            finished.append((path, offset))
            yield from ready()
        if fill:
            dispatch()
        yield from ready()
        if finished:
            raise RuntimeError("trajectory frames unaccounted for")
        dt = time.time() - t_start
        logger.info(
            "Featurized %d trajectories (%d frames x %d features) in %.2fs "
            "through shared chunks (%.0f frames/s)",
            len(trajectory_paths),
            offset,
            n_feat,
            dt,
            offset / max(dt, 1e-9),
        )


def _eval_quantized(evaluator: "ShardedChunkEvaluator", block: np.ndarray) -> torch.Tensor:
    """Featurize a chunk through the int16 upload (io/upload.py): quantized
    on the host as one block, its codes sliced by frames over the mesh,
    each slice copied to its device and dequantized there, K1 per slice."""
    return evaluator.eval_shards(upload_coords_sharded(block, evaluator.mesh))


class ShardedChunkEvaluator:
    """Frame-sharded adapter over `PlanEvaluator` for a mesh of one or more
    devices: every chunk splits into contiguous frame slices, one per mesh
    entry, each copied to its device and featurized there (K1) by that
    entry's worker (`parallel.mesh.run_per_device`); the outputs are
    gathered in frame order on the mesh's first device (a mesh of one is
    one `PlanEvaluator` call). A device listed several times keeps one
    evaluator. Exposes the PlanEvaluator call surface (`__call__`,
    `eval_raw`)."""

    def __init__(self, plan, mesh: Mesh, fit_reference: Optional[np.ndarray] = None,
                 fit_weights: Optional[np.ndarray] = None):
        self.plan = plan
        self.mesh = mesh
        self.device = mesh.devices[0]
        by_device: dict = {}
        for dev in mesh.devices:
            if dev not in by_device:
                by_device[dev] = PlanEvaluator(plan, fit_reference, fit_weights, device=dev)
        self.evaluators = [by_device[dev] for dev in mesh.devices]

    def eval_local(self, parts, then: Optional[Callable] = None) -> List[torch.Tensor]:
        """Frame slices, one a mesh entry (numpy or tensors, anywhere; e.g.
        `parallel.mesh.split(coords, mesh)`), each copied to its device and
        featurized there by its entry's worker, each chunk of the copy up
        then passed through `then` there if given (`PlanEvaluator.eval_raw`);
        empty slices after the first are left out (the first is empty only
        when all are)."""

        def run(dev, ev, part):
            return ev.eval_raw(part, then)

        return [out for i, (out, part) in enumerate(zip(
            run_per_device(run, self.mesh, self.evaluators, parts), parts))
            if i == 0 or part.shape[0]]

    def eval_shards(self, shards) -> torch.Tensor:
        """Per-device frame shards -> the (C, F) features on the first
        device."""
        return all_gather(self.eval_local(shards), self.mesh.local())

    def eval_raw(self, coords_chunk) -> torch.Tensor:
        """(C, A, 3) Angstrom frames -> (C, F) device tensor."""
        return self.eval_shards(split(coords_chunk, self.mesh))

    def __call__(self, coords_chunk) -> np.ndarray:
        features = self.eval_raw(coords_chunk)
        with annotate("transfer.d2h"):
            return features.cpu().numpy()


def featurize_trajectory(
    trajectory_path: str,
    topology_path: str,
    features_list: List[str],
    traj_stride: int = 1,
    frame_chunk: int = 2048,
    fit_template_path: Optional[str] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """One-shot helper: decode and featurize a whole trajectory. `device`:
    None means CUDA (raises without a card); "cpu" runs on the host."""
    topology = Topology.from_file(topology_path)
    fit_template = None
    if fit_template_path is not None:
        template = Topology.from_file(fit_template_path)
        fit_template = (template.positions, template.occupancies)
    featurizer = Featurizer(topology, features_list, fit_template, device=device)
    return featurizer.featurize_trajectory(trajectory_path, traj_stride, frame_chunk)
