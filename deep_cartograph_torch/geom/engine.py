"""The featurization engine: trajectory -> feature matrix.

The port of the JAX package's geom/engine.py: frames are decoded on the host
in chunks, copied to the device, and every feature of every frame in the
chunk is evaluated there (geom/kernels.py). Chunks keep their natural
length: the kernels mask the ragged last chunk, so nothing is padded. Each
chunk's features come back through the featurizer's download ring
(geom/transport.py) while the host decodes the next chunk, and go straight
into the rows of their trajectory's matrix.

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
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from deep_cartograph_torch.features.grammar import compile_plan
from deep_cartograph_torch.geom.kernels import PlanEvaluator
# DOWNLOAD_STATS is read here, as `geom.engine.DOWNLOAD_STATS`, by the benchmark.
from deep_cartograph_torch.geom.transport import (DOWNLOAD_STATS, DownloadRing,  # noqa: F401
                                                  MappedMatrix, copy_rows)
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.io.traj import get_num_frames, iter_frame_chunks
from deep_cartograph_torch.io.upload import UPLOAD_MODES, upload_coords_sharded
from deep_cartograph_torch.parallel.mesh import Mesh, get_mesh, mesh_for, run_per_device, split
from deep_cartograph_torch.parallel.sharding import all_gather
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device
from deep_cartograph_torch.utils.profiling import annotate

logger = logging.getLogger(__name__)

# Soft budget for per-chunk intermediates on device (bytes).
_CHUNK_BYTE_BUDGET = 1 << 30

# A featurize call's timeout message: featurize_trajectory's, and that of
# the streaming calls, which name the trajectory.
_TIMEOUT_AFTER = ("Featurization exceeded the configured timeout of {timeout} s "
                  "after {frames} frames.")
_TIMEOUT_OF = "Featurization of {path} exceeded the configured timeout of {timeout} s."
# Formats whose header gives the frame count, read before the pass. XTC and
# TRR are not among them: their counts (`io/xtc.py`, `io/trr.py`) read the
# whole file and walk its frames, a second read of it ahead of the decode.
_COUNTED_FORMATS = (".dcd",)


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
        self._rings: dict = {}   # device -> DownloadRing, made at first use

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
        "float32" (exact, the default) or "int16" (fixed point, half the
        bytes, io/upload.py).
        """
        ((_, features),) = self._stream([trajectory_path], traj_stride, frame_chunk,
                                        timeout, upload, _TIMEOUT_AFTER)
        return features

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

        Yields (path, (n_frames_i, n_features) matrix) per trajectory, in
        order, once its last frame has been evaluated and copied back, so
        callers can persist each result as it comes and memory stays
        bounded: a chunk's features leave the device through the
        featurizer's download ring (a chunk behind the one evaluated), and
        the host holds the trajectories whose frames the chunks not yet
        copied back hold, plus a chunk's frames. `timeout` (seconds)
        applies per trajectory.
        """
        yield from self._stream(trajectory_paths, traj_stride, frame_chunk, timeout,
                                "float32", _TIMEOUT_OF)

    def _stream(self, trajectory_paths: List[str], traj_stride: int, frame_chunk: int,
                timeout: Optional[float], upload: str, timeout_text: str
                ) -> Iterator[Tuple[str, np.ndarray]]:
        """The chunk loop of both entry points. The reader's blocks are cut
        into chunks of `chunk` frames across trajectory seams; a block that
        is a whole chunk goes to the device as it comes, and only a chunk
        made of several blocks' frames is assembled in `buf`. Each chunk's
        features are sent down the download ring as soon as its work is
        queued; the host takes them out of their slot into their
        trajectory's rows once the next chunk is dispatched, so the copy
        runs under the next chunk's decode and kernels."""
        if upload not in UPLOAD_MODES:
            raise ValueError(f"unknown upload mode {upload!r} (int16|float32)")
        chunk = auto_chunk_size(
            frame_chunk, self.topology.n_atoms, self.plan.n_features
        )
        n_feat = self.plan.n_features
        evaluator = self.evaluator
        # The ring is the call's while it runs: a call made meanwhile (an
        # interleaved generator) makes a ring of its own.
        ring = self._rings.pop(evaluator.device, None) or DownloadRing(evaluator.device, n_feat)
        trajs: deque = deque()     # _Rows not yet yielded, in order
        parts: List[np.ndarray] = []   # frames of the chunk being filled
        fill = 0
        buf: Optional[np.ndarray] = None
        dispatched = 0             # frames sent to the device so far

        def sink(rows: torch.Tensor) -> None:
            # Pieces come in order: their rows belong to the first
            # trajectories not yet complete.
            for t in trajs:
                if not rows.shape[0]:
                    return
                room = rows.shape[0] if t.end is None else t.end - t.start - t.written
                if room > 0:
                    t.write(rows[:room])
                    rows = rows[room:]

        def dispatch() -> None:
            nonlocal buf, fill, dispatched
            if len(parts) == 1:
                frames = parts[0]
            else:
                if buf is None:
                    buf = np.empty((chunk,) + parts[0].shape[1:], np.float32)
                frames = np.concatenate(parts, out=buf[:fill])
            # The staged copy up (geom/transport.py) returns once the chunk's
            # atoms are in a pinned slot; its copy and kernels are only
            # queued. An int16 upload quantizes the chunk on the host and
            # dequantizes it on the device (io/upload.py). (The JAX package
            # pads a short last chunk by repeating its last frame before
            # quantizing: that moves no axis' minimum or maximum, so the
            # unpadded chunk has the same codes.)
            if upload == "int16":
                features = _eval_quantized(evaluator, frames)
            else:
                features = evaluator.eval_raw(frames)
            newest = ring.send(features, sink)
            dispatched += fill
            parts.clear()
            fill = 0
            while len(ring) > newest:
                ring.take()

        def ready():
            while trajs and trajs[0].end is not None and trajs[0].end <= dispatched:
                t = trajs[0]
                while t.start + t.written < t.end:
                    ring.take()
                trajs.popleft()
                yield t.path, t.result()

        t_start = time.time()
        offset = 0
        try:
            for path in trajectory_paths:
                t0 = time.time()
                trajs.append(_Rows(path, offset, _frames_ahead(path, traj_stride), n_feat))
                # Readers hand out blocks they never write again, so a block
                # is held (not copied) until its chunk is dispatched.
                for block in iter_frame_chunks(
                    path, chunk, self.topology.source_path, stride=traj_stride
                ):
                    if timeout is not None and time.time() - t0 > timeout:
                        raise TimeoutError(timeout_text.format(
                            path=path, timeout=timeout, frames=offset - trajs[-1].start))
                    offset += block.shape[0]
                    pos = 0
                    while pos < block.shape[0]:
                        n = min(chunk - fill, block.shape[0] - pos)
                        parts.append(block[pos : pos + n])
                        fill += n
                        pos += n
                        if fill == chunk:
                            dispatch()
                    yield from ready()
                trajs[-1].end = offset
                yield from ready()
            if fill:
                dispatch()
            yield from ready()
        finally:
            ring.discard()
            self._rings[evaluator.device] = ring
        if trajs:
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


def _frames_ahead(path: str, stride: int) -> Optional[int]:
    """The frames a trajectory yields at `stride`, where its header gives
    them (`io/traj.py::get_num_frames`, `_COUNTED_FORMATS`), else None."""
    if Path(path).suffix.lower() not in _COUNTED_FORMATS:
        return None
    return -(-get_num_frames(path) // stride)


class _Rows:
    """One trajectory's features on the host, written in order as the
    download ring hands them over: into one matrix of the frame count known
    ahead (`MappedMatrix`), else (or beyond that count) into parts joined
    once."""

    def __init__(self, path: str, start: int, expected: Optional[int], n_features: int):
        self.path, self.start = path, start
        self.end: Optional[int] = None   # the first frame past it, once read
        self.written = 0
        self.matrix = MappedMatrix(expected, n_features) if expected else None
        self.n_features = n_features
        self.parts: List[np.ndarray] = []

    def write(self, rows: torch.Tensor) -> None:
        rows = rows.contiguous()
        n = rows.shape[0]
        room = 0 if self.matrix is None else len(self.matrix.array) - self.written
        fit = max(0, min(n, room))
        if fit:
            copy_rows(self.matrix.rows(self.written, self.written + fit), rows[:fit])
        if fit < n:
            part = np.empty((n - fit, self.n_features), np.float32)
            copy_rows(part, rows[fit:])
            self.parts.append(part)
        self.written += n

    def result(self) -> np.ndarray:
        if self.matrix is None:
            head = np.zeros((0, self.n_features), np.float32)
        else:
            self.matrix.join()
            head = self.matrix.array[:self.written]
        return np.concatenate([head] + self.parts) if self.parts else head


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
