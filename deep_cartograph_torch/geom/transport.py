"""The host-card transport of featurize and serve: what carries bytes
between host memory and the card, and its counters.

Both directions go through a `PinnedRing`. The copy up (`UploadRing`, one
an evaluator, `geom/kernels.py::PlanEvaluator`) gathers the plan's atoms
out of host frames into a slot (`stage_atoms`) and copies them up while the
device works on the chunk before; `UPLOAD_STATS` counts it. The copy back
(`DownloadRing`, one a device, `geom/engine.py::Featurizer`) sends each
chunk's features down into slots and takes them out into their
trajectory's rows (`copy_rows`, a `MappedMatrix`) once the next chunk is
dispatched; `DOWNLOAD_STATS` counts it.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import threading
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from deep_cartograph_torch.ops.build import load_host_library
from deep_cartograph_torch.utils.profiling import annotate

# A ring holds RING_SLOTS slots of SLOT_BYTES each.
SLOT_BYTES = 32 << 20
RING_SLOTS = 3
# A chunk's gather takes a host thread for each GATHER_GRAIN floats it stages
# (1 MiB of a slot), at most the cores but one (left to the threads that run
# beside it, such as the DCD reader's prefetch thread), split among the
# evaluators staging at once (a mesh's workers): a featurize block of 2,048
# frames of 80 atoms takes 2 threads, a full slot every thread of its share.
# The copy out of a download slot takes as many, at most half the cores: the
# rest are left to the DCD reader's prefetch thread and the thread that maps
# the matrix ahead. On an 8-core H100 host 4 threads copied as fast as 5, 6
# or 7 (PERF.md §6).
GATHER_GRAIN = 1 << 18
# Bytes of a trajectory's matrix mapped at a time ahead of the copies.
MAP_STEP = 64 << 20
_STAGE_SOURCE = Path(__file__).resolve().parent / "csrc" / "stage_atoms.cpp"
# Calls inside a staged loop now, in any evaluator: the host's cores are the
# process's, so the count is too.
_staging_calls = 0
_staging_lock = threading.Lock()


@dataclass
class UploadStats:
    """Counters of the staged copy up of host frames
    (`geom/kernels.py::PlanEvaluator`): `calls` staged, their `chunks` and
    `frames`, the `bytes_sent` to the device and the `bytes_held` by the
    caller's frames (the two differ when only the plan's atoms go up), and
    the `slot_waits`, chunks that waited for a slot of the ring to come
    free. Callers reset them (`reset()`, or a field to 0) around a region
    they measure. The counts are taken under a lock: the mesh's worker
    threads stage at once."""

    calls: int = 0
    chunks: int = 0
    frames: int = 0
    bytes_sent: int = 0
    bytes_held: int = 0
    slot_waits: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def count_chunk(self, frames: int, bytes_sent: int, bytes_held: int,
                    waited: bool) -> None:
        """Count one staged chunk."""
        with self._lock:
            self.chunks += 1
            self.frames += frames
            self.bytes_sent += bytes_sent
            self.bytes_held += bytes_held
            self.slot_waits += int(waited)

    def count_call(self) -> None:
        """Count one staged call."""
        with self._lock:
            self.calls += 1

    def reset(self) -> None:
        with self._lock:
            self.calls = self.chunks = self.frames = 0
            self.bytes_sent = self.bytes_held = self.slot_waits = 0


@dataclass
class DownloadStats:
    """Counters of the copy back of featurized chunks
    (`geom/engine.py::Featurizer`'s download ring): the `chunks` sent down
    and their `bytes`, the `pieces` they took (a slot each) and the
    `slot_waits`, pieces whose copy had not completed when the host came
    to take their slot. Callers reset them (`reset()`, or a field to 0)
    around a region they measure. The counts are taken under a lock."""

    chunks: int = 0
    bytes: int = 0
    pieces: int = 0
    slot_waits: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def count_chunk(self, nbytes: int, pieces: int) -> None:
        """Count one chunk sent down in `pieces` pieces."""
        with self._lock:
            self.chunks += 1
            self.bytes += nbytes
            self.pieces += pieces

    def count_take(self, waited: bool) -> None:
        """Count one piece taken out of its slot."""
        with self._lock:
            self.slot_waits += int(waited)

    def reset(self) -> None:
        with self._lock:
            self.chunks = self.bytes = self.pieces = self.slot_waits = 0


UPLOAD_STATS = UploadStats()
DOWNLOAD_STATS = DownloadStats()


def _cores() -> int:
    """The host cores this process may run on."""
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    return cores or 1


def _gather_team(floats: int) -> int:
    """Host threads for a gather of `floats` floats (`GATHER_GRAIN`)."""
    share = max(1, _cores() - 1) // max(1, _staging_calls)
    return max(1, min(-(-floats // GATHER_GRAIN), share))


def _copy_team(floats: int) -> int:
    """Host threads for a copy of `floats` floats out of a download slot:
    one a `GATHER_GRAIN`, at most half the cores."""
    return max(1, min(-(-floats // GATHER_GRAIN), _cores() // 2))


@contextmanager
def staging():
    """Count the calls staging at once, for `_gather_team`."""
    global _staging_calls
    with _staging_lock:
        _staging_calls += 1
    try:
        yield
    finally:
        with _staging_lock:
            _staging_calls -= 1


def _native(name: str, restype, *argtypes):
    """Function `name` of `geom/csrc/stage_atoms.cpp`, built at first use."""
    fn = getattr(load_host_library(_STAGE_SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = list(argtypes), restype
    return fn


def stage_atoms(frames: np.ndarray, atoms: Optional[np.ndarray], out: torch.Tensor,
                threads: int = 1) -> None:
    """Copy the `atoms` (int64 indices; every atom if None) of each frame of
    `frames`, a C-ordered float32 (n, A, 3) array, into `out`, a contiguous
    float32 host tensor of n * len(atoms) * 3 (or n * A * 3) elements, on
    `threads` host threads (`geom/csrc/stage_atoms.cpp`)."""
    fn = _native("stage_atoms", None, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                 ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int)
    n, n_atoms = frames.shape[:2]
    width = n_atoms if atoms is None else len(atoms)
    if (frames.ndim != 3 or frames.shape[2] != 3 or frames.dtype != np.float32
            or not frames.flags.c_contiguous
            or out.dtype != torch.float32 or out.device.type != "cpu"
            or not out.is_contiguous() or out.numel() != n * width * 3):
        raise ValueError("stage_atoms needs C-ordered float32 (n, A, 3) frames and a "
                         "contiguous float32 host tensor of their staged size")
    if atoms is not None and (atoms.dtype != np.int64 or not atoms.flags.c_contiguous
                              or (width and not 0 <= atoms.min() <= atoms.max() < n_atoms)):
        raise ValueError(f"stage_atoms needs C-ordered int64 atoms in [0, {n_atoms})")
    fn(frames.ctypes.data, n, n_atoms, None if atoms is None else atoms.ctypes.data,
       width, out.data_ptr(), max(1, int(threads)))


def copy_rows(dst: np.ndarray, src: torch.Tensor) -> None:
    """Copy `src`, a contiguous float32 host tensor, into `dst`, a C-ordered
    float32 array of its shape, on `_copy_team` host threads
    (`geom/csrc/stage_atoms.cpp`)."""
    if (dst.dtype != np.float32 or not dst.flags.c_contiguous or not dst.flags.writeable
            or src.dtype != torch.float32 or src.device.type != "cpu"
            or not src.is_contiguous() or tuple(src.shape) != dst.shape):
        raise ValueError("copy_rows needs a contiguous float32 host tensor and a "
                         "writeable C-ordered float32 array of its shape")
    fn = _native("copy_floats", None, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_int)
    if dst.size:
        fn(src.data_ptr(), dst.ctypes.data, dst.size, _copy_team(dst.size))


def map_pages(address: int, nbytes: int) -> int:
    """Replace the pages of host memory from `address` (on a page boundary)
    over `nbytes`, rounded up to whole pages, by fresh zero pages mapped now
    (`mmap(MAP_FIXED | MAP_POPULATE)`, `geom/csrc/stage_atoms.cpp`): what
    they held is lost, so only over a private anonymous mapping of the
    caller's own that holds nothing yet. Copies into them then take no page
    faults. Returns 0 or the errno of the refusal. Releases the GIL while
    it runs."""
    return _native("map_pages", ctypes.c_int, ctypes.c_void_p, ctypes.c_int64)(address, nbytes)


class PinnedRing:
    """`RING_SLOTS` host slots of `floats` float32, taken in turn (`turn`).
    On a card they are pinned, the ring's own stream runs their copies
    (`copy`), and `copied[k]` marks slot k's last copy, which the host waits
    for before it reuses the slot (`wait`: true if it had to). On the CPU
    nothing is copied or waited for."""

    def __init__(self, device: torch.device, floats: int):
        self.device, self.floats = device, floats
        self.on_card = device.type == "cuda"
        self.host = [torch.empty(floats, dtype=torch.float32, pin_memory=self.on_card)
                     for _ in range(RING_SLOTS)]
        self.next = 0
        if self.on_card:
            self.stream = torch.cuda.Stream(device)
            self.copied = [torch.cuda.Event() for _ in range(RING_SLOTS)]

    def turn(self) -> int:
        k = self.next
        self.next = (k + 1) % RING_SLOTS
        return k

    def wait(self, k: int) -> bool:
        if not self.on_card or self.copied[k].query():
            return False
        self.copied[k].synchronize()
        return True

    def copy(self, k: int, dst: torch.Tensor, src: torch.Tensor) -> None:
        with torch.cuda.stream(self.stream):
            dst.copy_(src, non_blocking=True)
        self.copied[k].record(self.stream)


class UploadRing(PinnedRing):
    """The copy up's slots, and on a card their device twins: a host slot is
    written only once its last copy has run, a device slot only once the
    work that read it has run (`read`), and the current stream waits for a
    chunk's copy before its work. On the CPU the work reads the host slot."""

    def __init__(self, device: torch.device, floats: int):
        super().__init__(device, floats)
        if self.on_card:
            self.dev = [torch.empty(floats, dtype=torch.float32, device=device)
                        for _ in range(RING_SLOTS)]
            for slot in self.dev:   # freed only once the copies queued on it ran
                slot.record_stream(self.stream)
            self.read = [torch.cuda.Event() for _ in range(RING_SLOTS)]

    def stage(self, frames: np.ndarray, atoms: Optional[np.ndarray]
              ) -> Tuple[torch.Tensor, int, bool]:
        """`frames`' `atoms` into the next slot and, on a card, copied up
        from it: (the (n, width, 3) frames where the work reads them, the
        slot, whether the slot had to be waited for)."""
        k = self.turn()
        waited = self.wait(k)
        n = frames.shape[0]
        width = frames.shape[1] if atoms is None else len(atoms)
        size = n * width * 3
        host = self.host[k][:size]
        stage_atoms(frames, atoms, host, _gather_team(size))
        host = host.view(n, width, 3)
        if not self.on_card:
            return host, k, waited
        dev = self.dev[k][:size].view(n, width, 3)
        self.stream.wait_event(self.read[k])
        self.copy(k, dev, host)
        torch.cuda.current_stream(self.device).wait_event(self.copied[k])
        return dev, k, waited

    def done_reading(self, k: int) -> None:
        """The work that reads slot `k` is queued: the slot's next copy waits
        for it."""
        if self.on_card:
            self.read[k].record(torch.cuda.current_stream(self.device))


class DownloadRing(PinnedRing):
    """The copy back's slots, `rows` rows of `n_features` a slot: a chunk's
    features go a slot a piece, each piece handed to its sink when the host
    takes it, oldest first, and a slot is written again only once the host
    has taken the piece it holds. A chunk's copy waits for the work that
    made it, and the features' memory goes back to the allocator only once
    their copy has run (`record_stream`). On the CPU a piece is the
    features' rows themselves, and the ring holds no slots."""

    def __init__(self, device: torch.device, n_features: int):
        self.rows = max(1, SLOT_BYTES // (4 * max(n_features, 1)))
        super().__init__(device, self.rows * n_features if device.type == "cuda" else 0)
        self.pending: deque = deque()   # (slot, host rows, sink), oldest first

    def __len__(self) -> int:
        return len(self.pending)

    def send(self, features: torch.Tensor, sink: Callable[[torch.Tensor], None]) -> int:
        """Queue the copy of `features`' rows, a slot a piece, each piece
        handed to `sink` when taken; a slot still holding a piece is taken
        first. Returns the pieces."""
        n, width = features.shape
        if self.on_card:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            features.record_stream(self.stream)
        pieces = 0
        for a in range(0, n, self.rows):
            b = min(a + self.rows, n)
            if len(self.pending) == RING_SLOTS:
                self.take()
            k = self.turn()
            if self.on_card:
                host = self.host[k][:(b - a) * width].view(b - a, width)
                self.copy(k, host, features[a:b])
            else:
                host = features[a:b]
            self.pending.append((k, host, sink))
            pieces += 1
        DOWNLOAD_STATS.count_chunk(4 * features.numel(), pieces)
        return pieces

    def take(self) -> None:
        """Hand the oldest piece to its sink, once its copy has run."""
        k, host, sink = self.pending.popleft()
        with annotate("transfer.d2h"):
            waited = self.wait(k)
            sink(host)
        DOWNLOAD_STATS.count_take(waited)

    def discard(self) -> None:
        """Forget the pieces not taken (an abandoned call's). A later copy
        into their slots runs after theirs on the ring's stream."""
        self.pending.clear()


class MappedMatrix:
    """A fresh (rows, cols) float32 matrix in memory of its own, which a
    thread maps (`map_pages`) `MAP_STEP` bytes at a time from its first row
    while the pass runs. Left to the copies that write it, a fresh matrix
    faults its pages in one at a time, on the pass's critical path; where
    faults are dear (no transparent huge pages: PERF.md §6) that takes
    longer than the pass's decode. Mapped ahead, in steps, the copies find
    the pages there. Mapping a step replaces what it held, so rows are
    handed out (`rows`) only once mapped."""

    def __init__(self, rows: int, cols: int):
        self.memory = mmap.mmap(-1, max(4 * rows * cols, 1), flags=mmap.MAP_PRIVATE)
        self.array = np.frombuffer(self.memory, np.float32, rows * cols).reshape(rows, cols)
        self._mapped = 0   # bytes mapped from the first row
        self._cond = threading.Condition()
        self._thread = threading.Thread(target=self._map, daemon=True)
        self._thread.start()

    def _map(self) -> None:
        total, base = self.array.nbytes, self.array.ctypes.data
        try:
            for a in range(0, total, MAP_STEP):
                b = min(a + MAP_STEP, total)
                map_pages(base + a, b - a)   # refused: the copies fault them in
                with self._cond:
                    self._mapped = b
                    self._cond.notify_all()
        finally:
            with self._cond:
                self._mapped = total
                self._cond.notify_all()

    def rows(self, a: int, b: int) -> np.ndarray:
        """Rows [a, b), once mapped."""
        end = 4 * b * self.array.shape[1]
        with self._cond:
            self._cond.wait_for(lambda: self._mapped >= end)
        return self.array[a:b]

    def join(self) -> None:
        self._thread.join()
