"""Device meshes: the port of the JAX package's parallel/mesh.py.

A `Mesh` is an ordered tuple of the devices local to this process, and
the process group (`torch.distributed`) its collectives reduce over when
the work spans several processes. `get_mesh()` is every visible CUDA
device, as in the JAX package.

Routing (`mesh_for(device)`): every sharded path runs over a mesh, which
is the active mesh when the call runs on its first device and it has
more than one entry, else the call's device alone; a mesh of one is the
one-device run, through the same code. Only the caller shards: with no
mesh set (`use_mesh`), a call runs on its device alone however many cards
are visible, because on four H100s no sharded path ran faster than one
card (PERF.md §5). This is a deliberate difference from the JAX package,
which shards every path over every device; `use_mesh(get_mesh())` does
that here. A device may appear in a mesh more than once, and a mesh of
the CPU listed several times runs every shard and combine on the host
(the JAX tests' virtual devices, `--xla_force_host_platform_device_count`).

Per-device work (`run_per_device`): the entries of a mesh of several run
on one worker thread per device, so that one card's uploads, launches
and host waits do not hold back the next card's work. The workers live
for the process; a mesh of one, and a call made from a worker, run in the
caller's thread.

Shards are contiguous slices from `torch.tensor_split`: they may be
uneven, so nothing is padded and no weight masks padding.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import torch

from deep_cartograph_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

def _mesh_device(device: DeviceLike) -> torch.device:
    """A CUDA device with its index, or the CPU; anything else raises."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported mesh device: {dev}")
    if dev.type == "cuda":
        resolve_device(dev)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An ordered tuple of local devices, and the process group that the
    collectives reduce over across processes (None: this process alone)."""

    def __init__(self, devices: Sequence[DeviceLike], group=None):
        self.devices: Tuple[torch.device, ...] = tuple(_mesh_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group

    def __len__(self) -> int:
        return len(self.devices)

    def __iter__(self) -> Iterator[torch.device]:
        return iter(self.devices)

    def __repr__(self) -> str:
        group = "" if self.group is None else ", with a process group"
        return f"Mesh({[str(d) for d in self.devices]}{group})"

    def local(self) -> "Mesh":
        """The same devices without the process group."""
        return Mesh(self.devices)


_ACTIVE: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "deep_cartograph_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Within the block, `get_mesh()` returns `mesh` (the test seam)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def _default_group():
    import torch.distributed as dist

    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def get_mesh() -> Mesh:
    """The mesh set by `use_mesh`, else every visible CUDA device with the
    process group of `init_distributed`, if any. Raises without a card, as
    `resolve_device` does."""
    mesh = _ACTIVE.get()
    if mesh is None:
        resolve_device(None)
        mesh = Mesh([torch.device("cuda", i) for i in range(torch.cuda.device_count())],
                    group=_default_group())
    return mesh


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type == "cpu":
        return True
    index = lambda d: torch.cuda.current_device() if d.index is None else d.index  # noqa: E731
    return index(a) == index(b)


def mesh_for(device: torch.device) -> Mesh:
    """The mesh a call on `device` (resolved) runs over: the active mesh
    (`use_mesh`) when it has more than one entry and `device` is its first,
    else `device` alone. Without `use_mesh` nothing shards: on four H100s
    no sharded path ran faster than one card (PERF.md §5), where the JAX
    package shards every path over every device."""
    mesh = _ACTIVE.get()
    if mesh is not None and len(mesh) > 1 and _same_device(device, mesh.devices[0]):
        return mesh
    return Mesh((device,))


def split(x, mesh: Mesh, axis: int = 0) -> List[torch.Tensor]:
    """Contiguous slices of `x` (numpy or tensor) along `axis`, one per
    mesh entry, where `x` lies (views, no copy); the first ones are one
    longer when the length does not divide."""
    return list(torch.tensor_split(torch.as_tensor(x), len(mesh), dim=axis))


def shard(x, mesh: Mesh, axis: int = 0) -> List[torch.Tensor]:
    """`split(x, mesh, axis)` with the i-th slice copied to the mesh's i-th
    device, by that entry's worker (`run_per_device`)."""
    return run_per_device(lambda dev, part: part.to(dev), mesh, split(x, mesh, axis))


class _Workers:
    """One single-thread executor per device, made at its first use and
    kept for the process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pools: Dict[torch.device, ThreadPoolExecutor] = {}
        self.local = threading.local()

    def _mark(self) -> None:
        self.local.is_worker = True

    def is_worker(self) -> bool:
        return getattr(self.local, "is_worker", False)

    def pool(self, device: torch.device) -> ThreadPoolExecutor:
        with self._lock:
            if device not in self._pools:
                self._pools[device] = ThreadPoolExecutor(
                    1, thread_name_prefix=f"mesh-{device}", initializer=self._mark)
            return self._pools[device]


_WORKERS = _Workers()


def _inline(mesh: Mesh) -> bool:
    """Whether `run_per_device` runs `mesh`'s entries in the caller's
    thread: a mesh of one, or a call from a worker (whose entry is already
    one device's work)."""
    return len(mesh) == 1 or _WORKERS.is_worker()


def _on_device(fn: Callable, device: torch.device, grad: bool, args: tuple):
    with torch.set_grad_enabled(grad):
        if device.type != "cuda":
            return fn(device, *args)
        with torch.cuda.device(device):
            return fn(device, *args)


def run_per_device(fn: Callable, mesh: Mesh, *per_device: Iterable) -> list:
    """[fn(device, *args) for each mesh entry], the i-th args taken from the
    i-th item of each of `per_device` (as `map` does; entries beyond the
    shortest are left out), the results in mesh order.

    Each entry runs on its device's worker thread (the entries of a device
    listed several times one after another, in mesh order), under
    `torch.cuda.device` of its device, with the caller's grad mode and
    context variables (the active mesh); the entries' CUDA work goes to
    each device's current stream, as the caller's does. A mesh of one runs
    inline. Every entry finishes before the call returns or raises; an
    exception raised by an entry is raised here, with a note naming the
    entry and its device (and one for each later entry that raised too)."""
    items = list(zip(mesh.devices, *per_device))
    if _inline(mesh):
        return [fn(*item) for item in items]
    grad = torch.is_grad_enabled()
    futures = [_WORKERS.pool(dev).submit(contextvars.copy_context().run, _on_device,
                                         fn, dev, grad, tuple(args))
               for dev, *args in items]
    results, errors = [], []
    for i, ((dev, *_), future) in enumerate(zip(items, futures)):
        try:
            results.append(future.result())
        except Exception as exc:  # noqa: BLE001 - raised below, with its entry named
            errors.append((i, dev, exc))
    if errors:
        i, dev, first = errors[0]
        first.add_note(f"raised on mesh entry {i} ({dev})")
        for j, other_dev, other in errors[1:]:
            first.add_note(f"mesh entry {j} ({other_dev}) raised too: {other!r}")
        raise first
    return results


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: DeviceLike = None) -> None:
    """Set up the process group of a run over several processes
    (`torch.distributed.init_process_group`, `tcp://<coordinator_address>`):
    NCCL for CUDA (`device` None), gloo for `device="cpu"`. A single process
    does nothing. Call it before `get_mesh`, which then carries the group."""
    if num_processes is None or num_processes <= 1:
        logger.debug("Single-process run; no process group.")
        return
    import torch.distributed as dist

    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def local_shard(items: Sequence, process_id: Optional[int] = None,
                num_processes: Optional[int] = None) -> list:
    """This process's part of a work list (trajectory paths, colvars
    files): items[rank::world]. A single process gets the whole list."""
    import torch.distributed as dist

    group = _default_group()
    pid = process_id if process_id is not None else (dist.get_rank() if group is not None else 0)
    nproc = (num_processes if num_processes is not None
             else (dist.get_world_size() if group is not None else 1))
    if nproc <= 1:
        return list(items)
    return list(items)[pid::nproc]
