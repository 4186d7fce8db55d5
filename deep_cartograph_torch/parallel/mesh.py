"""Device meshes: the port of the JAX package's parallel/mesh.py.

A `Mesh` is an ordered tuple of the devices local to this process, and
the process group (`torch.distributed`) its collectives reduce over when
the work spans several processes. As in the JAX package, one process
sees every local device and the entry points shard over all of them
without being configured: `get_mesh()` is every visible CUDA device.

Routing (`mesh_for`): every sharded path runs over a mesh, which is the
active mesh when the call runs on its first device and it has more than
one entry, else the call's device alone; a mesh of one is the
one-device run, through the same code. The default mesh holds only CUDA
devices, so a call on the CPU never shards there. `use_mesh` sets the
mesh for a block of code; a device may appear in it more than once, and
a mesh of the CPU listed several times runs every shard and combine on
the host (the JAX tests' virtual devices,
`--xla_force_host_platform_device_count`). `use_mesh(Mesh(["cuda:0"]))`
keeps a host with several cards on the first one.

Shards are contiguous slices from `torch.tensor_split`: they may be
uneven, so nothing is padded and no weight masks padding.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
from typing import Iterator, List, Optional, Sequence, Tuple

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
    when it has more than one entry and `device` is its first, else
    `device` alone. Without `use_mesh`, only a CUDA call can shard, over
    every visible card."""
    mesh = _ACTIVE.get()
    if mesh is None and device.type == "cuda" and torch.cuda.device_count() > 1:
        mesh = get_mesh()
    if mesh is not None and len(mesh) > 1 and _same_device(device, mesh.devices[0]):
        return mesh
    return Mesh((device,))


def shard(x, mesh: Mesh, axis: int = 0) -> List[torch.Tensor]:
    """Contiguous slices of `x` (numpy or tensor) along `axis`, the i-th on
    the mesh's i-th device; the first ones are one longer when the length
    does not divide."""
    t = torch.as_tensor(x)
    return [part.to(dev) for dev, part in
            zip(mesh.devices, torch.tensor_split(t, len(mesh), dim=axis))]


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
