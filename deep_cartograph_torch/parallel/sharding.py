"""Sharded compute paths: the port of the JAX package's parallel/sharding.py.

The JAX package writes these as `shard_map` programs whose collectives XLA
emits. Here they are explicit functions over lists of per-device tensors
(one entry per mesh device, in mesh order):

  * `psum`, `pmax`, `pmin`: reduce the partials on the mesh's first
    device, then `torch.distributed.all_reduce` over the mesh's process
    group, when it has one;
  * `all_gather`: concatenate in mesh order (then across processes);
  * `ppermute`: a ring over the mesh's devices, each receiving from the
    next (across processes, `batch_isend_irecv` at the seams).

A copy between two cards is ordered after the source device's queued
work (`_to`), so a partial is never read before it is written. The
per-device work of `sharded_covariances` and `sharded_kde_logsumexp`
(copying a shard in, reducing it) runs on each entry's worker
(`parallel.mesh.run_per_device`), so the cards work at once.

Frame-sharded moments (`sharded_covariances`,
`sharded_feature_matrix_stats`) sum per-device partials; the KDE
(`sharded_kde_logsumexp`) runs kernel K2 on each shard and combines the
local logsumexps as m + log sum exp(lse - m) with m their maximum; the
feature-sharded rings (`feature_sharded_covariance_ring`,
`feature_sharded_timelagged_ring`) keep one column block of the matrix
per device and pass the visiting block along the ring.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deep_cartograph_torch.ops.kde import kde_logsumexp
from deep_cartograph_torch.parallel.mesh import Mesh, get_mesh, run_per_device, shard, split


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` on `device`. Between two cards, the destination's stream first
    waits for the work queued on the source's."""
    if t.device == device:
        return t
    if t.device.type == "cuda" and device.type == "cuda":
        torch.cuda.current_stream(device).wait_stream(torch.cuda.current_stream(t.device))
    return t.to(device)


def _all_reduce(t: torch.Tensor, mesh: Mesh, op: str) -> torch.Tensor:
    if mesh.group is not None:
        import torch.distributed as dist

        dist.all_reduce(t, op=getattr(dist.ReduceOp, op), group=mesh.group)
    return t


def psum(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The sum of the per-device partials, on the mesh's first device."""
    dev = mesh.devices[0]
    total = _to(parts[0], dev).clone()
    for p in parts[1:]:
        total += _to(p, dev)
    return _all_reduce(total, mesh, "SUM")


def pmax(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The elementwise maximum of the partials, on the first device."""
    dev = mesh.devices[0]
    out = torch.stack([_to(p, dev) for p in parts]).amax(0)
    return _all_reduce(out, mesh, "MAX")


def pmin(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The elementwise minimum of the partials, on the first device."""
    dev = mesh.devices[0]
    out = torch.stack([_to(p, dev) for p in parts]).amin(0)
    return _all_reduce(out, mesh, "MIN")


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The shards concatenated along `dim` in mesh order, on the first
    device; across processes, in rank order (shards may differ in length
    along `dim`)."""
    dev = mesh.devices[0]
    if len(parts) == 1 and mesh.group is None:
        return _to(parts[0], dev)
    local = torch.cat([_to(p, dev) for p in parts], dim=dim)
    if mesh.group is None:
        return local
    import torch.distributed as dist

    world = dist.get_world_size(mesh.group)
    size = torch.tensor([local.shape[dim]], device=dev)
    sizes = [torch.zeros_like(size) for _ in range(world)]
    dist.all_gather(sizes, size, group=mesh.group)
    lengths = [int(s.item()) for s in sizes]
    pad = [0, 0] * (local.dim() - 1 - dim % local.dim()) + [0, max(lengths) - local.shape[dim]]
    padded = torch.nn.functional.pad(local, pad).contiguous()
    gathered = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(gathered, padded, group=mesh.group)
    return torch.cat([g.narrow(dim, 0, n) for g, n in zip(gathered, lengths)], dim=dim)


def ppermute(parts: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """One step of the ring: entry i receives entry i + 1 (the last one the
    first; across processes, the next rank's first, so every process's
    first entry must have the shape of the previous rank's last)."""
    n = len(parts)
    out = [_to(parts[(i + 1) % n], dev) for i, dev in enumerate(mesh.devices)]
    if mesh.group is None:
        return out
    import torch.distributed as dist

    rank, world = dist.get_rank(mesh.group), dist.get_world_size(mesh.group)
    if world == 1:
        return out
    recv = torch.empty_like(parts[-1])
    ops = [dist.P2POp(dist.isend, parts[0].contiguous(),
                      dist.get_global_rank(mesh.group, (rank - 1) % world), mesh.group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(mesh.group, (rank + 1) % world), mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out[-1] = recv
    return out


# ---------------------------------------------------------------------------
# Frame-sharded moments
# ---------------------------------------------------------------------------


def _float_shards(x, mesh: Mesh, axis: int = 0) -> List[torch.Tensor]:
    return [p.float().contiguous() for p in shard(x, mesh, axis)]


def _count(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.tensor(float(p.shape[0]), device=p.device) for p in parts]


def sharded_covariances(x_t, x_lag, mesh: Optional[Mesh] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C0, symmetrized Ctau) with the frame axis sharded over the mesh, by
    mlcolvar's estimator (mean and C0 from x_t only; cf.
    cv/tica_math.timelagged_covariances): per-device partial sums, each
    entry's on its worker, then `psum`. float32 tensors on the mesh's
    first device."""
    mesh = mesh or get_mesh()

    def place(dev, pa, pb):
        pa = _to(pa, dev).float().contiguous()
        pb = _to(pb, dev).float().contiguous()
        return pa, pb, _count([pa])[0], pa.sum(0)

    a, b, counts, sums = zip(*run_per_device(place, mesh, split(x_t, mesh), split(x_lag, mesh)))
    count = psum(counts, mesh)
    mu = psum(sums, mesh) / count

    def products(dev, pa, pb):
        m = _to(mu, dev)
        ac, bc = pa - m, pb - m
        return ac.T @ ac, ac.T @ bc + bc.T @ ac

    c0_parts, ctau_parts = zip(*run_per_device(products, mesh, a, b))
    return psum(c0_parts, mesh) / count, 0.5 * psum(ctau_parts, mesh) / count


def sharded_feature_matrix_stats(features, mesh: Optional[Mesh] = None
                                 ) -> Dict[str, np.ndarray]:
    """mean/std/min/max of a frame-sharded feature matrix (psum, pmin,
    pmax), float64 numpy."""
    mesh = mesh or get_mesh()
    parts = _float_shards(features, mesh)
    count = psum(_count(parts), mesh)
    mean = psum([p.sum(0) for p in parts], mesh) / count
    sq = psum([(p * p).sum(0) for p in parts], mesh) / count
    std = torch.sqrt(torch.clamp_min(sq - mean * mean, 0.0))
    inf = float("inf")
    xmin = pmin([p.amin(0) if len(p) else torch.full(p.shape[1:], inf, device=p.device)
                 for p in parts], mesh)
    xmax = pmax([p.amax(0) if len(p) else torch.full(p.shape[1:], -inf, device=p.device)
                 for p in parts], mesh)
    return {k: v.cpu().numpy().astype(np.float64)
            for k, v in (("mean", mean), ("std", std), ("min", xmin), ("max", xmax))}


def lag_pairs_with_halo(frames, lag_time: int, mesh: Mesh
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """(x_t, x_lag, valid) per shard across shard boundaries, by a halo
    exchange: each shard receives the first `lag_time` frames of the next
    (`ppermute`), so it pairs all of its own frames but the global tail,
    which wraps around and has `valid` 0 (on the last shard of the last
    process)."""
    parts = shard(frames, mesh)
    if any(p.shape[0] < lag_time for p in parts):
        raise ValueError(f"every shard needs at least lag_time={lag_time} frames")
    halos = ppermute([p[:lag_time] for p in parts], mesh)
    last = len(parts) - 1
    if mesh.group is not None:
        import torch.distributed as dist

        is_last_process = dist.get_rank(mesh.group) == dist.get_world_size(mesh.group) - 1
    else:
        is_last_process = True
    x_lag, valid = [], []
    for i, (p, halo) in enumerate(zip(parts, halos)):
        n = p.shape[0]
        x_lag.append(torch.cat([p, halo])[lag_time: lag_time + n])
        ok = torch.ones(n, dtype=p.dtype, device=p.device)
        if i == last and is_last_process:
            ok[n - lag_time:] = 0
        valid.append(ok)
    return parts, x_lag, valid


# ---------------------------------------------------------------------------
# Feature-sharded rings (one process)
# ---------------------------------------------------------------------------


def _column_offsets(blocks: Sequence[torch.Tensor]) -> List[int]:
    return [0] + list(np.cumsum([b.shape[1] for b in blocks]))


def feature_sharded_covariance_ring(features, mesh: Optional[Mesh] = None,
                                    center: bool = True
                                    ) -> Tuple[List[torch.Tensor], int]:
    """Covariance of a feature-sharded matrix by a ring: device i holds the
    column block X_i (N, F_i) and its row block C[i] (F_i, F); in n steps
    each multiplies X_i by the visiting block X_j and passes the visitor
    on, so C[i, j] = X_i^T X_j / N. Peak memory per device: 2 blocks and
    one row block. Returns (row blocks in mesh order, F); mean-centered
    when `center`."""
    mesh = (mesh or get_mesh()).local()
    cols = _float_shards(features, mesh, axis=1)
    n, f = cols[0].shape[0], sum(c.shape[1] for c in cols)
    local = [c - c.mean(0, keepdim=True) if center else c for c in cols]
    offsets = _column_offsets(local)
    rows = [torch.zeros(c.shape[1], f, device=c.device) for c in local]
    visitor = list(local)
    for step in range(len(mesh)):
        for i, x in enumerate(local):
            j = (i + step) % len(mesh)
            rows[i][:, offsets[j]: offsets[j + 1]] = x.T @ visitor[i] / n
        visitor = ppermute(visitor, mesh)
    return rows, f


def feature_sharded_timelagged_ring(x_t, x_lag, mesh: Optional[Mesh] = None
                                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor], int]:
    """(C0, symmetrized Ctau) for TICA with the feature axis sharded over
    the mesh: the ring of `feature_sharded_covariance_ring` on both
    matrices, with `tica_math.timelagged_covariances`' estimator (mean and
    C0 from x_t only). Returns (C0 row blocks, Ctau row blocks, F)."""
    mesh = (mesh or get_mesh()).local()
    a = _float_shards(x_t, mesh, axis=1)
    b = _float_shards(x_lag, mesh, axis=1)
    n, f = a[0].shape[0], sum(c.shape[1] for c in a)
    means = [c.mean(0) for c in a]
    a = [c - m for c, m in zip(a, means)]
    b = [c - m for c, m in zip(b, means)]
    offsets = _column_offsets(a)
    c0 = [torch.zeros(c.shape[1], f, device=c.device) for c in a]
    ctau = [torch.zeros(c.shape[1], f, device=c.device) for c in a]
    vt, vl = list(a), list(b)
    for step in range(len(mesh)):
        for i, (at, bl) in enumerate(zip(a, b)):
            j = (i + step) % len(mesh)
            cols = slice(offsets[j], offsets[j + 1])
            c0[i][:, cols] = at.T @ vt[i] / n
            ctau[i][:, cols] = 0.5 * (at.T @ vl[i] + bl.T @ vt[i]) / n
        vt, vl = ppermute(vt, mesh), ppermute(vl, mesh)
    return c0, ctau, f


# ---------------------------------------------------------------------------
# Frame-sharded KDE (kernel K2 on each shard)
# ---------------------------------------------------------------------------


def sharded_kde_logsumexp(grid_points, samples, inv_two_bw2: float,
                          mesh: Optional[Mesh] = None) -> torch.Tensor:
    """`ops.kde.kde_logsumexp` with the samples frame-sharded over the
    mesh: each entry's worker copies its shard and the grid to its device
    and computes the shard's logsumexp there through K2, and the shards
    combine as lse(all) = m + log sum_i exp(lse_i - m), m = max_i lse_i
    (lse_0 itself on a mesh of one). Returns the raw (grid,) logsumexp,
    float32, on the mesh's first device; the log density is it minus
    log(samples)."""
    mesh = mesh or get_mesh()
    first = mesh.devices[0]
    x = torch.as_tensor(samples, dtype=torch.float32)
    if x.dim() == 1:
        x = x[:, None]
    g = torch.as_tensor(grid_points, dtype=torch.float32).reshape(-1, x.shape[1])

    def shard_lse(dev, part):
        if not part.shape[0]:
            return None
        return kde_logsumexp(_to(g, dev), _to(part, dev), inv_two_bw2)

    lses = [lse for lse in run_per_device(shard_lse, mesh, split(x, mesh)) if lse is not None]
    if len(lses) == 1 and mesh.group is None:
        return _to(lses[0], first)
    if not lses:  # this process holds no sample
        lses = [torch.full((g.shape[0],), float("-inf"), device=first)]
    m = pmax(lses, mesh)
    # a grid point that no shard reaches keeps -inf, not nan
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    total = psum([torch.exp(lse - _to(m, lse.device)) for lse in lses], mesh)
    return m + torch.log(total)


__all__ = [
    "all_gather", "feature_sharded_covariance_ring", "feature_sharded_timelagged_ring",
    "lag_pairs_with_halo", "pmax", "pmin", "ppermute", "psum", "sharded_covariances",
    "sharded_feature_matrix_stats", "sharded_kde_logsumexp",
]
