"""Device geometry for featurization: the port of the JAX package's
geom/kernels.py.

A chunk of frames (C, A, 3) in Angstroms is uploaded once and every feature
of every frame is evaluated on the device: distances through kernel K1
(ops/pair_distances.py), dihedrals, centers and the Kabsch fit as plain
PyTorch ops. Host frames go up staged (`PlanEvaluator.eval_raw`): the
plan's atoms alone, gathered on host threads into a ring of pinned slots
and copied up a chunk a slot while the device works on the chunk before
(geom/transport.py); `UPLOAD_STATS` counts what went up.

Unit conventions match PLUMED colvars output: distances and coordinates in
nm, dihedral angles in radians (IUPAC sign).
"""

from __future__ import annotations

import threading
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deep_cartograph_torch.geom import transport
from deep_cartograph_torch.geom.transport import UPLOAD_STATS, UploadRing, staging
from deep_cartograph_torch.ops.pair_distances import (
    ANGSTROM_TO_NM,
    pair_distances as _pair_distances_kernel,
)
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device
from deep_cartograph_torch.utils.profiling import annotate

# ---------------------------------------------------------------------------
# Elementary geometry (vectorized over leading frame axes)
# ---------------------------------------------------------------------------


def pair_distances(coords: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """Distances between atom pairs. coords (..., A, 3) Angstrom -> (..., P) nm."""
    lead = coords.shape[:-2]
    flat = coords.reshape((-1,) + tuple(coords.shape[-2:])).contiguous()
    out = _pair_distances_kernel(flat, pairs.to(torch.int32).contiguous())
    return out.reshape(tuple(lead) + (pairs.shape[0],))


def dihedral_angles(coords: torch.Tensor, quads: torch.Tensor) -> torch.Tensor:
    """Dihedral angles over atom quadruplets (praxeolitic formula, IUPAC sign).

    coords (..., A, 3); quads (Q, 4) -> (..., Q) radians in (-pi, pi].
    """
    quads = quads.long()
    p0 = coords[..., quads[:, 0], :]
    p1 = coords[..., quads[:, 1], :]
    p2 = coords[..., quads[:, 2], :]
    p3 = coords[..., quads[:, 3], :]

    b0 = p0 - p1
    b1 = p2 - p1
    b2 = p3 - p2

    b1n = b1 / torch.linalg.vector_norm(b1, dim=-1, keepdim=True)
    # Components perpendicular to b1
    v = b0 - torch.sum(b0 * b1n, dim=-1, keepdim=True) * b1n
    w = b2 - torch.sum(b2 * b1n, dim=-1, keepdim=True) * b1n
    x = torch.sum(v * w, dim=-1)
    y = torch.sum(torch.linalg.cross(b1n, v, dim=-1) * w, dim=-1)
    return torch.atan2(y, x)


def group_centers(
    coords: torch.Tensor, center_atoms: torch.Tensor, center_mask: torch.Tensor
) -> torch.Tensor:
    """Geometric centers of padded atom groups.

    coords (..., A, 3), center_atoms (G, K), center_mask (G, K)
    -> (..., G, 3) Angstrom.
    """
    gathered = coords[..., center_atoms.reshape(-1).long(), :]
    gathered = gathered.reshape(
        tuple(coords.shape[:-2]) + tuple(center_atoms.shape) + (3,)
    )
    w = center_mask[..., None]
    return torch.sum(gathered * w, dim=-2) / torch.clamp_min(
        torch.sum(w, dim=-2), 1e-12
    )


# ---------------------------------------------------------------------------
# Optimal rotation (Kabsch)
# ---------------------------------------------------------------------------


def kabsch_rotation(
    mobile: torch.Tensor,
    reference: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Optimal rotation matrix (proper, det=+1) aligning mobile onto reference.

    mobile/reference: (..., N, 3) already in the same unit.
    Returns (R, mobile_centroid, reference_centroid) where aligned =
    (mobile - mc) @ R^T + rc. Weighted Kabsch via SVD.
    """
    if weights is None:
        w = torch.ones(mobile.shape[-2], dtype=mobile.dtype, device=mobile.device)
    else:
        w = weights
    w = w / torch.sum(w)
    wcol = w[..., :, None]
    mc = torch.sum(mobile * wcol, dim=-2, keepdim=True)
    rc = torch.sum(reference * wcol, dim=-2, keepdim=True)
    X = (mobile - mc) * wcol
    Y = reference - rc
    # Covariance (3x3): H = X^T Y
    H = X.transpose(-1, -2) @ Y
    U, _, Vt = torch.linalg.svd(H, full_matrices=False)
    V = Vt.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = (V * D[..., None, :]) @ Ut
    return R, mc, rc


def kabsch_align(
    mobile: torch.Tensor,
    reference: torch.Tensor,
    align_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Rigid-align each frame of `mobile` onto `reference` (both Angstroms).

    mobile (..., N, 3), reference (N, 3). Rotation/translation is fit on
    `align_weights`-weighted atoms and applied to all atoms.
    """
    R, mc, rc = kabsch_rotation(mobile, reference, align_weights)
    return (mobile - mc) @ R.transpose(-1, -2) + rc


def rmsd_per_frame(
    mobile: torch.Tensor,
    reference: torch.Tensor,
    fit_weights: Optional[torch.Tensor] = None,
    rmsd_indices: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Optimal-fit RMSD of each frame vs a reference structure (Angstroms).

    Fitting uses fit_weights; the RMSD is then measured over rmsd_indices
    (defaults to all atoms), the fit/group split of the reference's RMSD
    (md.py:1397-1454).
    """
    aligned = kabsch_align(mobile, reference, fit_weights)
    if rmsd_indices is not None:
        idx = torch.as_tensor(rmsd_indices, device=aligned.device).long()
        aligned = aligned.index_select(-2, idx)
        reference = reference.index_select(-2, idx)
    diff = aligned - reference
    return torch.sqrt(torch.mean(torch.sum(diff * diff, dim=-1), dim=-1))


# ---------------------------------------------------------------------------
# Feature-plan evaluation
# ---------------------------------------------------------------------------


def evaluate_plan_chunk(
    coords: torch.Tensor,
    dist_pairs: torch.Tensor,
    dist_center_a: torch.Tensor,
    dist_center_b: torch.Tensor,
    dihedral_quads: torch.Tensor,
    dihedral_mode: torch.Tensor,
    coord_atoms: torch.Tensor,
    coord_axes: torch.Tensor,
    center_atoms: torch.Tensor,
    center_mask: torch.Tensor,
    out_perm: torch.Tensor,
    fit_reference: Optional[torch.Tensor],
    fit_weights: Optional[torch.Tensor],
    *,
    n_features: int,
    has_centers: bool,
    identity_layout: bool,
) -> torch.Tensor:
    """Evaluate every feature for a chunk of frames. coords: (C, A, 3) Angstrom.

    The output is the concatenation of the segment results in plan order
    (distances, dihedrals, coordinates); unless the feature list is already
    grouped that way (`identity_layout`), one gather with `out_perm`
    restores the caller's column order.

    Distances go through kernel K1 in both strategies: on the atoms
    directly, or, when the plan has center entities, on the atoms with the
    group centers appended, indices of center slots pointing past the atoms.
    """
    C = coords.shape[0]
    segments = []

    if fit_reference is not None:
        coords = kabsch_align(coords, fit_reference, fit_weights)

    if dist_pairs.shape[0]:
        points, pairs = coords, dist_pairs
        if has_centers:
            centers = group_centers(coords, center_atoms, center_mask)  # (C, G, 3)
            n_atoms = coords.shape[1]
            points = torch.cat([coords, centers], dim=1)
            pairs = torch.stack([
                torch.where(dist_center_a >= 0, n_atoms + dist_center_a, dist_pairs[:, 0]),
                torch.where(dist_center_b >= 0, n_atoms + dist_center_b, dist_pairs[:, 1]),
            ], dim=1)
        segments.append(pair_distances(points, pairs))

    if dihedral_quads.shape[0]:
        angles = dihedral_angles(coords, dihedral_quads)
        values = torch.where(
            dihedral_mode == 0,
            angles,
            torch.where(dihedral_mode == 1, torch.sin(angles), torch.cos(angles)),
        )
        segments.append(values)

    if coord_atoms.shape[0]:
        pos = coords[:, coord_atoms.long(), :]  # (C, K, 3)
        vals = torch.gather(
            pos, 2, coord_axes.long()[None, :, None].expand(C, -1, 1)
        )[..., 0]
        segments.append(vals * ANGSTROM_TO_NM)

    if not segments:
        return torch.zeros((C, n_features), dtype=coords.dtype, device=coords.device)
    cat = segments[0] if len(segments) == 1 else torch.cat(segments, dim=1)
    if identity_layout:
        return cat
    return cat[:, out_perm.long()]


# ---------------------------------------------------------------------------
# A plan's evaluator, fed by the staged copy up of host frames (geom/transport.py)
# ---------------------------------------------------------------------------


class _AtomIndices(NamedTuple):
    """The plan's index tensors that number atoms, for one layout of the
    frames: the caller's, or the compact one of the plan's atoms alone."""

    dist_pairs: torch.Tensor
    dihedral_quads: torch.Tensor
    coord_atoms: torch.Tensor
    center_atoms: torch.Tensor


class PlanEvaluator:
    """Evaluator for a FeaturePlan on one topology, on one device.

    Build once per (feature list, topology); call on frame chunks of any
    length (the kernels mask ragged edges, so there is no padding).

    Host frames go to the device staged (`eval_raw`): only the atoms the
    plan reads, gathered on host threads into the slots of the evaluator's
    ring (`geom/transport.py::UploadRing`) and copied up a chunk a slot on
    a stream of their own, while the device works on the chunk before.
    Frames already on a device are used as they are.
    """

    def __init__(
        self,
        plan,
        fit_reference: Optional[np.ndarray] = None,
        fit_weights: Optional[np.ndarray] = None,
        device: DeviceLike = None,
    ):
        """`device`: None means CUDA (raises without a card); pass "cpu" to
        run the plain PyTorch versions on the host."""
        self.plan = plan
        self.device = resolve_device(device)
        self._ring: Optional[UploadRing] = None
        self._ring_lock = threading.Lock()
        self._build(plan, fit_reference, fit_weights)

    def _tensor(self, array, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array), dtype=dtype, device=self.device)

    def _build(self, plan, fit_reference, fit_weights):
        self._fit_reference = (
            self._tensor(fit_reference, torch.float32) if fit_reference is not None else None
        )
        self._fit_weights = (
            self._tensor(fit_weights, torch.float32) if fit_weights is not None else None
        )
        dist_pairs = plan.dist_pairs.reshape(-1, 2)
        has_centers = bool(
            np.any(plan.dist_center_a >= 0) or np.any(plan.dist_center_b >= 0)
        )
        self._dihedral_mode = self._tensor(plan.dihedral_mode)
        self._coord_axes = self._tensor(plan.coord_axes)
        self._center_mask = self._tensor(plan.center_mask, torch.float32)
        self._dist_center_a = self._tensor(plan.dist_center_a)
        self._dist_center_b = self._tensor(plan.dist_center_b)
        # Output layout: segment results are concatenated in plan order
        # (dist, dihedral, coord); `order` maps concat position -> output
        # column. Grouped feature lists (the common case) need no gather.
        order = np.concatenate(
            [plan.dist_out, plan.dihedral_out, plan.coord_out]
        ).astype(np.int64)
        self._identity_layout = bool(
            order.shape[0] == plan.n_features
            and np.array_equal(order, np.arange(plan.n_features))
        )
        self._out_perm = self._tensor(
            np.argsort(order) if order.shape[0] else np.zeros(0, np.int64),
            torch.int64,
        )
        self._has_centers = has_centers
        self._n_features = int(plan.n_features)
        # Every atom index of the plan, checked once here on the host so no
        # call waits for the device to check them.
        index_arrays = (dist_pairs, plan.dihedral_quads.reshape(-1, 4),
                        plan.coord_atoms, plan.center_atoms)
        atoms = np.concatenate([np.asarray(a).reshape(-1) for a in index_arrays])
        self._n_atoms_needed = int(atoms.max() + 1) if atoms.size else 0
        self._full = _AtomIndices(*(self._tensor(a) for a in index_arrays))
        # The atoms the plan reads: not the placeholder of a pair's center
        # side nor a center's padding, which the features never read. Staged
        # frames hold these alone, in this order, and the compact indices
        # number them so; placeholders and padding point at the first.
        read = np.concatenate([
            dist_pairs[plan.dist_center_a < 0, 0], dist_pairs[plan.dist_center_b < 0, 1],
            plan.dihedral_quads.reshape(-1), plan.coord_atoms.reshape(-1),
            plan.center_atoms[plan.center_mask > 0],
        ]).astype(np.int64)
        self._atoms = np.unique(read)
        remap = np.zeros(max(self._n_atoms_needed, 1), np.int64)
        remap[self._atoms] = np.arange(len(self._atoms))
        self._compact = _AtomIndices(*(self._tensor(remap[np.asarray(a)])
                                       for a in index_arrays))

    def __call__(self, coords_chunk) -> np.ndarray:
        """(C, A, 3) Angstrom float -> (C, F) feature matrix (nm / radians)."""
        features = self.eval_raw(coords_chunk)
        with annotate("transfer.d2h"):
            return features.cpu().numpy()

    def eval_raw(self, coords_chunk, then: Optional[Callable] = None) -> torch.Tensor:
        """(C, A, 3) Angstrom frames -> their (C, F) features on the device
        (no host download); with `then`, then(features) of every chunk,
        its rows in one (C, ...) tensor.

        Host frames (numpy or a CPU tensor) go up staged, a chunk a slot of
        the ring, the next chunk gathered and copied while the device works
        on this one; only the plan's atoms, unless a fit reference (aligned
        on every atom) needs them all or the frames hold no others. The call
        returns with the caller's frames read. Frames on a device go as they
        are, in one piece."""
        if isinstance(coords_chunk, torch.Tensor) and coords_chunk.device.type != "cpu":
            with annotate("transfer.h2d"):
                coords = torch.as_tensor(coords_chunk, dtype=torch.float32).to(self.device)
            self._check_shape(coords.shape)
            with annotate("features.eval"):
                features = self._evaluate(coords, self._full)
            return features if then is None else then(features)
        if isinstance(coords_chunk, torch.Tensor):
            coords_chunk = coords_chunk.detach().numpy()
        frames = np.asarray(coords_chunk)
        self._check_shape(frames.shape)
        with self._ring_lock, staging():
            return self._eval_staged(frames, then)

    def chunk_frames(self, n_atoms: int) -> int:
        """Frames of `n_atoms` atoms that one chunk of the staged copy up
        holds: a slot of what goes up of each (the plan's atoms, or all)."""
        return max(1, transport.SLOT_BYTES // (12 * max(self._staged_width(n_atoms), 1)))

    def _staged_width(self, n_atoms: int) -> int:
        """Atoms a frame of `n_atoms` keeps staged: the plan's alone, unless
        a fit reference (aligned on every atom) needs them all or the frames
        hold no others."""
        gather = self._fit_reference is None and len(self._atoms) < n_atoms
        return len(self._atoms) if gather else n_atoms

    def _check_shape(self, shape) -> None:
        if len(shape) != 3 or shape[2] != 3 or shape[1] < self._n_atoms_needed:
            raise IndexError(
                f"frames of shape {tuple(shape)} lack the plan's "
                f"{self._n_atoms_needed} atoms"
            )

    def _eval_staged(self, frames: np.ndarray, then: Optional[Callable]) -> torch.Tensor:
        n, n_atoms = frames.shape[:2]
        width = self._staged_width(n_atoms)
        atoms, indices = (self._atoms, self._compact) if width < n_atoms else (None, self._full)
        step = self.chunk_frames(n_atoms)
        floats = max(transport.SLOT_BYTES // 4, 3 * step * width)
        if self._ring is None or self._ring.floats < floats:
            self._ring = UploadRing(self.device, floats)
        ring = self._ring
        UPLOAD_STATS.count_call()
        out = None
        for a in range(0, max(n, 1), step):
            b = min(a + step, n)
            with annotate("transfer.h2d"):
                block = np.ascontiguousarray(frames[a:b], dtype=np.float32)
                coords, slot, waited = ring.stage(block, atoms)
            UPLOAD_STATS.count_chunk(b - a, 4 * coords.numel(), block.nbytes, waited)
            with annotate("features.eval"):
                features = self._evaluate(coords, indices)
            ring.done_reading(slot)
            part = features if then is None else then(features)
            if b - a == n:
                return part
            if out is None:
                out = part.new_empty((n,) + tuple(part.shape[1:]))
            out[a:b] = part
        return out

    def _evaluate(self, coords: torch.Tensor, indices: _AtomIndices) -> torch.Tensor:
        return evaluate_plan_chunk(
            coords,
            indices.dist_pairs,
            self._dist_center_a,
            self._dist_center_b,
            indices.dihedral_quads,
            self._dihedral_mode,
            indices.coord_atoms,
            self._coord_axes,
            indices.center_atoms,
            self._center_mask,
            self._out_perm,
            self._fit_reference,
            self._fit_weights,
            n_features=self._n_features,
            has_centers=self._has_centers,
            identity_layout=self._identity_layout,
        )
