"""Periodic-boundary trajectory preparation: molecule unwrap + centering.

Behavioral parity with the reference's trajectory-preparation transforms
(deep_cartograph/modules/md/md.py:948-1016: MDAnalysis ``trans.unwrap(ag)``
followed by ``trans.center_in_box(ag, wrap=True)``), rebuilt on a spanning
forest of the bond graph so every level of corrections is one vectorized
minimum-image update over all frames at once instead of a per-atom Python
walk.

Orthorhombic cells only (boxes from io.boxes are diagonal); callers are
warned upstream for skewed cells.

A numpy copy of the JAX package's geom/pbc.py (host code there too), so the
port imports nothing of that package.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def bond_spanning_levels(
    bonds: Sequence[Tuple[int, int]],
    n_atoms: int,
    group: Optional[np.ndarray] = None,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """BFS spanning forest of the bond graph as per-level (parents, children)
    edge arrays. Every fragment root stays where it is; level k repositions
    all atoms at bond-distance k from their root simultaneously."""
    if group is not None:
        keep = np.zeros(n_atoms, bool)
        keep[np.asarray(group)] = True
    else:
        keep = np.ones(n_atoms, bool)

    adj: List[List[int]] = [[] for _ in range(n_atoms)]
    for a, b in bonds:
        a, b = int(a), int(b)
        if keep[a] and keep[b]:
            adj[a].append(b)
            adj[b].append(a)

    visited = np.zeros(n_atoms, bool)
    levels: List[Tuple[List[int], List[int]]] = []
    for root in range(n_atoms):
        if visited[root] or not keep[root] or not adj[root]:
            continue
        visited[root] = True
        frontier = [root]
        depth = 0
        while frontier:
            nxt: List[int] = []
            for parent in frontier:
                for child in adj[parent]:
                    if not visited[child]:
                        visited[child] = True
                        if depth == len(levels):
                            levels.append(([], []))
                        levels[depth][0].append(parent)
                        levels[depth][1].append(child)
                        nxt.append(child)
            frontier = nxt
            depth += 1
    return [
        (np.asarray(p, np.int64), np.asarray(c, np.int64)) for p, c in levels
    ]


def make_whole(
    coords: np.ndarray,
    box: np.ndarray,
    levels: List[Tuple[np.ndarray, np.ndarray]],
) -> np.ndarray:
    """Unwrap molecules across periodic boundaries (MDAnalysis
    ``trans.unwrap`` equivalent). coords (F, A, 3), box (F, 3) or (3,),
    both Angstroms. Returns a new array."""
    coords = np.array(coords, np.float32)
    box = np.asarray(box, np.float32)
    if box.ndim == 1:
        box = box[None, :]
    b = box[:, None, :]  # (F, 1, 3)
    for parents, children in levels:
        delta = coords[:, children] - coords[:, parents]
        delta -= b * np.round(delta / b)
        coords[:, children] = coords[:, parents] + delta
    return coords


def center_in_box(
    coords: np.ndarray,
    box: np.ndarray,
    group: Optional[np.ndarray] = None,
    wrap: bool = True,
) -> np.ndarray:
    """Translate every frame so the group's geometric center sits at the box
    center (MDAnalysis ``trans.center_in_box(ag, wrap=True)`` equivalent:
    `wrap` wraps the group into the primary cell before taking its center;
    the translation itself moves all atoms, unwrapped)."""
    coords = np.asarray(coords, np.float32)
    box = np.asarray(box, np.float32)
    if box.ndim == 1:
        box = np.broadcast_to(box[None, :], (coords.shape[0], 3))
    sel = coords if group is None else coords[:, np.asarray(group)]
    if wrap:
        b = box[:, None, :]
        sel = sel - b * np.floor(sel / b)
    center = sel.mean(axis=1)  # (F, 3)
    shift = box / 2.0 - center
    return coords + shift[:, None, :]


def prepare_frames(
    coords: np.ndarray,
    box: Optional[np.ndarray],
    bonds: Sequence[Tuple[int, int]],
    group: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Full trajectory preparation: unwrap (if bonds) then center (if box) —
    mirroring the reference's conditional transform stack with the same
    warnings (md.py:992-1013)."""
    if box is None:
        logger.warning(
            "Trajectory has no box dimensions. Cannot unwrap or center."
        )
        return np.asarray(coords, np.float32)
    if len(bonds) == 0:
        logger.warning("Topology does not contain bonds. Cannot unwrap trajectory.")
    else:
        levels = bond_spanning_levels(bonds, coords.shape[1], group)
        coords = make_whole(coords, box, levels)
    return center_in_box(coords, box, group, wrap=True)
