"""Cross-topology residue mapping via local sequence alignment.

A copy of the JAX package's features/mapper.py: a Smith-Waterman/Gotoh
local aligner with the scoring of the reference's Biopython aligner (match
+1, mismatch -1, gap open -2, gap extend -0.5). Inputs are protein
sequences, so this stays host-side numpy.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

MATCH_SCORE = 1.0
MISMATCH_SCORE = -1.0
GAP_OPEN = -2.0
GAP_EXTEND = -0.5


def local_align(seq_a: str, seq_b: str) -> List[Tuple[int, int]]:
    """Best local alignment of two sequences (Gotoh affine-gap DP).

    Returns the list of aligned index pairs (i, j) — positions matched or
    mismatched, gaps excluded — equivalent to flattening Biopython's
    ``alignment.aligned`` blocks.
    """
    n, m = len(seq_a), len(seq_b)
    if n == 0 or m == 0:
        return []

    neg_inf = -1e18
    # M: ends in a match/mismatch; X: gap in seq_b (consume a); Y: gap in seq_a
    M = np.zeros((n + 1, m + 1))
    X = np.full((n + 1, m + 1), neg_inf)
    Y = np.full((n + 1, m + 1), neg_inf)
    # Tracebacks: 0=stop(local), 1=from M, 2=from X, 3=from Y
    tb_M = np.zeros((n + 1, m + 1), dtype=np.int8)
    tb_X = np.zeros((n + 1, m + 1), dtype=np.int8)
    tb_Y = np.zeros((n + 1, m + 1), dtype=np.int8)

    a = np.frombuffer(seq_a.encode(), dtype=np.uint8)
    b = np.frombuffer(seq_b.encode(), dtype=np.uint8)

    best, best_pos = 0.0, (0, 0)
    for i in range(1, n + 1):
        sub_row = np.where(b == a[i - 1], MATCH_SCORE, MISMATCH_SCORE)
        for j in range(1, m + 1):
            s = sub_row[j - 1]
            # X: gap in b (move down)
            x_open = M[i - 1, j] + GAP_OPEN
            x_ext = X[i - 1, j] + GAP_EXTEND
            if x_open >= x_ext:
                X[i, j], tb_X[i, j] = x_open, 1
            else:
                X[i, j], tb_X[i, j] = x_ext, 2
            # Y: gap in a (move right)
            y_open = M[i, j - 1] + GAP_OPEN
            y_ext = Y[i, j - 1] + GAP_EXTEND
            if y_open >= y_ext:
                Y[i, j], tb_Y[i, j] = y_open, 1
            else:
                Y[i, j], tb_Y[i, j] = y_ext, 3
            # M: diagonal from best of three, floored at 0 (local)
            cand = (M[i - 1, j - 1], X[i - 1, j - 1], Y[i - 1, j - 1])
            k = int(np.argmax(cand))
            val = cand[k] + s
            if val <= 0:
                M[i, j], tb_M[i, j] = 0.0, 0
            else:
                M[i, j] = val
                tb_M[i, j] = k + 1
            if M[i, j] > best:
                best, best_pos = M[i, j], (i, j)

    if best <= 0:
        return []

    # Traceback from the best M cell
    pairs: List[Tuple[int, int]] = []
    i, j = best_pos
    state = 1  # in M
    while i > 0 and j > 0:
        if state == 1:
            pairs.append((i - 1, j - 1))
            prev = tb_M[i, j]
            i -= 1
            j -= 1
            if prev == 0:
                break
            state = prev
        elif state == 2:
            prev = tb_X[i, j]
            i -= 1
            state = prev
        else:  # state == 3
            prev = tb_Y[i, j]
            j -= 1
            state = prev
    pairs.reverse()
    return pairs


class PDBTopologyMapper:
    """Maps residues of a reference topology onto a target topology.

    Mapping format (the reference's):
        {ref_resid: (ref_resname_1letter, target_resname_1letter, target_resid)}
    """

    def __init__(self, reference_topology: str, target_topology: str):
        from deep_cartograph_torch.io.topology import Topology

        ref_top = Topology.from_file(reference_topology)
        tgt_top = Topology.from_file(target_topology)

        self.ref_sequence, self.ref_resids = ref_top.residue_sequence()
        self.sequence, self.resids = tgt_top.residue_sequence()

        pairs = local_align(self.ref_sequence, self.sequence)
        self.mapping: Dict[int, Tuple[str, str, int]] = {}
        for ia, ib in pairs:
            self.mapping[self.ref_resids[ia]] = (
                self.ref_sequence[ia],
                self.sequence[ib],
                self.resids[ib],
            )

    def map_residue(self, ref_residue_index: int) -> Optional[int]:
        """Target resid for a reference resid, or None."""
        entry = self.mapping.get(ref_residue_index)
        return entry[2] if entry else None
