"""Bytes and floating-point operations of the timed work, from shapes, and
the table of the card's peaks.

Counted as the reference's formulas compute them, each input byte read
once and each output byte written once; a square root, division, sine,
cosine or arctangent counts as one operation.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"

DIST_FLOPS = 10       # 3 differences, 3 squares, 2 sums, a root, the nm scale
DIHEDRAL_FLOPS = 62   # reference.features: b0..b2, |b1|, v, w, cross, two dots, atan2
SINCOS_FLOPS = 2


def peaks(device_name: str) -> Optional[dict]:
    """The published peaks of the named card, or None for a card the table
    lacks (then no share of a peak is reported)."""
    return json.loads(PEAKS_FILE.read_text()).get(device_name)


def k1_bytes(frames: int, n_ca: int, n_pairs: int) -> int:
    """K1's least traffic: the CA coordinates read once (float32 x, y, z),
    the distances written once (float32)."""
    return frames * (12 * n_ca + 4 * n_pairs)


def k1_flops(frames: int, n_pairs: int) -> int:
    return frames * n_pairs * DIST_FLOPS


def feature_flops(frames: int, n_pairs: int, n_quads: int) -> int:
    """Distances and the sin and cos of each dihedral, per frame."""
    return frames * (n_pairs * DIST_FLOPS + n_quads * (DIHEDRAL_FLOPS + SINCOS_FLOPS))


def mlp_forward_flops(rows: int, layers: Sequence[int], dropout_layers: int = 0) -> int:
    """Dense layers (2 in out), bias and activation (2 out) per row, and
    dropout's scale and select on the first `dropout_layers` layers."""
    total = 0
    for i, (fan_in, fan_out) in enumerate(zip(layers[:-1], layers[1:])):
        total += 2 * fan_in * fan_out + 2 * fan_out + (2 * fan_out if i < dropout_layers else 0)
    return rows * total


def serve_flops(frames: int, n_pairs: int, n_quads: int, layers: Sequence[int]) -> int:
    """The served CV per frame: features, their normalization (2 a
    feature), the encoder, the TICA layer and the post normalization."""
    dim = layers[-1]
    return (feature_flops(frames, n_pairs, n_quads) + frames * 2 * layers[0]
            + mlp_forward_flops(frames, layers) + frames * (2 * dim * dim + 2 * dim))


def train_step_flops(batch: int, tries: int, layers: Sequence[int],
                     dropout_layers: int) -> int:
    """One deep-TICA step of every try: the normalization and forward of
    both lag halves, their backward (the weight gradient of every layer and
    the input gradient of every layer but the first, 2 in out each), the
    covariances (C0 and both halves of Ctau, 2 B d^2 each) and Adam (12 an
    entry). The d x d eigenproblem is left out: under 100 operations."""
    dim = layers[-1]
    matmul = sum(2 * a * b for a, b in zip(layers[:-1], layers[1:]))
    first = 2 * layers[0] * layers[1]
    halves = 2 * (batch * 2 * layers[0] + mlp_forward_flops(batch, layers, dropout_layers)
                  + batch * (2 * matmul - first))
    covariances = 3 * 2 * batch * dim * dim
    n_params = sum(a * b + b for a, b in zip(layers[:-1], layers[1:]))
    return tries * (halves + covariances + 12 * n_params)
