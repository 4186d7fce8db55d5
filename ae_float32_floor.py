#!/usr/bin/env python3
"""How far one float32 ulp of input noise moves a trained AE's projection
with leaky_relu and with tanh, on the CPU (PyTorch port, `device="cpu"`).

Run from the repository root:

    python3 ae_float32_floor.py

The data are chip_smoke.py's: the main path's 100,000-frame trajectory,
its 1,171 features computed by numpy (`chip_smoke.numpy_features`), the
features whose std over all frames (float64, rounded to 3 decimals) is not
below the median, and the first 5,000 or 20,000 frames of those. The AE is
chip_smoke.py's cut-down card-against-CPU training (AUTOENCODER_CONFIG,
2 tries, Adam 1e-3 unless the case says SGD), its activation (encoder and
mirrored decoder) set by the case. Each case trains from the frames and
again from the frames times (1 + 6e-8 n) for seeded normal noise n, and
reports the largest difference of the two post-normalized projections over
the frames (the float32 floor of a card-against-CPU comparison of the same
training); `moved` is how far
the training moved the projection from that of the untrained net (lr 0).
leaky_relu's slope jumps at 0, so rounding that moves a pre-activation
across 0 changes that row's gradient by a finite amount; tanh is smooth.
One JSON line per case.
"""

from __future__ import annotations

import copy
import json

import numpy as np
import torch

import chip_smoke as smoke
from deep_cartograph_torch.stats.descriptors import quantile_mask

NOISE_SEEDS = range(6)
FEATURE_CHUNK = 10_000
# (activation, frames, optimizer, lr, epochs, noise seeds)
CASES = (
    ("leaky_relu", 5_000, "Adam", 1e-3, 2, NOISE_SEEDS),
    ("tanh", 5_000, "Adam", 1e-3, 2, NOISE_SEEDS),
    ("leaky_relu", 20_000, "Adam", 1e-3, 2, range(2)),
    ("tanh", 20_000, "Adam", 1e-3, 2, range(2)),
    ("leaky_relu", 5_000, "SGD", 0.1, 2, range(3)),
    ("tanh", 5_000, "SGD", 0.1, 2, range(3)),
)


def kept_features(frames: int):
    """The first `frames` rows of the main path's filtered feature matrix,
    and the kept labels."""
    coords = smoke.make_trajectory(smoke.N_FRAMES, smoke.N_ATOMS)
    labels = smoke.make_labels(smoke.N_ATOMS)
    total = np.zeros(len(labels))
    squares = np.zeros(len(labels))
    for start in range(0, smoke.N_FRAMES, FEATURE_CHUNK):
        f = smoke.numpy_features(coords[start:start + FEATURE_CHUNK], labels)
        f = f.astype(np.float64)
        total += f.sum(0)
        squares += (f * f).sum(0)
    mean = total / smoke.N_FRAMES
    std = np.round(np.sqrt(squares / smoke.N_FRAMES - mean ** 2), 3)
    keep = quantile_mask(std, smoke.STD_QUANTILE)
    x = smoke.numpy_features(coords[:frames], labels)[:, keep]
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)), \
        [lab for lab, k in zip(labels, keep) if k]


def projection(x, labels, activation: str, optimizer: str, lr: float,
               epochs: int) -> np.ndarray:
    config = copy.deepcopy(smoke.AUTOENCODER_CONFIG)
    config["architecture"]["encoder"]["activation"] = [activation] * 3
    config["training"]["optimizer"] = {"name": optimizer, "kwargs": {"lr": lr}}
    calc = smoke.calculator("ae", config, x, labels, "cpu",
                            num_tries=smoke.CUT_TRIES, max_epochs=epochs)
    calc.train()
    calc.normalize_cv()
    return calc.project_data(x)


def ulp_noise(x: torch.Tensor, seed: int) -> torch.Tensor:
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(seed))
    return x * (1 + 6e-8 * noise)


def main() -> None:
    x_all, labels = kept_features(max(case[1] for case in CASES))
    for activation, frames, optimizer, lr, epochs, seeds in CASES:
        x = x_all[:frames]
        case = (activation, optimizer, lr, epochs)
        base = projection(x, labels, *case)
        untrained = projection(x, labels, activation, optimizer, 0.0, epochs)
        spreads = [float(np.abs(projection(ulp_noise(x, s), labels, *case) - base).max())
                   for s in seeds]
        print(json.dumps({
            "activation": activation, "frames": frames, "features": len(labels),
            "optimizer": optimizer, "lr": lr, "epochs": epochs,
            "moved": float(np.abs(base - untrained).max()), "ulp_noise_spread": spreads,
        }), flush=True)


if __name__ == "__main__":
    main()
