#!/usr/bin/env python3
"""How far one float32 ulp of input noise moves the port's UMAP layout, on
the CPU (PyTorch port, `device="cpu"`).

Run from the repository root:

    python3 umap_float32_floor.py

The data are 300 Gaussian rows of 6 features with well separated variances
(5, 3, 2, 1, 0.5, 0.2; seed 10), the tests' `anisotropic` rows. Each case
fits UMAPModel (k = 15, min_dist 0.1) for `epochs` epochs from the data and
again from the data times (1 + 6e-8 n) for seeded normal noise n, both with
the same numpy draws, and reports the largest difference of the two
embeddings after a sign per axis (`spread`) beside the embedding's largest
value (`scale`). The `one_epoch_from_same_graph` case runs one layout epoch
from the PCA initialization and from it times (1 + 6e-8 n), over the same
graph and draws. One JSON line per case.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from deep_cartograph_torch.cv.umap_cv import (
    UMAPModel,
    _fuzzy_weights,
    _knn,
    _pca_init,
    _smooth_knn,
    _symmetrize,
    layout_epoch,
)

EPOCHS = (1, 2, 5, 10, 30)


def draws_for(n: int):
    def draws(epoch, n_edges):
        rng = np.random.default_rng([0, epoch])
        return rng.random(n_edges, dtype=np.float32), rng.integers(0, n, (n_edges, 5))
    return draws


def ulp_noise(x: np.ndarray, seed: int = 1) -> np.ndarray:
    noise = np.random.default_rng(seed).standard_normal(x.shape)
    return (x * (1 + 6e-8 * noise)).astype(np.float32)


def spread(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a * np.sign(np.sum(a * b, axis=0)) - b).max())


def main() -> None:
    torch.set_num_threads(4)
    x = (np.random.default_rng(10).normal(size=(300, 6))
         * np.array([5.0, 3.0, 2.0, 1.0, 0.5, 0.2])).astype(np.float32)
    n = x.shape[0]
    for epochs in EPOCHS:
        fits = [UMAPModel(2, n_epochs=epochs, device="cpu").fit(data, draws_for(n)).embedding_
                for data in (x, ulp_noise(x))]
        print(json.dumps({"case": "fit", "epochs": epochs, "spread": spread(*fits),
                          "scale": float(np.abs(fits[0]).max())}), flush=True)
    xt = torch.as_tensor(x)
    dists, idx = _knn(xt, xt, 15, exclude_self=True)
    heads, tails, weights = _symmetrize(
        idx.numpy(), _fuzzy_weights(dists, *_smooth_knn(dists)).numpy(), n)
    uniform, negatives = draws_for(n)(0, len(heads))
    model = UMAPModel(2, device="cpu")
    init = _pca_init(xt, 2).numpy()
    out = [layout_epoch(torch.as_tensor(e), *(torch.as_tensor(v) for v in (
        heads, tails, weights, uniform, negatives)), 1.0, model.a, model.b).numpy()
        for e in (init.copy(), ulp_noise(init))]
    print(json.dumps({"case": "one_epoch_from_same_graph", "spread": spread(*out),
                      "scale": float(np.abs(out[0]).max())}), flush=True)


if __name__ == "__main__":
    main()
