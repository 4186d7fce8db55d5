"""The plain reference of the UMAP CV (`configs/lambda80_umap.json`),
written from the algorithm the program documents, in plain PyTorch: the
features normalized by their mean and standard deviation, the exact kNN,
each point's rho and sigma by bisection to log2 k, the fuzzy union
W + W^T - W o W^T, a PCA start scaled to a standard deviation of 10, and
the layout's epochs: edges accepted where a uniform draw lies below their
weight, umap-learn's attraction and repulsion coefficients with each
gradient clipped at +-4, 5 negative samples an edge and a learning rate
falling linearly to 0. It imports nothing of the program and takes nothing
the program made but what a check hands it (a kNN, a graph, an embedding
and the draws of an epoch, to work the next stage out from).

Every function takes a `reference.Precision` (float64 for the reference;
float32 with TF32 products in the kNN for the control). `fit` is the
reference put in the program's place: a whole fit in a precision, with a
planted fault where asked.

Where this follows the program rather than arXiv:1802.03426 and umap-learn
(`umap.UMAP`, the reference package's UMAP calculator), on purpose:

- The kNN is exact (the d2 expansion over every pair), where umap-learn
  finds approximate neighbours by NN-descent.
- The start is the data's leading principal components, each scaled to a
  standard deviation of 10, where umap-learn starts from a spectral
  embedding of the graph.
- Each epoch draws a uniform number for every edge and accepts the edge
  where it lies below the edge's weight (Bernoulli acceptance), where
  umap-learn samples each edge on its epochs-per-sample schedule.
- An epoch moves the embedding in two sweeps: every accepted edge's
  attraction (added at the head, subtracted at the tail), then every
  accepted head's repulsion from its 5 negative samples, read from the
  embedding the first sweep left; umap-learn moves edge after edge.
- 300 epochs, the program's, where umap-learn's own default for more than
  10,000 points is 200.
- An entry of the union whose weight is 0 is no edge, as a sparse sum
  stores none.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from carto_bench.reference import FLOAT64, Precision

FLOAT32_UNIT_ROUNDOFF = 2.0 ** -24
SIGMA_BOUNDS = (1e-8, 1e4)
SIGMA_ITERATIONS = 64
INIT_STD = 10.0
GRAD_CLIP = 4.0
REPULSION_EPS = 0.001
KNN_BLOCK_ELEMENTS = 1 << 25
EARLY_EPOCHS = 3


def fit_ab(min_dist: float, spread: float = 1.0) -> Tuple[float, float]:
    """umap-learn's curve 1 / (1 + a x^(2b)) fitted by least squares to 1
    below `min_dist` and exp(-(x - min_dist) / spread) above, on 300 points
    of [0, 3 spread] (`umap.umap_.find_ab_params`)."""
    from scipy.optimize import curve_fit

    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))
    (a, b), _ = curve_fit(lambda x, a, b: 1.0 / (1.0 + a * x ** (2 * b)), xv, yv,
                          p0=(1.0, 1.0), maxfev=5000)
    return float(a), float(b)


def normalize(x: torch.Tensor, mode: Optional[str]) -> torch.Tensor:
    """The features in float64, centred on their mean and divided by their
    standard deviation (population; one where it is below 1e-8) for
    `mean_std`, as they are for None."""
    x = x.double()
    if mode is None:
        return x
    if mode != "mean_std":
        raise ValueError(f"the reference normalizes by mean_std or not at all, not {mode!r}")
    std = x.std(0, unbiased=False)
    return (x - x.mean(0)) / torch.where(std.abs() < 1e-8, torch.ones_like(std), std)


def squared_distances(queries: torch.Tensor, data: torch.Tensor,
                      p: Precision = FLOAT64) -> torch.Tensor:
    """|q|^2 - 2 q.x + |x|^2 of every (query, data row), in p (its matrix
    product in p's mode)."""
    q, x = queries.to(p.dtype), data.to(p.dtype)
    return (q * q).sum(1)[:, None] - 2 * p.mm(q, x.T) + (x * x).sum(1)[None, :]


def knn(data: torch.Tensor, k: int, p: Precision = FLOAT64,
        rows: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest other rows of each of `rows` (every row by default)
    among `data`, by the d2 expansion in p: (distances, indices), nearest
    first, a block of queries at a time."""
    rows = torch.arange(len(data), device=data.device) if rows is None else rows
    block = max(1, KNN_BLOCK_ELEMENTS // max(len(data), 1))
    dists, idx = [], []
    with p.scope():
        for a in range(0, len(rows), block):
            r = rows[a:a + block]
            d2 = squared_distances(data[r], data, p)
            d2[torch.arange(len(r), device=d2.device), r] = math.inf
            best = torch.topk(d2, k, dim=1, largest=False)
            dists.append(torch.sqrt(torch.clamp_min(best.values, 0.0)))
            idx.append(best.indices)
    return torch.cat(dists), torch.cat(idx)


def smooth_knn(dists: torch.Tensor, n_neighbors: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """rho, each point's nearest distance, and sigma, which solves
    sum_j exp(-(d_ij - rho) / sigma) = log2(n_neighbors) over the point's
    neighbours, by 64 bisections of [1e-8, 1e4], in the distances' dtype."""
    rho = dists[:, 0]
    excess = torch.clamp_min(dists - rho[:, None], 0.0)
    target = math.log2(n_neighbors)
    lo = torch.full_like(rho, SIGMA_BOUNDS[0])
    hi = torch.full_like(rho, SIGMA_BOUNDS[1])
    for _ in range(SIGMA_ITERATIONS):
        mid = 0.5 * (lo + hi)
        too_big = torch.exp(-excess / mid[:, None]).sum(1) > target
        lo, hi = torch.where(too_big, lo, mid), torch.where(too_big, mid, hi)
    return rho, 0.5 * (lo + hi)


def membership(dists: torch.Tensor, rho: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """W: each neighbour's weight exp(-max(d - rho, 0) / sigma)."""
    return torch.exp(-torch.clamp_min(dists - rho[:, None], 0.0) / sigma[:, None])


def fuzzy_union(idx: torch.Tensor, w: torch.Tensor, n: int,
                union: bool = True) -> Dict[str, torch.Tensor]:
    """The graph W + W^T - W o W^T of the kNN graph W (row i's neighbours
    `idx[i]` with weights `w[i]`), as edges sorted by (head, tail): heads,
    tails, weights; with `union` False, W's own edges (a fault)."""
    heads = torch.arange(n, device=idx.device).repeat_interleave(idx.shape[1])
    tails = idx.reshape(-1).long()
    w = w.reshape(-1)
    if not union:
        key = heads * n + tails
        order = torch.argsort(key)
        return {"heads": heads[order], "tails": tails[order], "weights": w[order]}
    keys = torch.cat([heads * n + tails, tails * n + heads])
    unique, inverse = torch.unique(keys, return_inverse=True)
    zeros = torch.zeros_like(w)
    w_ab = torch.zeros(len(unique), dtype=w.dtype, device=w.device).index_add_(
        0, inverse, torch.cat([w, zeros]))
    w_ba = torch.zeros_like(w_ab).index_add_(0, inverse, torch.cat([zeros, w]))
    weights = w_ab + w_ba - w_ab * w_ba
    keep = weights != 0
    return {"heads": unique[keep] // n, "tails": unique[keep] % n, "weights": weights[keep]}


def pca_init(x: torch.Tensor, n_components: int, p: Precision = FLOAT64) -> torch.Tensor:
    """The rows' projections on the leading eigenvectors of their
    covariance, each scaled to a standard deviation of 10 (no sign rule):
    (start, eigenvalues in descending order)."""
    with p.scope():
        xc = x.to(p.dtype) - x.to(p.dtype).mean(0)
        evals, evecs = torch.linalg.eigh(p.mm(xc.T, xc) / len(xc))
        init = xc @ evecs.flip(1)[:, :n_components]
    return INIT_STD * init / (init.std(0, unbiased=False) + 1e-8), evals.flip(0)


def learning_rate(epoch: int, n_epochs: int, initial: float = 1.0) -> float:
    """umap-learn's rate of an epoch: initial (1 - epoch / n_epochs)."""
    return initial * (1.0 - epoch / n_epochs)


def layout_epoch(emb: torch.Tensor, graph: Dict[str, torch.Tensor], uniform: torch.Tensor,
                 negatives: torch.Tensor, alpha: float, a: float, b: float,
                 repulsion: bool = True) -> torch.Tensor:
    """One epoch from `emb` (left unchanged), in its dtype: the accepted
    edges' attraction -2ab d2^(b-1) / (1 + a d2^b) (0 for coincident
    points), then each accepted head's repulsion 2b / ((0.001 + d2)
    (1 + a d2^b)) from its negative samples, each gradient clipped at +-4
    and scaled by `alpha`."""
    emb = emb.clone()
    heads, tails = graph["heads"], graph["tails"]
    accept = (uniform.to(graph["weights"].dtype) < graph["weights"])[:, None]
    diff = emb[heads] - emb[tails]
    d2 = (diff * diff).sum(1)
    safe = torch.clamp_min(d2, 1e-12)
    coef = torch.where(d2 > 0, -2.0 * a * b * safe ** (b - 1.0) / (1.0 + a * safe ** b),
                       torch.zeros_like(d2))
    step = alpha * torch.where(accept, torch.clamp(coef[:, None] * diff, -GRAD_CLIP, GRAD_CLIP),
                               torch.zeros_like(diff))
    emb.index_add_(0, heads, step)
    emb.index_add_(0, tails, -step)
    if repulsion:
        diff = emb[heads][:, None, :] - emb[negatives.long()]
        d2 = (diff * diff).sum(-1)
        coef = 2.0 * b / ((REPULSION_EPS + d2) * (1.0 + a * d2 ** b))
        grad = torch.clamp(coef[..., None] * diff, -GRAD_CLIP, GRAD_CLIP)
        grad = torch.where(accept[:, :, None], grad, torch.zeros_like(grad))
        emb.index_add_(0, heads, alpha * grad.sum(1))
    return emb


def normalized_cv(emb: torch.Tensor) -> torch.Tensor:
    """The embedding centred on its range's midpoint and divided by its
    half-range (one where that is below 1e-12), in its dtype."""
    lo, hi = emb.min(0).values, emb.max(0).values
    half = (hi - lo) / 2
    return (emb - (hi + lo) / 2) / torch.where(half.abs() < 1e-12, torch.ones_like(half), half)


def fit(x: torch.Tensor, settings: dict, seed: int, p: Precision = FLOAT64,
        no_repulsion: bool = False, neighbours_short: int = 0, union: bool = True,
        epochs_share: float = 1.0) -> dict:
    """A whole fit of the normalized features `x` in p (the kNN's products
    in p's mode), what a check reads of the program: the kNN of every row,
    the graph, the start, the first 3 epochs' draws and embeddings, the
    last epoch's input and draws, the final embedding and its normalized
    CV, the epochs run. Draws come from a generator of `seed` on x's
    device. Faults, where asked: the layout without repulsion, k less
    `neighbours_short` neighbours, W in place of the union, a share of the
    epochs."""
    k = int(settings["n_neighbors"]) - neighbours_short
    n_epochs = int(round(int(settings["layout_epochs"]) * epochs_share))
    a, b = fit_ab(float(settings["min_dist"]))
    x = x.to(p.dtype)
    dists, idx = knn(x, k, p)
    w = membership(dists, *smooth_knn(dists, k))
    graph = fuzzy_union(idx, w, len(x), union)
    graph["weights"] = graph["weights"].to(p.dtype)
    init, _ = pca_init(x, int(settings["dimension"]), p)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    emb, early, last = init, [], {}
    n_edges, negative_samples = len(graph["heads"]), int(settings["negative_samples"])
    for epoch in range(n_epochs):
        uniform = torch.rand(n_edges, generator=gen, device=x.device, dtype=p.dtype)
        negatives = torch.randint(0, len(x), (n_edges, negative_samples), generator=gen,
                                  device=x.device)
        alpha = learning_rate(epoch, n_epochs, float(settings["learning_rate"]))
        if epoch == n_epochs - 1:
            last = {"input": emb, "uniform": uniform, "negatives": negatives}
        emb = layout_epoch(emb, graph, uniform, negatives, alpha, a, b, not no_repulsion)
        if epoch < EARLY_EPOCHS:
            early.append({"uniform": uniform, "negatives": negatives, "output": emb})
    return {"knn_dists": dists, "knn_idx": idx, **graph, "init": init, "early": early,
            "last": last, "embedding": emb, "cv": normalized_cv(emb), "epochs_run": n_epochs}
