"""UMAP collective-variable calculator in PyTorch.

The port of the JAX package's cv/umap_cv.py, which replaces the reference's
umap-learn dependency (deep_cartograph/modules/cv_learning/cv_calculator.py:
1923-2171) with an implementation on the device: exact kNN by the float32
d2 expansion, the fuzzy simplicial set (per-point rho and sigma by
bisection), the symmetrized graph (scipy.sparse, on the host), PCA
initialization, and the SGD layout with negative sampling. transform()
embeds new points by attracting them to their training-set neighbours.
Like the reference, UMAP has no PLUMED export and no fused serving path
(`deploy.FramesToCV` refuses it).

Differences, on purpose:

- The kNN works in tiles of query rows and of data columns, keeping a
  running top-k, where the JAX package forms the whole (queries x n) d2
  matrix (40 GB at 100,000 frames). Each candidate is ranked by (d2, column)
  through one int64 key, so ties go to the lower index whatever the tiles.
- The layout's edge acceptance and negative samples come from a torch
  generator seeded with `seed` on the device, so a fit matches the JAX
  package only in distribution; `draws` passes given draws in instead.
- On CUDA, `index_add_` sums the updates of one row in no fixed order.

Each fit runs in a span `umap.fit` holding one span a part (`umap.knn`,
`umap.sigma`, `umap.symmetrize`, `umap.pca_init`, `umap.layout`);
`transform` runs in `umap.transform`. `UMAP_STATS` counts the work, one
update a part.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from deep_cartograph_torch.cv.base import CVCalculator, cv_names_map
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device
from deep_cartograph_torch.utils.profiling import annotate

logger = logging.getLogger(__name__)

# Elements of one kNN tile of d2 (and of its int64 keys).
_KNN_TILE_ELEMENTS = 1 << 26

# draws(epoch, n_edges) -> (uniform (n_edges,), negatives (n_edges, negative_samples))
Draws = Callable[[int, int], Tuple[object, object]]


@dataclass
class UMAPStats:
    """Counters of UMAP's work: the `fits`, the kNN's `knn_tiles` and the
    `knn_candidates` (query, data row) pairs their d2 scored (a fit's and
    `transform`'s), the symmetrized graph's `edges`, the layout `epochs`
    run and the embedding rows left not finite by a fit
    (`nonfinite_rows`). Each part adds its counts once, never once an epoch
    or a tile. Callers reset them (`reset()`) around a region they
    measure; the counts are taken under a lock."""

    fits: int = 0
    knn_tiles: int = 0
    knn_candidates: int = 0
    edges: int = 0
    epochs: int = 0
    nonfinite_rows: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def add(self, **counts: int) -> None:
        with self._lock:
            for name, n in counts.items():
                setattr(self, name, getattr(self, name) + int(n))

    def reset(self) -> None:
        with self._lock:
            self.fits = self.knn_tiles = self.knn_candidates = 0
            self.edges = self.epochs = self.nonfinite_rows = 0


UMAP_STATS = UMAPStats()


def _f32(x: float) -> float:
    """A Python float rounded to float32, as a weakly typed scalar is."""
    return float(np.float32(x))


def _sortable_keys(d2: torch.Tensor, col0: int) -> torch.Tensor:
    """int64 keys that order a tile's entries by (d2, global column): the
    float32 bits made monotone in the high word, the column in the low."""
    bits = d2.contiguous().view(torch.int32).to(torch.int64)
    mono = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    cols = torch.arange(col0, col0 + d2.shape[1], device=d2.device, dtype=torch.int64)
    return (mono << 32) | cols


def _key_d2(keys: torch.Tensor) -> torch.Tensor:
    """The float32 d2 of `_sortable_keys` keys."""
    mono = keys >> 32
    bits = torch.where(mono < 0, mono ^ 0x7FFFFFFF, mono)
    return bits.to(torch.int32).view(torch.float32)


def _knn(
    data: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    exclude_self: bool,
    row_block: Optional[int] = None,
    col_block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN by the d2 expansion |q|^2 - 2 q.x + |x|^2 (float32), in
    tiles of `row_block` queries x `col_block` data rows (by default the
    whole width, and as many rows as keep a tile within
    `_KNN_TILE_ELEMENTS`). Returns (distances, indices), each (queries, k),
    nearest first; ties go to the lower index. `exclude_self`: the queries
    are the data, and a point is not its own neighbour."""
    n, nq = data.shape[0], queries.shape[0]
    col_block = col_block or max(n, 1)
    row_block = row_block or max(1, _KNN_TILE_ELEMENTS // col_block)
    sq_q = torch.sum(queries ** 2, 1)
    sq_x = torch.sum(data ** 2, 1)
    dists, idx = [], []
    for r0 in range(0, nq, row_block):
        q = queries[r0:r0 + row_block]
        best = None
        for c0 in range(0, n, col_block):
            x = data[c0:c0 + col_block]
            d2 = sq_q[r0:r0 + row_block, None] - 2 * q @ x.T + sq_x[None, c0:c0 + col_block]
            if exclude_self:
                d2.diagonal(offset=r0 - c0).fill_(float("inf"))
            keys = _sortable_keys(d2, c0)
            if best is not None:
                keys = torch.cat([best, keys], dim=1)
            best = torch.topk(keys, min(k, keys.shape[1]), dim=1, largest=False).values
        dists.append(torch.sqrt(torch.clamp_min(_key_d2(best), 0.0)))
        idx.append(best & 0xFFFFFFFF)
    UMAP_STATS.add(knn_tiles=-(-nq // row_block) * -(-n // col_block), knn_candidates=nq * n)
    return torch.cat(dists), torch.cat(idx)


def _smooth_knn(dists: torch.Tensor, n_iter: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point (rho, sigma): rho = nearest distance; sigma solves
    sum_j exp(-(d_ij - rho)/sigma) = log2(k), by bisection on [1e-8, 1e4]."""
    k = dists.shape[1]
    rho = dists[:, 0]
    target = _f32(np.log2(np.float32(k)))
    excess = torch.clamp_min(dists - rho[:, None], 0.0)
    lo = torch.full_like(rho, 1e-8)
    hi = torch.full_like(rho, 1e4)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        too_big = torch.sum(torch.exp(-excess / mid[:, None]), dim=1) > target
        lo, hi = torch.where(too_big, lo, mid), torch.where(too_big, mid, hi)
    return rho, 0.5 * (lo + hi)


def _fuzzy_weights(dists, rho, sigma):
    return torch.exp(-torch.clamp_min(dists - rho[:, None], 0.0) / sigma[:, None])


def _fit_ab(min_dist: float, spread: float = 1.0) -> Tuple[float, float]:
    """Fit the (a, b) curve parameters to the min_dist/spread target, as
    umap-learn does (least squares on 1/(1+a x^{2b}))."""
    from scipy.optimize import curve_fit

    x = np.linspace(0, spread * 3, 300)
    y = np.where(
        x < min_dist, 1.0, np.exp(-(x - min_dist) / spread)
    )

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    (a, b), _ = curve_fit(curve, x, y, p0=(1.0, 1.0), maxfev=5000)
    return float(a), float(b)


def _symmetrize(idx: np.ndarray, w: np.ndarray, n: int):
    """The fuzzy union W + W^T - W o W^T of the kNN graph, on the host with
    scipy.sparse: (heads, tails, weights) in the order of `tocoo()`, which
    fixes which draw goes with which edge."""
    import scipy.sparse as sp

    rows = np.repeat(np.arange(n), idx.shape[1])
    W = sp.coo_matrix((w.reshape(-1), (rows, idx.reshape(-1))), shape=(n, n))
    Wt = W.T
    sym = (W + Wt - W.multiply(Wt)).tocoo()
    return sym.row.astype(np.int64), sym.col.astype(np.int64), sym.data.astype(np.float32)


def _pca_init(x: torch.Tensor, n_components: int) -> torch.Tensor:
    """The leading principal components (eigh, no sign rule), each scaled to
    a standard deviation of 10."""
    xc = x - torch.mean(x, dim=0)
    cov = xc.T @ xc / x.shape[0]
    _, evecs = torch.linalg.eigh(cov)
    init = xc @ evecs.flip(1)[:, :n_components]
    return 10.0 * init / (torch.std(init, dim=0, correction=0) + 1e-8)


def _attraction_coef(d2: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """umap-learn's attraction coefficient -2ab d2^(b-1) / (1 + a d2^b) of
    squared distances d2; zero for coincident points (duplicate frames are
    each other's nearest neighbours), umap-learn's `dist_squared > 0` guard,
    which otherwise becomes 0**(b-1) = inf."""
    safe_d2 = torch.clamp_min(d2, 1e-12)
    coef = (_f32(-2.0 * a * b) * safe_d2 ** _f32(b - 1.0)) / (
        1.0 + _f32(a) * safe_d2 ** _f32(b))
    return torch.where(d2 > 0.0, coef, 0.0)


def layout_epoch(
    emb: torch.Tensor,
    heads: torch.Tensor,
    tails: torch.Tensor,
    weights: torch.Tensor,
    uniform: torch.Tensor,
    negatives: torch.Tensor,
    alpha: float,
    a: float,
    b: float,
) -> torch.Tensor:
    """One epoch of the layout, in place on `emb` (returned): the edges
    whose draw is below their weight attract head and tail (added at the
    heads, then subtracted at the tails); then each accepted head is pushed
    from its negative samples, read from the updated embedding."""
    accept = uniform < weights
    diff = emb[heads] - emb[tails]
    d2 = torch.sum(diff * diff, dim=1)
    grad = torch.clamp(_attraction_coef(d2, a, b)[:, None] * diff, -4.0, 4.0)
    step = alpha * torch.where(accept[:, None], grad, 0.0)
    emb.index_add_(0, heads, step)
    emb.index_add_(0, tails, -step)
    n_edges, neg = negatives.shape
    diffr = emb[heads][:, None, :] - emb[negatives.reshape(-1)].reshape(n_edges, neg, -1)
    d2r = torch.sum(diffr * diffr, dim=-1)
    rep_coef = _f32(2.0 * b) / ((_f32(0.001) + d2r) * (1.0 + _f32(a) * d2r ** _f32(b)))
    gradr = torch.clamp(rep_coef[..., None] * diffr, -4.0, 4.0)
    gradr = torch.where(accept[:, None, None], gradr, 0.0)
    emb.index_add_(0, heads, alpha * torch.sum(gradr, dim=1))
    return emb


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class UMAPModel:
    """Fitted UMAP state: training data, embedding, graph parameters."""

    def __init__(
        self,
        n_components: int,
        n_neighbors: int = 15,
        min_dist: float = 0.1,
        n_epochs: int = 300,
        learning_rate: float = 1.0,
        negative_samples: int = 5,
        seed: int = 42,
        device: DeviceLike = None,
    ):
        """`device`: None means CUDA (raises without a card); "cpu" runs on
        the host."""
        self.device = resolve_device(device)
        self.n_components = n_components
        self.n_neighbors = n_neighbors
        self.min_dist = min_dist
        self.n_epochs = n_epochs
        self.learning_rate = learning_rate
        self.negative_samples = negative_samples
        self.seed = seed
        self.a, self.b = _fit_ab(min_dist)
        self.training_data: Optional[np.ndarray] = None
        self.embedding_: Optional[np.ndarray] = None
        # the last fit's symmetrized graph: (heads, tails, weights)
        self.graph_: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        # host seconds of each part of the last fit, the device drained at
        # each boundary
        self.fit_seconds: Dict[str, float] = {}
        self._on_device = None  # ((training_data, embedding_), their tensors)

    def _device_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training data and embedding on the device, uploaded once per
        fitted (or loaded) state."""
        src = (self.training_data, self.embedding_)
        if self._on_device is None or any(
                a is not b for a, b in zip(self._on_device[0], src)):
            tensors = tuple(torch.tensor(np.asarray(v, np.float32), device=self.device)
                            for v in src)
            self._on_device = (src, tensors)
        return self._on_device[1]

    def _timed(self, name: str, fn):
        """fn() in the span `umap.<name>`, its host seconds in
        `fit_seconds[name]`, the device drained at its end."""
        with annotate(f"umap.{name}"):
            t0 = time.perf_counter()
            out = fn()
            _sync(self.device)
            self.fit_seconds[name] = time.perf_counter() - t0
        return out

    @annotate("umap.fit")
    def fit(self, data, draws: Optional[Draws] = None) -> "UMAPModel":
        """Fit on (n, d) data (numpy, or a tensor). `draws(epoch, n_edges)`:
        the layout's uniform draws and negative samples of each epoch, in
        place of the seeded generator's."""
        x = torch.as_tensor(data).to(self.device, torch.float32)
        self.training_data = x.cpu().numpy()
        n = x.shape[0]
        k = min(self.n_neighbors, n - 1)
        self.fit_seconds = {}
        dists, idx = self._timed("knn", lambda: _knn(x, x, k, exclude_self=True))
        w = self._timed("sigma", lambda: _fuzzy_weights(dists, *_smooth_knn(dists)))
        self.graph_ = self._timed(
            "symmetrize", lambda: _symmetrize(idx.cpu().numpy(), w.cpu().numpy(), n))
        init = self._timed("pca_init", lambda: _pca_init(x, self.n_components))
        embedding = self._timed("layout", lambda: self.layout(init, *self.graph_, draws))
        self.embedding_ = embedding.cpu().numpy()
        self._on_device = ((self.training_data, self.embedding_), (x, embedding))
        UMAP_STATS.add(fits=1, edges=len(self.graph_[0]), nonfinite_rows=int(
            np.sum(~np.isfinite(self.embedding_).all(axis=1))))
        return self

    def layout(self, embedding: torch.Tensor, heads, tails, weights,
               draws: Optional[Draws] = None) -> torch.Tensor:
        """`n_epochs` layout epochs from `embedding` over the symmetrized
        graph; no host sync inside the loop with the seeded generator."""
        dev = self.device
        emb = embedding.to(dev, torch.float32).clone()
        heads, tails = (torch.as_tensor(v, device=dev).long() for v in (heads, tails))
        weights = torch.as_tensor(weights, device=dev, dtype=torch.float32)
        n, n_edges = emb.shape[0], heads.shape[0]
        if draws is None:
            gen = torch.Generator(device=dev).manual_seed(self.seed)

            def draws(epoch, n_edges):
                return (torch.rand(n_edges, generator=gen, device=dev),
                        torch.randint(0, n, (n_edges, self.negative_samples),
                                      generator=gen, device=dev))

        lr, n_epochs = np.float32(self.learning_rate), np.float32(self.n_epochs)
        for ep in range(self.n_epochs):
            alpha = float(lr * (np.float32(1.0) - np.float32(ep) / n_epochs))
            uniform, negatives = draws(ep, n_edges)
            layout_epoch(emb, heads, tails, weights,
                         torch.as_tensor(uniform, device=dev, dtype=torch.float32),
                         torch.as_tensor(negatives, device=dev).long(),
                         alpha, self.a, self.b)
        UMAP_STATS.add(epochs=self.n_epochs)
        return emb

    @annotate("umap.transform")
    def transform(self, new_data, n_epochs: int = 50) -> np.ndarray:
        """Embed new points: init at the fuzzy-weighted mean of their
        training neighbours' embeddings, then locally optimize attraction."""
        x = torch.as_tensor(new_data).to(self.device, torch.float32)
        train, emb_train = self._device_state()
        k = min(self.n_neighbors, train.shape[0])
        dists, idx = _knn(train, x, k, exclude_self=False)
        w = _fuzzy_weights(dists, *_smooth_knn(dists))
        w = w / torch.clamp_min(torch.sum(w, dim=1, keepdim=True), 1e-12)
        neighbours = emb_train[idx]  # (q, k, d)
        emb = torch.einsum("qk,qkd->qd", w, neighbours)
        rate = np.float32(self.learning_rate * 0.3)
        for ep in range(n_epochs):
            alpha = float(rate * (np.float32(1.0) - np.float32(ep) / np.float32(n_epochs)))
            diff = emb[:, None, :] - neighbours
            coef = _attraction_coef(torch.sum(diff * diff, dim=-1), self.a, self.b)
            grad = torch.clamp((w * coef)[..., None] * diff, -4.0, 4.0)
            emb = emb + alpha * torch.sum(grad, dim=1)
        return emb.cpu().numpy()


class UMAP(CVCalculator):
    """UMAP CV calculator (cf. reference cv_calculator.py:1923-2171)."""

    def __init__(self, configuration=None, output_path=None, device: DeviceLike = None):
        super().__init__(configuration, output_path, device)
        self.cv_name = "umap"
        self.n_neighbors = self.configuration.get("n_neighbors", 15)
        self.min_dist = self.configuration.get("min_dist", 0.1)
        self.metric = self.configuration.get("metric", "euclidean")
        self.seed: int = self.configuration.get("seed", 42)
        # the layout's draws in place of the seeded generator's (UMAPModel.fit)
        self.layout_draws: Optional[Draws] = None
        self.cv_stats: Dict = {}
        self.cv_norm_mean = None
        self.cv_norm_range = None
        if self.metric != "euclidean":
            logger.warning(
                "Only the euclidean metric is supported on device; got %s.",
                self.metric,
            )
        logger.info("Creating %s Calculator ...", cv_names_map[self.cv_name])

    def _normalized(self, data) -> torch.Tensor:
        """The features normalized in float64, rounded to float32 (numpy's
        promotion of float32 data against the float64 arrays)."""
        x = torch.as_tensor(data).to(self.device, torch.float32)
        if self.features_norm_mean is None:
            return x
        mean, rng = (torch.as_tensor(np.asarray(v, np.float64), device=self.device)
                     for v in (self.features_norm_mean, self.features_norm_range))
        return ((x.double() - mean) / rng).float()

    def compute_cv(self) -> None:
        if self.training_data is None:
            logger.error("No training data available to compute UMAP.")
            return
        model = UMAPModel(
            n_components=self.cv_dimension,
            n_neighbors=self.n_neighbors,
            min_dist=self.min_dist,
            seed=self.seed,
            device=self.device,
        )
        # Fit on normalized features so fit and transform see the same space
        # (fixes the raw-fit / normalized-transform inconsistency present in
        # the reference UMAP calculator, cv_calculator.py:1952-1970 vs
        # :2099-2160).
        self.cv = model.fit(self._normalized(self.training_data), self.layout_draws)

    def normalize_cv(self) -> None:
        emb = self.cv.embedding_
        self.cv_stats = {"min": emb.min(axis=0), "max": emb.max(axis=0)}
        self.cv_norm_mean = (self.cv_stats["max"] + self.cv_stats["min"]) / 2
        self.cv_norm_range = (self.cv_stats["max"] - self.cv_stats["min"]) / 2
        # degenerate-range clamp (same contract as the other calculators)
        self.cv_norm_range = np.where(
            np.abs(self.cv_norm_range) < 1e-12, 1.0, self.cv_norm_range
        )

    def project_data(self, data, normalize_data: bool = True) -> np.ndarray:
        if self.cv is None:
            raise ValueError("No UMAP model to project data.")
        x = self._normalized(data) if normalize_data else \
            torch.as_tensor(data).to(self.device, torch.float32)
        projected = self.cv.transform(x)
        return (projected - self.cv_norm_mean) / self.cv_norm_range

    def run(self, cv_dimension=None):
        """UMAP embeds the training data itself: the projection of the
        training data is its normalized `embedding_`, not a transform."""
        if self.training_data is None:
            logger.error("Training data not loaded. Cannot compute CV.")
            return None
        self.create_output_folders()
        if cv_dimension:
            self.cv_dimension = cv_dimension
        self.compute_cv()
        self.set_labels()
        if self.cv is None:
            return None
        self.normalize_cv()
        projected = (self.cv.embedding_ - self.cv_norm_mean) / self.cv_norm_range
        self.save_model()
        self.sensitivity_analysis()
        return np.asarray(projected, np.float32), list(self.cv_labels)

    def save_weights(self, weights_path: str) -> None:
        np.savez_compressed(
            weights_path,
            training_data=self.cv.training_data,
            embedding=self.cv.embedding_,
            a=self.cv.a,
            b=self.cv.b,
        )

    def save_model(self) -> None:
        super().save_model()
        m = str(self.model_output_folder)
        if self.cv is None:
            raise ValueError("No UMAP model to save.")
        self.save_weights(os.path.join(m, "umap_model.npz"))
        with open(os.path.join(m, "umap_params.json"), "w") as fh:
            json.dump(
                {
                    "n_neighbors": self.n_neighbors,
                    "min_dist": self.min_dist,
                    "n_components": self.cv_dimension,
                    "seed": self.seed,
                },
                fh,
            )
        np.save(os.path.join(m, "cv_norm_mean.npy"), self.cv_norm_mean)
        np.save(os.path.join(m, "cv_norm_range.npy"), self.cv_norm_range)
        if self.features_norm_mean is not None:
            np.save(os.path.join(m, "features_norm_mean.npy"), self.features_norm_mean)
            np.save(
                os.path.join(m, "features_norm_range.npy"), self.features_norm_range
            )
        self._zip_and_clean_model()

    def _load_from_folder(self, folder_path: str) -> None:
        super()._load_from_folder(folder_path)
        m = str(self.model_output_folder)
        with open(os.path.join(m, "umap_params.json")) as fh:
            params = json.load(fh)
        data = np.load(os.path.join(m, "umap_model.npz"))
        model = UMAPModel(
            n_components=params["n_components"],
            n_neighbors=params["n_neighbors"],
            min_dist=params["min_dist"],
            seed=params["seed"],
            device=self.device,
        )
        model.training_data = data["training_data"]
        model.embedding_ = data["embedding"]
        model.a, model.b = float(data["a"]), float(data["b"])
        self.cv = model
        self.cv_norm_mean = np.load(os.path.join(m, "cv_norm_mean.npy"))
        self.cv_norm_range = np.load(os.path.join(m, "cv_norm_range.npy"))
        fm = os.path.join(m, "features_norm_mean.npy")
        if os.path.exists(fm):
            self.features_norm_mean = np.load(fm)
            self.features_norm_range = np.load(
                os.path.join(m, "features_norm_range.npy")
            )

    def get_cv_parameters(self) -> Dict:
        return {
            "cv_name": self.cv_name,
            "cv_dimension": self.cv_dimension,
            "n_neighbors": self.n_neighbors,
            "min_dist": self.min_dist,
            "metric": self.metric,
        }

    def get_cv_type(self) -> str:
        return "umap"

    def sensitivity_analysis(self) -> None:
        logger.warning("Sensitivity analysis is not implemented for UMAP models.")

    def write_plumed_files(self, topology, output_folder, waypoint_structures=None):
        logger.warning(
            "PLUMED input files are not generated for UMAP as it is not "
            "supported in PLUMED."
        )
