"""TICA linear algebra: time-lagged covariances and the generalized eigh.

The port of the JAX package's cv/tica_math.py. The symmetric generalized
eigenproblem is solved by Cholesky whitening; eigenvectors are normalized
in the C0 metric (v^T C0 v = 1) with a deterministic sign (largest-magnitude
component positive). Every function takes a leading batch of problems, so
the seeded tries of a deep-TICA training solve theirs in one call.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deep_cartograph_torch.parallel.mesh import Mesh
from deep_cartograph_torch.parallel.sharding import sharded_covariances
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device

Array = Union[np.ndarray, torch.Tensor]


def create_timelagged_dataset(data: Array, lag_time: int = 1) -> Tuple[Array, Array]:
    """Pairs (x_t, x_{t+lag}) from a contiguous trajectory: N - lag pairs
    (mlcolvar trims two more boundary samples; the JAX package does not)."""
    if lag_time <= 0:
        raise ValueError("lag_time must be a positive integer")
    if data.shape[0] <= lag_time:
        raise ValueError(
            f"Need more than lag_time={lag_time} samples, got {data.shape[0]}"
        )
    return data[:-lag_time], data[lag_time:]


def create_timelagged_dataset_multi(
    blocks: Sequence[Array], lag_time: int = 1
) -> Tuple[Array, Array]:
    """Time-lagged pairs per contiguous block (no pairs across trajectory
    boundaries), concatenated. Blocks are numpy arrays or tensors."""
    xs: List[Array] = []
    ys: List[Array] = []
    for block in blocks:
        if block.shape[0] > lag_time:
            x, y = create_timelagged_dataset(block, lag_time)
            xs.append(x)
            ys.append(y)
    if not xs:
        raise ValueError("No block has more than lag_time samples")
    cat = torch.cat if isinstance(xs[0], torch.Tensor) else np.concatenate
    return cat(xs), cat(ys)


def timelagged_covariances(
    x_t: torch.Tensor, x_lag: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """C0, symmetrized Ctau and the removed mean: mlcolvar's estimator. The
    mean and C0 come from x_t only, x_lag is centered with x_t's mean, and
    only Ctau is symmetrized. `weights` (..., B), when given, weigh each
    pair (the padded rows of a ragged batch weigh 0)."""
    if weights is None:
        weights = torch.ones(x_t.shape[:-1], dtype=x_t.dtype, device=x_t.device)
    w = weights.unsqueeze(-1)
    wsum = weights.sum(-1).clamp_min(1e-12)[..., None, None]
    mu = (x_t * w).sum(-2, keepdim=True) / wsum
    a = x_t - mu
    b = x_lag - mu
    aw = (a * w).transpose(-1, -2)
    bw = (b * w).transpose(-1, -2)
    c0 = aw @ a / wsum
    ctau = 0.5 * (aw @ b + bw @ a) / wsum
    return c0, ctau, mu.squeeze(-2)


def _symmetrize(m: torch.Tensor) -> torch.Tensor:
    # jnp.linalg.cholesky and eigh symmetrize their input; torch's read one
    # triangle. Symmetrizing keeps values and gradients alike.
    return 0.5 * (m + m.transpose(-1, -2))


def generalized_eigh(
    a: torch.Tensor, b: torch.Tensor, reg: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve a v = w b v for symmetric a, SPD b (batched over leading
    dimensions) by Cholesky whitening. Returns the eigenvalues descending
    and the eigenvectors (columns) with v^T b v = 1."""
    dim = b.shape[-1]
    eye = torch.eye(dim, dtype=b.dtype, device=b.device)
    chol = torch.linalg.cholesky(_symmetrize(b + reg * eye))
    li = torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)
    a_white = li @ a @ li.transpose(-1, -2)
    w, u = torch.linalg.eigh(_symmetrize(a_white))
    w = w.flip(-1)
    u = u.flip(-1)
    return w, li.transpose(-1, -2) @ u


def _fix_sign(evecs: np.ndarray) -> np.ndarray:
    """Deterministic sign: the largest-magnitude component of each
    eigenvector is positive."""
    idx = np.argmax(np.abs(evecs), axis=0)
    signs = np.sign(evecs[idx, np.arange(evecs.shape[1])])
    signs[signs == 0] = 1.0
    return evecs * signs


def tica(
    x_t: Array,
    x_lag: Array,
    out_features: int,
    reg: float = 1e-6,
    remove_average: bool = True,
    device: DeviceLike = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """TICA eigenvalues (descending) and eigenvectors (features, out), as
    float32 numpy arrays. `device`: None means CUDA (raises without a
    card); "cpu" runs on the host. The covariances are summed from
    frame-sharded partials over `mesh` (`device` alone by default;
    `parallel.sharding.sharded_covariances`), then solved on its first
    device."""
    mesh = mesh or Mesh((resolve_device(device),))
    if remove_average:
        c0, ctau = sharded_covariances(x_t, x_lag, mesh)
    else:
        xt = torch.as_tensor(x_t).to(mesh.devices[0], torch.float32)
        xl = torch.as_tensor(x_lag).to(mesh.devices[0], torch.float32)
        n = xt.shape[0]
        c0 = xt.T @ xt / n
        ctau = 0.5 * (xt.T @ xl + xl.T @ xt) / n
    w, v = generalized_eigh(ctau, c0, reg)
    evals = w[:out_features].cpu().numpy()
    evecs = _fix_sign(v[:, :out_features].cpu().numpy())
    return evals, evecs


def split_subspaces(n_features: int, num_subspaces: int) -> List[np.ndarray]:
    """Column index blocks of the reference HTICA's torch.split: blocks of
    n // k columns, and a smaller trailing block when k does not divide n."""
    split_size = n_features // num_subspaces
    if split_size == 0:
        raise ValueError(
            f"Number of subspaces {num_subspaces} is larger than number of "
            f"features {n_features}."
        )
    return [np.arange(start, min(start + split_size, n_features))
            for start in range(0, n_features, split_size)]
