"""Streaming hierarchical TICA for feature matrices too large for memory
(PyTorch).

The port of the JAX package's cv/htica_stream.py. HTICA over a block
iterator of frames:

  pass 1: per-subspace raw moments (sums, second moments of x_t and x_lag)
          block by block, one batched product over (S, block, D) each; a
          lag-frame carry keeps the pairs that straddle block boundaries.
  level 1: per-subspace generalized eigensolves, batched.
  pass 2: the blocks again, projected through the level-1 transform, give
          the level-2 time-lagged covariances; level 2 is solved there.

The estimator is cv/tica_math.timelagged_covariances' (mean and C0 from
x_t only, Ctau symmetrized), so results agree with the in-memory HTICA on
data that fits. Blocks may be host arrays or device tensors; the moments
accumulate on the device, in float64 (the JAX package's are float32), and
the covariances are rounded to float32 for the solvers. On an H100, float32
batched products over a 20,000-frame block came out 2.4e-6 relative off
float64, and level-1 subspaces whose last kept eigenvalue nearly ties the
next one turned that into a 2e-2 change of the HTICA projection
(chip_smoke.py, phase 4).

Eigensolves: subspaces of at most 256 dimensions go through the batched
Cholesky-whitened `eigh` on the device. Larger ones take the top pairs
only, by an on-device block-Krylov projection with a tiny dense solve on
the host (default when 8 * dim <= D), or by LAPACK's generalized subset
routine on the host over the packed covariance triangles.
DC_HTICA_SOLVER=auto|device|host picks the route; another value raises.

`fit_fused` and `fit_chunked` take a block generator `block_fn(start,
*block_args)` that evaluates a block on the device from a start index held
in a 0-dim device tensor (device-resident features, or coordinates
featurized through K1). On the card, the body of one pass (`fit_fused`) or
of `blocks_per_dispatch` blocks (`fit_chunked`) is captured once as a CUDA
graph and replayed with the start index rewritten in place; on the CPU the
same body runs eagerly. Both capture on one device and take no mesh, as
in the JAX package.

`fit` shards the subspace axis over its `mesh` (`parallel.mesh.Mesh`;
the device alone without one): each block's contiguous feature slice,
which holds whole subspaces, goes to its device, and each device's worker
(`parallel.mesh.run_per_device`) accumulates its own subspaces' moments
and solves their level-1 problems with no communication. Only the
level-2 projected blocks are gathered, on the mesh's first device.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from deep_cartograph_torch.cv.tica_math import generalized_eigh
from deep_cartograph_torch.parallel.mesh import Mesh, run_per_device
from deep_cartograph_torch.parallel.sharding import all_gather
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

_EIGH_HOST_DIM_THRESHOLD = 256
SOLVERS = ("auto", "device", "host")


def _zero_state(n_sub: int, sub_d: int, device) -> dict:
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float64, device=device)

    return {"n": 0, "s1": zeros(n_sub, sub_d), "s1l": zeros(n_sub, sub_d),
            "s0": zeros(n_sub, sub_d, sub_d), "st": zeros(n_sub, sub_d, sub_d)}


def _accumulate_moments(state: dict, x_t: torch.Tensor, x_lag: torch.Tensor,
                        n_sub: int, sub_d: int, shift=None) -> dict:
    """Add one block of time-lagged pairs (b, n_sub * sub_d) to the
    per-subspace raw moments, in float64, after subtracting `shift`."""
    x_t, x_lag = x_t.double(), x_lag.double()
    if shift is not None:
        x_t = x_t - shift
        x_lag = x_lag - shift
    _add_pair_moments(state, x_t, x_lag, n_sub, sub_d)
    return state


def _add_pair_moments(state: dict, x_t: torch.Tensor, x_lag: torch.Tensor,
                      n_sub: int, sub_d: int, weight=None) -> None:
    """Add the raw moments of one group of float64 time-lagged pairs to
    `state` in place, each times `weight` (a 0-dim tensor) if given; no
    host sync, so a CUDA graph can capture it."""
    b = x_t.shape[0]
    xt = x_t.reshape(b, n_sub, sub_d).transpose(0, 1)   # (S, b, D)
    xl = x_lag.reshape(b, n_sub, sub_d).transpose(0, 1)
    cross = xt.transpose(1, 2) @ xl                      # (S, D, D)
    terms = {"n": b, "s1": xt.sum(1), "s1l": xl.sum(1), "s0": xt.transpose(1, 2) @ xt,
             "st": 0.5 * (cross + cross.transpose(1, 2))}
    for key, term in terms.items():
        state[key] += term if weight is None else weight * term


def _moments_to_covs(state: dict):
    """Per-subspace (C0, Ctau, mean) from the raw moments: with mu the
    mean of x_t and mul that of x_lag, C0 = S0/n - mu mu^T and
    Ctau = St/n - (mu mul^T + mul mu^T)/2; computed in float64, returned
    in float32."""
    n = max(state["n"], 1)
    mu = state["s1"] / n
    mul = state["s1l"] / n
    c0 = state["s0"] / n - mu[:, :, None] * mu[:, None, :]
    cross = 0.5 * (mu[:, :, None] * mul[:, None, :] + mul[:, :, None] * mu[:, None, :])
    return c0.float(), (state["st"] / n - cross).float(), mu.float()


def _batched_tica(c0: torch.Tensor, ctau: torch.Tensor, reg: float, dim: int):
    """(S, D, D) pairs -> (S, dim) eigenvalues (descending), (S, D, dim)
    eigenvectors, by the batched Cholesky-whitened eigh."""
    w, v = generalized_eigh(ctau, c0, reg)
    return w[:, :dim], v[:, :, :dim]


def _scipy_batched_tica_packed(packed: np.ndarray, d: int, reg: float, dim: int):
    """Host LAPACK top-k generalized eigensolve from packed lower
    triangles: descending eigenvalues, eigenvectors with
    v^T (C0 + reg I) v = 1 (LAPACK's sygvx normalization, the whitening's
    too). sygvx with uplo='L' reads only the lower triangles."""
    import scipy.linalg as sla

    n_sub = packed.shape[0]
    k = min(dim, d)
    rows, cols = np.tril_indices(d)
    diag = np.arange(d)
    a = np.zeros((d, d), packed.dtype)
    b = np.zeros((d, d), packed.dtype)
    ws = np.empty((n_sub, k), packed.dtype)
    vs = np.empty((n_sub, d, k), packed.dtype)
    for s in range(n_sub):
        a[rows, cols] = packed[s, 1]  # ctau
        b[rows, cols] = packed[s, 0]  # c0
        b[diag, diag] += reg
        w, v = sla.eigh(a, b, lower=True, subset_by_index=[d - k, d - 1],
                        check_finite=False)
        ws[s] = w[::-1]
        vs[s] = v[:, ::-1]
    return ws, vs


def host_topk_eigh(cov: np.ndarray, k: int):
    """Top-k eigenpairs of one symmetric matrix on the host through
    LAPACK's subset routine (syevr): (w ascending, v) as scipy returns
    them."""
    import scipy.linalg as sla

    d = cov.shape[-1]
    k = min(k, d)
    return sla.eigh(np.asarray(cov), subset_by_index=[d - k, d - 1], check_finite=False)


def _host_tica(c0: torch.Tensor, ctau: torch.Tensor, reg: float, dim: int):
    """Pull the packed lower triangles group by group and solve each group
    on the host with LAPACK."""
    d = c0.shape[-1]
    n_sub, k = c0.shape[0], min(dim, d)
    rows, cols = (torch.as_tensor(i, device=c0.device) for i in np.tril_indices(d))
    packed = torch.stack([c0[:, rows, cols], ctau[:, rows, cols]], dim=1)  # (S, 2, T)
    ws = np.empty((n_sub, k), np.float32)
    vs = np.empty((n_sub, d, k), np.float32)
    group = max(1, -(-n_sub // 8))
    t0 = time.perf_counter()
    for g in range(0, n_sub, group):
        w_g, v_g = _scipy_batched_tica_packed(packed[g:g + group].cpu().numpy(),
                                              d, reg, dim)
        ws[g:g + group] = w_g
        vs[g:g + group] = v_g
    logger.info("batched TICA solve (host top-%d of %d x %dx%d): %.2fs",
                k, n_sub, d, d, time.perf_counter() - t0)
    return ws, vs


def _krylov_shape(d: int, dim: int):
    """Block width and depth of the Krylov basis. The basis never has more
    columns than d: a wider one spans the whole space plus dependent
    columns, which can give spurious Ritz values (the JAX package's
    q = blk * m may pass d when d/16 <= dim <= d/8)."""
    blk = max(dim + 3, 8)
    q_cols = min(d, max(16 * dim, 128))
    m = min(max(2, -(-q_cols // blk)), d // blk)
    return blk, m


def _krylov_project(c0: torch.Tensor, ctau: torch.Tensor, reg: float, blk: int, m: int):
    """Project (Ctau, C0 + reg I) onto a block-Krylov subspace of the
    whitened operator M = L^{-1} Ctau L^{-T} (L = chol(C0 + reg I)), so
    that the host solves only a (q x q) problem, q = blk * m. Returns H =
    Q^T M Q, G = Q^T Q, Q and L. Each new block is Gram-Schmidt
    orthogonalized against the basis twice and Cholesky-QR normalized, for
    conditioning only: the host solves H u = w G u in its own metric."""
    s, d = c0.shape[0], c0.shape[-1]
    eye = torch.eye(d, dtype=c0.dtype, device=c0.device)
    ell = torch.linalg.cholesky(c0 + reg * eye)
    y = torch.linalg.solve_triangular(ell, ctau, upper=False)
    mw = torch.linalg.solve_triangular(ell, y.transpose(-1, -2), upper=False)
    mw = 0.5 * (mw + mw.transpose(-1, -2))

    def chol_qr(w):
        g = w.transpose(-1, -2) @ w
        g = g + 1e-6 * torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)[:, None, None] \
            * torch.eye(blk, dtype=w.dtype, device=w.device) / blk
        r = torch.linalg.cholesky(g)
        return torch.linalg.solve_triangular(r.transpose(-1, -2), w, upper=True,
                                             left=False)

    # a fixed start drawn on the host, so every device starts alike
    gen = torch.Generator().manual_seed(0)
    z0 = torch.randn((s, d, blk), generator=gen, dtype=c0.dtype).to(c0.device)
    basis = torch.zeros((s, d, blk * m), dtype=c0.dtype, device=c0.device)
    prev = chol_qr(z0)
    basis[:, :, :blk] = prev
    for j in range(1, m):
        w = mw @ prev
        filled = basis[:, :, : j * blk]
        for _ in range(2):
            w = w - filled @ (filled.transpose(-1, -2) @ w)
        prev = chol_qr(w)
        basis[:, :, j * blk:(j + 1) * blk] = prev
    h = basis.transpose(-1, -2) @ (mw @ basis)
    g = basis.transpose(-1, -2) @ basis
    return (0.5 * (h + h.transpose(-1, -2)), 0.5 * (g + g.transpose(-1, -2)),
            basis, ell)


def _device_krylov_tica(c0: torch.Tensor, ctau: torch.Tensor, reg: float, dim: int):
    """Top-`dim` generalized eigenpairs of (Ctau, C0 + reg I), the heavy
    work on the device and O(q^2) numbers copied to the host."""
    import scipy.linalg as sla

    d = int(c0.shape[-1])
    blk, m = _krylov_shape(d, dim)
    if m < 2:
        raise ValueError(f"A {d}-dimensional subspace is too small for a Krylov "
                         f"basis of width {blk}; use DC_HTICA_SOLVER=host.")
    t0 = time.perf_counter()
    h, g, basis, ell = _krylov_project(c0, ctau, reg, blk, m)
    h_h = h.cpu().double().numpy()
    g_h = g.cpu().double().numpy()
    n_sub, q = h_h.shape[0], h_h.shape[-1]
    ws = np.empty((n_sub, dim), np.float32)
    us = np.empty((n_sub, q, dim), np.float32)
    ridge = 1e-10 * np.eye(q)
    for s in range(n_sub):
        # a ridge: a Krylov space that saturated early leaves G near-singular
        w, v = sla.eigh(h_h[s], g_h[s] + np.trace(g_h[s]) * ridge, check_finite=False)
        ws[s] = w[-dim:][::-1]
        us[s] = v[:, -dim:][:, ::-1]
    qu = basis @ torch.as_tensor(us, device=basis.device)
    vs = torch.linalg.solve_triangular(ell.transpose(-1, -2), qu, upper=True)
    logger.info("batched TICA solve (device Krylov top-%d of %d x %dx%d, q=%d): %.2fs",
                dim, n_sub, d, d, q, time.perf_counter() - t0)
    return ws, vs.cpu().numpy()


def _run_batched_tica(c0: torch.Tensor, ctau: torch.Tensor, reg: float, dim: int):
    """Top-`dim` eigenpairs of each subspace, by the route its size calls
    for. Returns (S, dim) eigenvalues and (S, D, dim) eigenvectors."""
    solver = os.environ.get("DC_HTICA_SOLVER", "auto")
    if solver not in SOLVERS:
        raise ValueError(f"DC_HTICA_SOLVER={solver!r}; expected one of {SOLVERS}")
    d = c0.shape[-1]
    if d <= _EIGH_HOST_DIM_THRESHOLD:
        w, v = _batched_tica(c0, ctau, reg, dim)
        return w.cpu().numpy(), v.cpu().numpy()
    if solver == "device" or (solver == "auto" and 8 * dim <= d):
        return _device_krylov_tica(c0, ctau, reg, dim)
    return _host_tica(c0, ctau, reg, dim)


class StreamingHTICA:
    """Two-pass streaming HTICA over a restartable block iterator."""

    def __init__(
        self,
        n_features: int,
        num_subspaces: int,
        subspaces_dimension: int,
        cv_dimension: int,
        lag_time: int,
        reg: float = 1e-6,
        device: DeviceLike = None,
        mesh: Optional[Mesh] = None,
    ):
        """`device`: None means CUDA (raises without a card); "cpu" runs on
        the host. `mesh`: shard the subspaces of `fit` over its devices
        instead (the subspace count must divide over them); the results
        come to its first device."""
        if n_features % num_subspaces != 0:
            raise ValueError(
                f"n_features ({n_features}) must divide evenly into "
                f"{num_subspaces} subspaces for the streaming path."
            )
        if lag_time < 1:
            raise ValueError(f"lag_time must be a positive integer, got {lag_time}.")
        self.mesh = mesh or Mesh((resolve_device(device),))
        self.device = self.mesh.devices[0]
        if num_subspaces % len(self.mesh):
            raise ValueError(
                f"num_subspaces ({num_subspaces}) must divide evenly over the "
                f"{len(self.mesh)}-device mesh (contiguous feature shards must align "
                "with subspace boundaries).")
        self.n_features = n_features
        self.n_sub = num_subspaces
        self.sub_d = n_features // num_subspaces
        self.sub_out = min(subspaces_dimension, self.sub_d)
        self.cv_dim = cv_dimension
        self.lag = lag_time
        self.reg = reg
        self.level1: Optional[np.ndarray] = None   # (S, D, sub_out)
        self._level1_t: Optional[torch.Tensor] = None
        self.weights: Optional[np.ndarray] = None  # (F, cv_dim)
        self.eigenvalues_: Optional[np.ndarray] = None

    def _pairs(self, block, carry, device: torch.device, columns: slice):
        """(the time-lagged (x_t, x_lag) device pairs of one block, the
        carry for the next): a lag-frame carry keeps the pairs straddling
        block boundaries. A None block is a segment break (a
        trajectory-file boundary): the carry resets, so no pair crosses it.
        A block longer than the lag gives two pairs, the (lag, F) seam
        against the carry and the block's interior, instead of a copy of
        carry + block; the set of pairs is the same. Only the `columns` of
        the block are taken, on `device`."""
        lag = self.lag
        if block is None:
            return [], None
        block = torch.as_tensor(block[:, columns]).to(device, torch.float32)
        if block.shape[0] > lag and (carry is None or carry.shape[0] == lag):
            pairs = [] if carry is None else [(carry, block[:lag])]
            return pairs + [(block[:-lag], block[lag:])], block[-lag:]
        if carry is not None:
            block = torch.cat([carry, block], dim=0)
        return ([(block[:-lag], block[lag:])] if block.shape[0] > lag else []), block[-lag:]

    def _pass(self, make_block_iter,
              level1: Optional[List[torch.Tensor]] = None) -> List[dict]:
        """One pass of moments over the blocks: one read of them; for each
        block, each mesh entry's worker (`parallel.mesh.run_per_device`)
        takes its contiguous feature slice (whole subspaces) as pairs on
        its device and adds them to its own state (returned in mesh order).
        With `level1` (each device's transform), the workers project their
        slices' pairs and the projections are gathered on the mesh's first
        device into one level-2 state. Every pair is shifted by the first
        pair block's mean: raw second moments cancel when feature means
        dominate their variance, and covariances do not see a shift."""
        mesh = self.mesh
        width = self.n_features // len(mesh)
        columns = [slice(i * width, (i + 1) * width) for i in range(len(mesh))]
        carries: List = [None] * len(mesh)
        if level1 is None:
            states = [_zero_state(self.n_sub // len(mesh), self.sub_d, dev)
                      for dev in mesh.devices]
        else:
            states = [_zero_state(1, self._z_dim, self.device)]
        shifts: List = [None] * len(states)

        def accumulate(i, state, pairs):
            for x_t, x_lag in pairs:
                if shifts[i] is None:
                    shifts[i] = x_t.double().mean(0)
                _accumulate_moments(state, x_t, x_lag, *state["s1"].shape, shift=shifts[i])

        def take(dev, i, block):
            pairs, carries[i] = self._pairs(block, carries[i], dev, columns[i])
            if level1 is not None:
                return [tuple(self._project(x, level1[i]) for x in p) for p in pairs]
            accumulate(i, states[i], pairs)
            return None

        for block in make_block_iter():
            per_device = run_per_device(take, mesh, range(len(mesh)), [block] * len(mesh))
            if level1 is not None:
                # each entry gives the same number of pairs, of equal frames
                accumulate(0, states[0], [
                    tuple(all_gather([p[j][k] for p in per_device], mesh.local(), 1)
                          for k in (0, 1))
                    for j in range(len(per_device[0]))])
        return states
    def fit(self, make_block_iter: Callable[[], Iterable]) -> None:
        """make_block_iter: a callable returning a fresh iterator of
        (frames, n_features) blocks, called once per pass; None items are
        segment breaks. The subspaces shard over the mesh."""
        how = f" (sharded over {len(self.mesh)} devices)" if len(self.mesh) > 1 else ""
        level1 = self._solve_level1(self._pass(make_block_iter), how)
        self._solve_level2(self._pass(make_block_iter, level1)[0])

    @property
    def _z_dim(self) -> int:
        return self.n_sub * self.sub_out

    def _project(self, x: torch.Tensor, level1: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(b, s * sub_d) through the level-1 transform of those s subspaces
        (default all of them): (b, s * sub_out)."""
        level1 = self._level1_t if level1 is None else level1
        s = level1.shape[0]
        xs = x.reshape(x.shape[0], s, self.sub_d).transpose(0, 1)
        return (xs @ level1).transpose(0, 1).reshape(x.shape[0], s * self.sub_out)

    def _solve_level1(self, states: List[dict], how: str) -> List[torch.Tensor]:
        """Each state's subspaces solved on its device, by its entry's
        worker; returns each one's level-1 transform there."""
        solved = run_per_device(
            lambda dev, st: _run_batched_tica(*_moments_to_covs(st)[:2], self.reg, self.sub_out),
            self.mesh, states)
        evals1 = np.concatenate([w for w, _ in solved])
        self.level1 = np.concatenate([v for _, v in solved])
        self._level1_t = torch.as_tensor(self.level1, device=self.device)
        logger.info("StreamingHTICA%s level 1: %d subspaces x %d -> %d dims "
                    "(top eigenvalue %.4f)", how, self.n_sub, self.sub_d, self.sub_out,
                    float(evals1[:, 0].max()))
        return [torch.as_tensor(v, device=st["s1"].device) for (_, v), st in zip(solved, states)]

    def _solve_level2(self, state: dict) -> None:
        c0_2, ctau_2, _ = _moments_to_covs(state)
        w2, v2 = _run_batched_tica(c0_2, ctau_2, self.reg, self._z_dim)
        self.eigenvalues_ = w2[0, : self.cv_dim]
        level2 = v2[0][:, : self.cv_dim]
        # W = blockdiag(level1) @ level2, without the block diagonal
        l2 = level2.reshape(self.n_sub, self.sub_out, self.cv_dim)
        self.weights = np.einsum("sdo,soc->sdc", self.level1, l2).reshape(
            self.n_features, self.cv_dim)

    def fit_fused(self, block_fn: Callable, n_frames: int, block_size: int) -> None:
        """Fit from a device block generator, one program per pass.

        `block_fn(start)` returns the (block_size, n_features) block of
        frames [start, start + block_size), `start` being a 0-dim int64
        tensor on the device. On the card each pass is one CUDA graph of
        every block, so block_fn must be capturable: no host sync (no
        `.item()`, no slicing by the tensor's value; `index_select` with
        `start + torch.arange(block_size)` is) and no host data copied
        up per call; where it is not, the method raises. Same estimator as
        `fit` on the same frames: the first block's mean as shift, and the
        lag pairs across every block seam.
        """
        if n_frames % block_size != 0:
            raise ValueError("n_frames must divide evenly into block_size blocks for "
                             "the fused path.")
        if block_size <= self.lag:
            raise ValueError("block_size must exceed lag_time.")
        n_blocks = n_frames // block_size
        self._fit_blocks(block_fn, (), n_blocks, block_size, n_blocks, " (fused)")

    def fit_chunked(
        self,
        block_fn: Callable,
        n_frames: int,
        block_size: int,
        blocks_per_dispatch: int = 8,
        block_args: tuple = (),
    ) -> None:
        """Fit from a device block generator, one program per
        `blocks_per_dispatch` blocks.

        `block_fn(start, *block_args)` returns the (block_size, n_features)
        block of frames [start, start + block_size), `start` being a 0-dim
        int64 tensor on the device. On the card the body of
        `blocks_per_dispatch` blocks is captured once as a CUDA graph and
        replayed for every group of blocks with `start` rewritten in place,
        so block_fn must be capturable (see `fit_fused`); where it is not,
        the method raises. Each block adds its seam against the previous
        block's last `lag` frames weighted by a has-carry flag, 0 only for
        the first block, so every replay runs the same graph. Same estimator
        as `fit`.
        """
        if n_frames % block_size != 0:
            raise ValueError("n_frames must divide evenly into block_size blocks for "
                             "the chunked path.")
        n_blocks = n_frames // block_size
        k = min(int(blocks_per_dispatch), n_blocks)
        if k < 1 or n_blocks % k != 0:
            raise ValueError(f"blocks_per_dispatch ({blocks_per_dispatch}) must divide "
                             f"the {n_blocks}-block pass evenly.")
        if block_size <= self.lag:
            raise ValueError("block_size must exceed lag_time.")
        self._fit_blocks(block_fn, tuple(block_args), n_blocks, block_size, k,
                         f" (chunked, {k} blocks/dispatch)")

    def _fit_blocks(self, block_fn, block_args, n_blocks, block_size, k, how) -> None:
        def level1_block(start):
            return block_fn(start, *block_args)

        def level2_block(start):
            return self._project(block_fn(start, *block_args))

        self._solve_level1([self._block_pass(level1_block, n_blocks, block_size, k,
                                             self.n_sub, self.sub_d)], how)
        self._solve_level2(self._block_pass(level2_block, n_blocks, block_size, k,
                                            1, self._z_dim))

    def _block_pass(self, block, n_blocks, block_size, k, n_sub, sub_d) -> dict:
        """One pass of moments over `n_blocks` generated blocks, `k` blocks a
        program: a CUDA graph replayed n_blocks / k times on the card, the
        same body run eagerly on the CPU."""
        lag, dev = self.lag, self.device
        width = n_sub * sub_d

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float64, device=dev)

        start = torch.zeros((), dtype=torch.int64, device=dev)
        state = _zero_state(n_sub, sub_d, dev)
        state["n"] = zeros()
        carry, has = zeros(lag, width), zeros()

        def body(shift, state, carry, has, count):
            for j in range(count):
                blk = block(start + j * block_size).double() - shift
                _add_pair_moments(state, carry, blk[:lag], n_sub, sub_d, weight=has)
                _add_pair_moments(state, blk[:-lag], blk[lag:], n_sub, sub_d)
                carry.copy_(blk[-lag:])
                has.fill_(1.0)

        def first_block():
            first = block(start)
            if tuple(first.shape) != (block_size, width):
                raise ValueError(f"block_fn gave a block of shape {tuple(first.shape)}, "
                                 f"expected {(block_size, width)}")
            return first[:-lag].double().mean(0)

        if dev.type != "cuda":
            shift = first_block()
            for c in range(0, n_blocks, k):
                start.fill_(c * block_size)
                body(shift, state, carry, has, k)
            return state
        # On the card: the shift, and one block's moments into a scratch state,
        # on a side stream, are the warm-up that a capture needs.
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            shift = first_block()
            scratch = _zero_state(n_sub, sub_d, dev)
            scratch["n"] = zeros()
            body(shift, scratch, zeros(lag, width), zeros(), 1)
            del scratch
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                body(shift, state, carry, has, k)
        except RuntimeError as exc:
            raise RuntimeError("block_fn cannot be captured in a CUDA graph (it must "
                               "not wait for the card): " + str(exc)) from exc
        for c in range(0, n_blocks, k):
            start.fill_(c * block_size)
            graph.replay()
        # A capture that kept a host copy or a Python value of an early call
        # replays stale blocks: the last block's tail must equal an eager call.
        start.fill_((n_blocks - 1) * block_size)
        tail = block(start).double()[-lag:] - shift
        if not torch.allclose(carry, tail, rtol=1e-5, atol=1e-6 * float(tail.abs().max())):
            raise RuntimeError("block_fn replayed from a CUDA graph gives other blocks "
                               "than called directly: it is not capturable")
        return state

    def project_blocks(self, block_iter: Iterable) -> np.ndarray:
        """Streamed blocks through the final weights."""
        w = torch.as_tensor(self.weights, dtype=torch.float32, device=self.device)
        return np.concatenate([
            (torch.as_tensor(b).to(self.device, torch.float32) @ w).cpu().numpy()
            for b in block_iter
        ])
