"""The plain reference of every configuration here: CA features, the served
deep-TICA CV and the first steps of deep-TICA training, written from the
definitions in plain PyTorch. It imports nothing of the program and takes
nothing the program made: the weights, normalization, initial parameters,
batch orders and dropout masks are worked out again from the configuration
and the seed.

Every function takes a `dtype` (float64 for the reference; float32 for the
lower-precision control) and runs its matrix products under
`matmul_precision` ("highest", or "tf32" for the control: on a card
`allow_tf32`, on the CPU the inputs rounded to TF32's 10-bit mantissa).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import numpy as np
import torch

ANGSTROM_TO_NM = 0.1
LEAKY_SLOPE = 0.01


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, nearest even);
    the gradient passes through unrounded (the CPU's stand-in for the
    card's TF32 products, in tests)."""
    bits = x.detach().float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return x + (bits.view(torch.float32).to(x.dtype) - x).detach()


class Precision:
    """Where the reference runs and in which precision."""

    def __init__(self, dtype=torch.float64, matmul: str = "highest"):
        self.dtype = dtype
        self.matmul = matmul

    @contextlib.contextmanager
    def scope(self):
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.matmul == "tf32"
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.matmul == "tf32" and a.device.type == "cpu":
            return _tf32_round(a) @ _tf32_round(b)
        return a @ b


FLOAT64 = Precision()


def features(coords: torch.Tensor, ca: np.ndarray, pairs: np.ndarray, quads: np.ndarray,
             p: Precision = FLOAT64) -> torch.Tensor:
    """(F, A, 3) Angstrom frames -> (F, P + 2Q): CA distances (nm), then
    sin and cos of each CA virtual dihedral, as the labels order them."""
    c = coords[:, torch.as_tensor(ca, device=coords.device)].to(p.dtype)
    i, j = (torch.as_tensor(pairs[:, k], device=c.device) for k in (0, 1))
    dist = torch.linalg.vector_norm(c[:, i] - c[:, j], dim=-1) * ANGSTROM_TO_NM
    q = [c[:, torch.as_tensor(quads[:, k], device=c.device)] for k in range(4)]
    b0, b1, b2 = q[0] - q[1], q[2] - q[1], q[3] - q[2]
    b1n = b1 / torch.linalg.vector_norm(b1, dim=-1, keepdim=True)
    v = b0 - (b0 * b1n).sum(-1, keepdim=True) * b1n
    w = b2 - (b2 * b1n).sum(-1, keepdim=True) * b1n
    ang = torch.atan2((torch.linalg.cross(b1n, v) * w).sum(-1), (v * w).sum(-1))
    sincos = torch.stack([torch.sin(ang), torch.cos(ang)], -1).reshape(len(c), -1)
    return torch.cat([dist, sincos], 1)


def layer_options(encoder: dict, n_transitions: int) -> Dict[str, list]:
    """Per-layer activation and dropout of upstream deep_cartograph's
    encoder: the hidden layers' lists with the last layer's entry appended,
    cut to the number of layers (so a list as long as the layers gives the
    last layer its own last entry)."""
    act = list(encoder.get("activation") or []) + [encoder.get("last_layer_activation")]
    drop = list(encoder.get("dropout") or []) + [encoder.get("last_layer_dropout")]
    pad = lambda xs: (xs + [None] * n_transitions)[:n_transitions]  # noqa: E731
    return {"activation": pad(act), "dropout": pad(drop)}


def _activate(x: torch.Tensor, name) -> torch.Tensor:
    if name in (None, "linear"):
        return x
    if name == "leaky_relu":
        return torch.where(x >= 0, x, LEAKY_SLOPE * x)
    if name == "tanh":
        return torch.tanh(x)
    if name == "relu":
        return torch.clamp_min(x, 0)
    raise ValueError(f"activation {name} has no reference")


def mlp(params: Dict[str, torch.Tensor], x: torch.Tensor, options: dict,
        masks: Sequence = (), p: Precision = FLOAT64, record: list = None) -> torch.Tensor:
    """The encoder on (..., B, in) inputs; `masks[i]`, where given, is layer
    i's dropout keep mask (inverted dropout). `record`, where given,
    collects each layer's pre-activations."""
    n = len(options["activation"])
    for i in range(n):
        x = p.mm(x, params[f"nn/dense_{i}/kernel"]) + params[f"nn/dense_{i}/bias"].unsqueeze(-2)
        if record is not None:
            record.append(x.detach())
        x = _activate(x, options["activation"][i])
        rate = options["dropout"][i]
        if rate and i < len(masks):
            x = torch.where(masks[i], x / (1.0 - rate), torch.zeros_like(x))
    return x


def served_cv(feats: torch.Tensor, weights: Dict[str, torch.Tensor], options: dict,
              p: Precision = FLOAT64) -> torch.Tensor:
    """The served deep-TICA CV: (x - mean) / range, the encoder, the TICA
    eigenvectors, then (cv - post_mean) / post_range."""
    w = {k: v.to(feats.device, p.dtype) for k, v in weights.items()}
    x = (feats.to(p.dtype) - w["norm_mean"]) / w["norm_range"]
    out = p.mm(mlp(w, x, options, p=p), w["tica_evecs"])
    return (out - w["post_mean"]) / w["post_range"]


# ---------------------------------------------------------------------------
# deep-TICA training
# ---------------------------------------------------------------------------

def deep_tica_loss(q_t: torch.Tensor, q_lag: torch.Tensor, reg: float,
                   p: Precision = FLOAT64) -> torch.Tensor:
    """-(sum of the batch TICA eigenvalues) of (T, B, d) outputs: C0 and
    the symmetrized Ctau about x_t's mean, whitened by the Cholesky factor
    of C0 + reg I (mlcolvar's estimator)."""
    b = q_t.shape[-2]
    mu = q_t.mean(-2, keepdim=True)
    a, l = q_t - mu, q_lag - mu
    at = a.transpose(-1, -2)
    c0 = p.mm(at, a) / b
    ctau = 0.5 * (p.mm(at, l) + p.mm(l.transpose(-1, -2), a)) / b
    eye = torch.eye(c0.shape[-1], dtype=c0.dtype, device=c0.device)
    chol = torch.linalg.cholesky(0.5 * (c0 + c0.transpose(-1, -2)) + reg * eye)
    li = torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)
    white = p.mm(p.mm(li, ctau), li.transpose(-1, -2))
    return -torch.linalg.eigvalsh(0.5 * (white + white.transpose(-1, -2))).sum(-1)


def tica_layer(q_t: torch.Tensor, q_lag: torch.Tensor, reg: float,
               p: Precision = FLOAT64):
    """The TICA layer on a network's (N, d) outputs: the eigenvalues
    (descending) and eigenvectors of Ctau v = w (C0 + reg I) v, the
    covariances about q_t's mean with Ctau symmetrized (mlcolvar's
    estimator), each eigenvector scaled to v^T (C0 + reg I) v = 1 with its
    largest-magnitude component positive."""
    q_t, q_lag = q_t.to(p.dtype), q_lag.to(p.dtype)
    mu = q_t.mean(0, keepdim=True)
    a, l = q_t - mu, q_lag - mu
    n = len(a)
    c0 = p.mm(a.T, a) / n
    ctau = 0.5 * (p.mm(a.T, l) + p.mm(l.T, a)) / n
    eye = torch.eye(c0.shape[-1], dtype=c0.dtype, device=c0.device)
    b = 0.5 * (c0 + c0.T) + reg * eye
    li = torch.linalg.inv(torch.linalg.cholesky(b))
    w, u = torch.linalg.eigh(0.5 * (li @ ctau @ li.T + (li @ ctau @ li.T).T))
    w, u = w.flip(-1), u.flip(-1)
    v = li.T @ u
    lead = v.abs().argmax(0)
    sign = torch.sign(v[lead, torch.arange(v.shape[1], device=v.device)])
    return w, v * torch.where(sign == 0, torch.ones_like(sign), sign)


def initial_params(layers: Sequence[int], seeds: Sequence[int], dtype) -> Dict[str, torch.Tensor]:
    """Flax `Dense`'s init for each try (seed): a truncated normal kernel
    of variance 1/fan_in drawn from a CPU generator seeded with the try's
    seed, layer after layer, and zero biases; stacked over tries."""
    std_unit = 0.87962566103423978  # std of the unit normal truncated to [-2, 2]
    out: Dict[str, List[torch.Tensor]] = {}
    for s in seeds:
        gen = torch.Generator().manual_seed(int(s))
        for i, (fan_in, fan_out) in enumerate(zip(layers[:-1], layers[1:])):
            std = (1.0 / fan_in) ** 0.5 / std_unit
            k = torch.nn.init.trunc_normal_(torch.empty(fan_in, fan_out), 0.0, std,
                                            -2 * std, 2 * std, generator=gen)
            out.setdefault(f"nn/dense_{i}/kernel", []).append(k)
            out.setdefault(f"nn/dense_{i}/bias", []).append(torch.zeros(fan_out))
    return {k: torch.stack(v).to(dtype) for k, v in out.items()}


def first_batches(n_pairs: int, train_share: float, batch: int, seeds: Sequence[int],
                  steps: int) -> np.ndarray:
    """(steps, T, batch) pair indices of each try's first steps: the try's
    random split (permutation from its seed, the first share for training)
    and its first epoch's shuffled batches (a fresh generator of the same
    seed)."""
    n_train = int(n_pairs * train_share)
    out = np.empty((steps, len(seeds), batch), np.int64)
    for t, s in enumerate(seeds):
        rows = np.random.default_rng(s).permutation(n_pairs)[:n_train]
        order = np.random.default_rng(s).permutation(n_train)
        for k in range(steps):
            out[k, t] = rows[order[k * batch:(k + 1) * batch]]
    return out


def dropout_masks(shape, seeds: Sequence[int], options: dict, steps: int, device) -> list:
    """Per step, the keep masks of each dropout layer, (T, B, width): try
    t's drawn from a generator of its seed on the training device, one
    uniform draw per layer and step (both lag halves share it)."""
    gens = [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]
    out = []
    for _ in range(steps):
        masks = []
        for i, rate in enumerate(options["dropout"]):
            if not rate:
                break
            masks.append(torch.stack([
                torch.rand(shape[i], generator=g, device=device) for g in gens]) >= rate)
        out.append(masks)
    return out


def adam_steps(x_t: torch.Tensor, x_lag: torch.Tensor, norm_mean, norm_range,
               params: Dict[str, torch.Tensor], batches: np.ndarray, masks: list,
               options: dict, reg: float, lr: float, betas=(0.9, 0.999), eps=1e-8,
               p: Precision = FLOAT64, keep_rows: float = 1.0) -> dict:
    """Adam's first steps on the deep-TICA loss of every try at once.
    Returns each step's losses (steps, T), the first gradient and the
    parameters after the last step. `keep_rows` < 1 keeps only that share
    of each batch (a planted fault)."""
    params = {k: v.to(p.dtype).clone().requires_grad_(True) for k, v in params.items()}
    mean = torch.as_tensor(norm_mean, dtype=p.dtype, device=x_t.device)
    rng = torch.as_tensor(norm_range, dtype=p.dtype, device=x_t.device)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grad, pre = [], None, []
    for step, idx in enumerate(batches):
        rows = torch.as_tensor(idx[:, :max(1, int(idx.shape[1] * keep_rows))], device=x_t.device)
        m = [mk[:, :rows.shape[1]] for mk in masks[step]]
        xt = (x_t[rows].to(p.dtype) - mean) / rng
        xl = (x_lag[rows].to(p.dtype) - mean) / rng
        pre.append([])
        loss = deep_tica_loss(mlp(params, xt, options, m, p, pre[-1]),
                              mlp(params, xl, options, m, p, pre[-1]), reg, p)
        grads = torch.autograd.grad(loss.sum(), list(params.values()))
        losses.append(loss.detach())
        with torch.no_grad():
            count = step + 1
            for (k, v), g in zip(params.items(), grads):
                mu[k] = (1 - betas[0]) * g + betas[0] * mu[k]
                nu[k] = (1 - betas[1]) * g * g + betas[1] * nu[k]
                u = (mu[k] / (1 - betas[0] ** count)) / (
                    torch.sqrt(nu[k] / (1 - betas[1] ** count)) + eps)
                v.sub_(lr * u)
            if first_grad is None:
                first_grad = {k: g.detach().clone() for k, g in zip(params, grads)}
    return {"losses": torch.stack(losses), "first_grad": first_grad,
            "params": {k: v.detach() for k, v in params.items()},
            "pre_activations": pre}
