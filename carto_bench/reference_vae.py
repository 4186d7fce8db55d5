"""The plain reference of the VAE CV (`configs/lambda80_vae.json`): the
input normalization, the encoder with its activations and dropout, the
mean and log-variance heads, the sample z = mean + exp(logvar / 2) eps, the
decoder, the per-sample reconstruction MSE over the features and the KL
summed over the latent, the loss recon + beta KL averaged over the batch,
its gradients and Adam's first steps, written from the definitions in plain
PyTorch. It imports nothing of the program and takes nothing the program
made: the initial parameters, splits, batch orders, dropout masks and noise
are worked out again from the configuration and the seed.

Every function takes a `reference.Precision` (float64 for the reference;
float32 with TF32 products for the control): on a card its scope sets
`allow_tf32` to False unless the control asks for TF32.

Where this follows the program rather than mlcolvar's
`VariationalAutoEncoderCV`, on purpose:

- Initial kernels are Flax's lecun-normal (a normal truncated to two
  standard deviations, of variance 1/fan_in) and biases zero, not torch's
  `nn.Linear` draws; each try draws from a CPU generator of its own seed,
  layer after layer: the encoder, the mean head, the log-variance head,
  the decoder.
- Dropout masks and the noise eps come from one generator per try, seeded
  with the try's seed, on the training device, in the order the program
  draws them (`draws`), not from the global generator.
- leaky_relu's derivative at 0 is its slope, as in torch's
  `F.leaky_relu` (an x > 0 test): with zero initial biases a row whose
  units dropout zeroed all reaches the next layer at exactly 0.
- The layers' options are those `train_colvars` resolves for the
  configuration (`encoder_resolved`, `decoder_resolved`): per layer, so a
  decoder's last layer takes the last entry of its block's activation list
  (leaky_relu for the example), and each dropout rate scales the kept
  entries by 1 / (1 - rate).
- The latent is sampled in validation too, with dropout off.
- beta weighs the KL term (the KL annealing's weight of the epoch).
- Adam's bias corrections are computed in the reference's precision (the
  program takes optax's float32 ones).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from carto_bench.reference import FLOAT64, LEAKY_SLOPE, Precision, _activate

STD_UNIT = 0.87962566103423978  # std of the unit normal truncated to [-2, 2]

Params = Dict[str, torch.Tensor]


def layer_plan(n_features: int, encoder_hidden: Sequence[int], n_cvs: int,
               decoder_hidden: Sequence[int]) -> List[Tuple[str, int, int]]:
    """(name, fan_in, fan_out) of every dense layer, in the order a try
    draws its initial kernels: encoder [F, *hidden], the mean and
    log-variance heads (last hidden width -> n_cvs), decoder
    [n_cvs, *hidden, F]."""
    enc = [n_features] + list(encoder_hidden)
    dec = [n_cvs] + list(decoder_hidden) + [n_features]
    plan = [(f"encoder/dense_{i}", a, b) for i, (a, b) in enumerate(zip(enc[:-1], enc[1:]))]
    plan += [("mean_nn", enc[-1], n_cvs), ("log_var_nn", enc[-1], n_cvs)]
    plan += [(f"decoder/dense_{i}", a, b) for i, (a, b) in enumerate(zip(dec[:-1], dec[1:]))]
    return plan


def initial_params(plan, seeds: Sequence[int], dtype) -> Params:
    """Each try's kernels drawn from a CPU generator of its seed in the
    plan's order, zero biases; stacked over tries."""
    out: Dict[str, List[torch.Tensor]] = {}
    for s in seeds:
        gen = torch.Generator().manual_seed(int(s))
        for name, fan_in, fan_out in plan:
            std = math.sqrt(1.0 / fan_in) / STD_UNIT
            k = torch.nn.init.trunc_normal_(torch.empty(fan_in, fan_out), 0.0, std,
                                            -2 * std, 2 * std, generator=gen)
            out.setdefault(f"{name}/kernel", []).append(k)
            out.setdefault(f"{name}/bias", []).append(torch.zeros(fan_out))
    return {k: torch.stack(v).to(dtype) for k, v in out.items()}


def draws(batch: int, seeds: Sequence[int], n_cvs: int, encoder_widths: Sequence[int],
          encoder_dropout: Sequence, decoder_widths: Sequence[int], decoder_dropout: Sequence,
          steps: int, device) -> list:
    """Per step, (encoder keep masks, eps, decoder keep masks): each (T,
    batch, width), a layer without dropout None. Try t's numbers come from
    a generator of its seed on `device`, in the program's order within a
    step: a uniform draw for each encoder layer with dropout, a normal draw
    of eps, a uniform draw for each decoder layer with dropout."""
    gens = [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]

    def masks(widths, rates):
        return [None if not r else torch.stack([
            torch.rand((batch, w), generator=g, device=device) for g in gens]) >= r
            for w, r in zip(widths, rates)]

    out = []
    for _ in range(steps):
        enc = masks(encoder_widths, encoder_dropout)
        eps = torch.stack([torch.randn((batch, n_cvs), generator=g, device=device)
                           for g in gens])
        out.append((enc, eps, masks(decoder_widths, decoder_dropout)))
    return out


def activate(x: torch.Tensor, name) -> torch.Tensor:
    """`reference._activate`, but leaky_relu takes its slope at 0."""
    if name == "leaky_relu":
        return torch.where(x > 0, x, LEAKY_SLOPE * x)
    return _activate(x, name)


def dense(params: Params, x: torch.Tensor, name: str, p: Precision) -> torch.Tensor:
    return p.mm(x, params[f"{name}/kernel"]) + params[f"{name}/bias"].unsqueeze(-2)


def stack(params: Params, x: torch.Tensor, prefix: str, options: dict,
          masks: Optional[Sequence] = None, p: Precision = FLOAT64) -> torch.Tensor:
    """A block's dense layers on (T, B, in) inputs, each followed by its
    activation and, where `masks` holds the layer's keep mask, inverted
    dropout at its rate."""
    for i, (act, rate) in enumerate(zip(options["activation"], options["dropout"])):
        x = activate(dense(params, x, f"{prefix}dense_{i}", p), act)
        if rate and masks is not None and masks[i] is not None:
            x = torch.where(masks[i], x / (1.0 - rate), torch.zeros_like(x))
    return x


def normalized(x: torch.Tensor, norm, dtype) -> torch.Tensor:
    """(x - mean) / range, or x where the configuration normalizes
    nothing (`norm` None)."""
    x = x.to(dtype)
    return x if norm is None else (x - norm[0].to(dtype)) / norm[1].to(dtype)


def latent_mean(params: Params, x: torch.Tensor, norm, options: dict,
                p: Precision = FLOAT64) -> torch.Tensor:
    """The CV: the mean head on the encoder's output, no dropout."""
    h = stack(params, normalized(x, norm, p.dtype), "encoder/", options["encoder"], p=p)
    return dense(params, h, "mean_nn", p)


def elbo_parts(params: Params, x: torch.Tensor, norm, options: dict, eps: torch.Tensor,
               masks: Tuple[Optional[Sequence], Optional[Sequence]] = (None, None),
               p: Precision = FLOAT64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample (reconstruction MSE over the features, KL of N(mean,
    exp(logvar)) from N(0, 1) summed over the latent), each (T, B), of
    (T, B, F) inputs with the given eps and (encoder, decoder) keep masks."""
    xn = normalized(x, norm, p.dtype)
    h = stack(params, xn, "encoder/", options["encoder"], masks[0], p)
    mean = dense(params, h, "mean_nn", p)
    logvar = dense(params, h, "log_var_nn", p)
    z = mean + torch.exp(0.5 * logvar) * eps.to(p.dtype)
    x_hat = stack(params, z, "decoder/", options["decoder"], masks[1], p)
    recon = ((x_hat - xn) ** 2).mean(-1)
    kl = -0.5 * (1 + logvar - mean ** 2 - torch.exp(logvar)).sum(-1)
    return recon, kl


def adam_steps(x: torch.Tensor, norm, params: Params, batches, step_draws: list,
               options: dict, beta: float, lr: float, betas=(0.9, 0.999), eps=1e-8,
               p: Precision = FLOAT64, keep_rows: float = 1.0,
               zero_eps: bool = False) -> dict:
    """Adam's first steps on the ELBO of every try at once, the batches'
    rows of `x` ((steps, T, B) indices) with each step's draws. Returns each
    step's loss, reconstruction and KL ((steps, T) each), the first gradient
    and the parameters after the last step. Planted faults: `keep_rows` < 1
    keeps only that share of each batch, `zero_eps` samples z = mean."""
    params = {k: v.to(p.dtype).clone().requires_grad_(True) for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    out = {"losses": [], "recon": [], "kl": []}
    first_grad = None
    for step, idx in enumerate(batches):
        keep = max(1, int(idx.shape[1] * keep_rows))
        rows = torch.as_tensor(idx[:, :keep], device=x.device)
        enc, noise, dec = step_draws[step]
        cut = lambda ms: [None if m is None else m[:, :keep] for m in ms]  # noqa: E731
        noise = torch.zeros_like(noise) if zero_eps else noise
        recon, kl = elbo_parts(params, x[rows], norm, options, noise[:, :keep],
                               (cut(enc), cut(dec)), p)
        recon, kl = recon.mean(-1), kl.mean(-1)
        loss = recon + beta * kl
        grads = torch.autograd.grad(loss.sum(), list(params.values()))
        for key, v in (("losses", loss), ("recon", recon), ("kl", kl)):
            out[key].append(v.detach())
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
    return {**{k: torch.stack(v) for k, v in out.items()}, "first_grad": first_grad,
            "params": {k: v.detach() for k, v in params.items()}}
