"""Network building blocks for deep collective variables (PyTorch).

The port of the JAX package's models/networks.py: the mlcolvar feed-forward
options (per-layer activation / dropout / batchnorm, input normalization
"norm_in") carry over so configs translate 1:1. Batchnorm is stateless: it
uses the statistics of the batch it is given, in training and in
evaluation alike (no running averages), as on the JAX side; a trained net
folds it into its dense layers with full-training-set statistics
(`fold_feedforward_batchnorm`) before it is deployed.

One forward, `feedforward_stack`, owns the layer rules. Parameters are a
flat dict of tensors named like the Flax tree ("nn/dense_0/kernel") with a
leading tries axis T: kernels (T, in, out), biases (T, out). The forward is
one `torch.baddbmm` per layer over (T, B, in) inputs; this replaces the JAX
side's `vmap` over `init` and over the epoch program. The stacks hold the
nets of a training run's T seeded tries: `DeepTICAStack`,
`AutoEncoderStack` and `VAEStack` (the Flax `DeepTICANet`, `AutoEncoderCV`
and `VAECV`); each one's `forward` is the CV. `TrainedNet` is one trained
try of a stack as an `nn.Module` for serving (`deploy.py`): the same
forward with T = 1, holding only the parameters the CV reads.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deep_cartograph_torch.utils.profiling import annotate

ACTIVATIONS: dict = {
    None: lambda x: x,
    "linear": lambda x: x,
    "relu": F.relu,
    "elu": F.elu,
    "tanh": torch.tanh,
    "softplus": F.softplus,
    "shifted_softplus": lambda x: F.softplus(x) - math.log(2.0),
    "custom_sigmoid": torch.sigmoid,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.01),
}


Params = Dict[str, torch.Tensor]

# Flax's truncated normal keeps [-2, 2] standard deviations; dividing by the
# std of the truncated unit normal restores the variance 1/fan_in.
_TRUNCATED_NORMAL_STD = 0.87962566103423978

# Batchnorm's variance epsilon, as on the JAX side.
BN_EPS = 1e-5


def lecun_normal_(tensor: torch.Tensor, fan_in: int, generator) -> torch.Tensor:
    """Flax `Dense`'s default kernel init (`lecun_normal`): a truncated
    normal of variance 1/fan_in. (`torch.nn.Linear` uses kaiming-uniform.)"""
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_NORMAL_STD
    return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def seed_generators(seeds: Sequence[int]) -> List[torch.Generator]:
    """One CPU `torch.Generator` per try (so the CPU and the card start from
    the same numbers)."""
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def init_dense(params: Params, name: str, fan_in: int, fan_out: int,
               generators: Sequence[torch.Generator]) -> None:
    """One Flax-like `Dense` per try: a lecun-normal kernel drawn from each
    try's generator, a zero bias."""
    kernel = torch.empty((len(generators), fan_in, fan_out))
    for t, gen in enumerate(generators):
        lecun_normal_(kernel[t], fan_in, gen)
    params[f"{name}/kernel"] = kernel
    params[f"{name}/bias"] = torch.zeros((len(generators), fan_out))


def init_feedforward_stack(
    layers: Sequence[int], batchnorm: Sequence[bool],
    generators: Sequence[torch.Generator], prefix: str = "",
) -> Params:
    """Flax-like initial parameters of one MLP per try, stacked on a leading
    tries axis: kernels drawn from each try's generator, zero biases,
    batchnorm scale 1 and bias 0."""
    T = len(generators)
    params: Params = {}
    for i in range(len(layers) - 1):
        init_dense(params, f"{prefix}dense_{i}", layers[i], layers[i + 1], generators)
        if i < len(batchnorm) and batchnorm[i]:
            params[f"{prefix}bn_scale_{i}"] = torch.ones((T, layers[i + 1]))
            params[f"{prefix}bn_bias_{i}"] = torch.zeros((T, layers[i + 1]))
    return params


def _dropout_stack(x: torch.Tensor, rate: float, generators,
                   masks: Optional[Dict[int, torch.Tensor]], layer: int) -> torch.Tensor:
    """Dropout on (T, B, F) with try t's mask drawn from generators[t].
    With `masks`, the layer's mask is drawn once, kept under its index and
    applied again by every later forward that is given the same dict."""
    keep = None if masks is None else masks.get(layer)
    if keep is None:
        keep = torch.stack([
            torch.rand(x.shape[1:], generator=g, device=x.device) for g in generators
        ]) >= rate
        if masks is not None:
            masks[layer] = keep
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dense_stack(params: Params, x: torch.Tensor, name: str) -> torch.Tensor:
    """One stacked `Dense`: x (T, B, in) -> (T, B, out)."""
    return torch.baddbmm(params[f"{name}/bias"].unsqueeze(1), x, params[f"{name}/kernel"])


def feedforward_stack(
    params: Params,
    x: torch.Tensor,
    activation: Sequence[Optional[str]],
    dropout: Sequence[Optional[float]],
    batchnorm: Sequence[bool],
    train: bool = False,
    generators: Optional[List[torch.Generator]] = None,
    prefix: str = "",
    masks: Optional[Dict[int, torch.Tensor]] = None,
) -> torch.Tensor:
    """The MLP of T tries at once: x (T, B, in) -> (T, B, out).

    Batchnorm takes each try's statistics over its whole batch (padded rows
    of a ragged batch included, as on the JAX side). Dropout is active
    only with `train=True` and then needs one generator per try; forwards
    given one `masks` dict share their dropout masks, drawn by the first."""
    n = sum(1 for k in params if k.startswith(prefix) and k.endswith("/kernel"))
    for i in range(n):
        x = dense_stack(params, x, f"{prefix}dense_{i}")
        if i < len(batchnorm) and batchnorm[i]:
            mu = x.mean(1, keepdim=True)
            var = x.var(1, keepdim=True, unbiased=False)
            x = (x - mu) / torch.sqrt(var + BN_EPS)
            x = (x * params[f"{prefix}bn_scale_{i}"].unsqueeze(1)
                 + params[f"{prefix}bn_bias_{i}"].unsqueeze(1))
        x = ACTIVATIONS[activation[i] if i < len(activation) else None](x)
        rate = dropout[i] if i < len(dropout) else None
        if rate and train:
            x = _dropout_stack(x, rate, generators, masks, i)
    return x


@torch.no_grad()
def fold_feedforward_batchnorm(
    params: Params,
    layers: Sequence[int],
    activation: Sequence[Optional[str]],
    batchnorm: Sequence[bool],
    x: torch.Tensor,
    prefix: str = "",
) -> Tuple[Params, torch.Tensor]:
    """Fold each batchnorm into the dense layer before it, with the
    statistics of `x` (the inputs the deployed net will see, e.g. the whole
    training set): returns (the dense-only parameters of the MLP, the
    folded net's outputs on `x`).

    Batchnorm at evaluation is the affine y' = (y - mu) / sqrt(var + eps) *
    scale + bias, so with g = scale / sqrt(var + eps) the folded dense layer
    is W' = W g, b' = (b - mu) g + bias: a plain MLP, deterministic,
    independent of the batch and exactly exportable. `params` are the MLP's
    flat parameters (keys `prefix` + "dense_<i>/kernel", ...), one try's or
    stacked on a leading tries axis; `x` is (B, in), or (T, B, in) for
    per-try inputs. Float32, as on the JAX side."""
    new: Params = {}
    x = x.float()
    for i in range(len(layers) - 1):
        name = f"{prefix}dense_{i}"
        kernel = params[f"{name}/kernel"].float()
        bias = params[f"{name}/bias"].float()
        y = x @ kernel + bias.unsqueeze(-2)
        if i < len(batchnorm) and batchnorm[i]:
            mu = y.mean(-2)
            var = y.var(-2, unbiased=False)
            g = params[f"{prefix}bn_scale_{i}"].float() / torch.sqrt(var + BN_EPS)
            kernel = kernel * g.unsqueeze(-2)
            bias = (bias - mu) * g + params[f"{prefix}bn_bias_{i}"].float()
            y = x @ kernel + bias.unsqueeze(-2)
        new[f"{name}/kernel"] = kernel
        new[f"{name}/bias"] = bias
        x = ACTIVATIONS[activation[i] if i < len(activation) else None](y)
    return new, x


def reparam_noise(shape: Sequence[int], generators: List[torch.Generator]) -> torch.Tensor:
    """The VAE's reparameterization noise eps ~ N(0, 1), (T, B, n_cvs): try
    t's slice drawn from generators[t], on that generator's device, so a
    try draws alike whether it trains alone or among others. The one source
    of eps (tests replace it to share eps with the JAX package)."""
    return torch.stack([
        torch.randn(tuple(shape[1:]), generator=g, device=g.device) for g in generators
    ])


def _pad_options(options: dict, n_transitions: int) -> dict:
    """Extend per-layer option lists to the number of transitions."""
    out = {}
    for key, default in (("activation", None), ("dropout", None), ("batchnorm", False)):
        vals = list(options.get(key) or [])
        while len(vals) < n_transitions:
            vals.append(default)
        out[key] = vals[:n_transitions]
    return out


def _optional_buffer(module: nn.Module, name: str, value) -> None:
    module.register_buffer(
        name, None if value is None else torch.as_tensor(value, dtype=torch.float32)
    )


class _Stack(nn.Module):
    """A net of T seeded tries: the fixed input normalization ("norm_in")
    as buffers; the trained parameters are passed to each call.
    `cv_scopes` names the parameter scopes the CV (`forward`) reads."""

    cv_scopes: Tuple[str, ...] = ()

    def __init__(self, norm_mean=None, norm_range=None):
        super().__init__()
        _optional_buffer(self, "norm_mean", norm_mean)
        _optional_buffer(self, "norm_range", norm_range)

    def normalize_in(self, x: torch.Tensor) -> torch.Tensor:
        # on x's device: the tries of a mesh run on several devices
        if self.norm_mean is None:
            return x
        return (x - self.norm_mean.to(x.device)) / self.norm_range.to(x.device)


class DeepTICAStack(_Stack):
    """The deep-TICA network of T seeded tries: norm_in, then the stacked
    MLP under the parameter names of the Flax `DeepTICANet` ("nn/...")."""

    cv_scopes = ("nn",)

    def __init__(self, layers: Sequence[int], options: dict,
                 norm_mean=None, norm_range=None):
        super().__init__(norm_mean, norm_range)
        self.layers = list(layers)
        self.options = _pad_options(options, len(self.layers) - 1)

    def init(self, seeds: Sequence[int]) -> Params:
        return init_feedforward_stack(
            self.layers, self.options["batchnorm"], seed_generators(seeds), prefix="nn/"
        )

    def forward(self, params: Params, x: torch.Tensor, train: bool = False,
                generators: Optional[List[torch.Generator]] = None,
                masks: Optional[Dict[int, torch.Tensor]] = None):
        """x (T, B, in) -> (T, B, n_cvs); `masks` as `feedforward_stack`'s."""
        return feedforward_stack(params, self.normalize_in(x), train=train,
                                 generators=generators, prefix="nn/", masks=masks,
                                 **self.options)


class AutoEncoderStack(_Stack):
    """The autoencoder of T seeded tries (Flax `AutoEncoderCV`): norm_in,
    encoder ("encoder/dense_<i>") to the latent CV, decoder
    ("decoder/dense_<i>") back to the normalized input for training."""

    cv_scopes = ("encoder",)

    def __init__(self, encoder_layers: Sequence[int], decoder_layers: Sequence[int],
                 encoder_options: dict, decoder_options: dict,
                 norm_mean=None, norm_range=None):
        super().__init__(norm_mean, norm_range)
        self.encoder_layers = list(encoder_layers)
        self.decoder_layers = list(decoder_layers)
        self.encoder_options = _pad_options(encoder_options, len(self.encoder_layers) - 1)
        self.decoder_options = _pad_options(decoder_options, len(self.decoder_layers) - 1)

    def init(self, seeds: Sequence[int]) -> Params:
        gens = seed_generators(seeds)
        params = init_feedforward_stack(self.encoder_layers,
                                        self.encoder_options["batchnorm"], gens, "encoder/")
        params.update(init_feedforward_stack(self.decoder_layers,
                                             self.decoder_options["batchnorm"], gens,
                                             "decoder/"))
        return params

    def encode(self, params: Params, xn: torch.Tensor, train: bool = False,
               generators=None) -> torch.Tensor:
        return feedforward_stack(params, xn, train=train, generators=generators,
                                 prefix="encoder/", **self.encoder_options)

    def forward(self, params: Params, x: torch.Tensor, train: bool = False,
                generators: Optional[List[torch.Generator]] = None):
        """The CV, the latent: x (T, B, in) -> (T, B, n_cvs)."""
        return self.encode(params, self.normalize_in(x), train, generators)

    def reconstruct(self, params: Params, x: torch.Tensor, train: bool = False,
                    generators: Optional[List[torch.Generator]] = None):
        """(x_hat, xn): the decoder's output and the normalized input."""
        xn = self.normalize_in(x)
        z = self.encode(params, xn, train, generators)
        x_hat = feedforward_stack(params, z, train=train, generators=generators,
                                  prefix="decoder/", **self.decoder_options)
        return x_hat, xn


class VAEStack(_Stack):
    """The variational autoencoder of T seeded tries (Flax `VAECV`): norm_in,
    the encoder's hidden stack ("encoder/dense_<i>"), the mean and log
    variance heads ("mean_nn", "log_var_nn", n_cvs wide), and the decoder
    ("decoder/dense_<i>") from the n_cvs-wide latent. The CV is the mean."""

    cv_scopes = ("encoder", "mean_nn")

    def __init__(self, n_cvs: int, encoder_layers: Sequence[int],
                 decoder_layers: Sequence[int], encoder_options: dict,
                 decoder_options: dict, norm_mean=None, norm_range=None):
        super().__init__(norm_mean, norm_range)
        self.n_cvs = int(n_cvs)
        self.encoder_layers = list(encoder_layers)
        self.decoder_layers = [self.n_cvs] + list(decoder_layers)
        self.encoder_options = _pad_options(encoder_options,
                                            max(len(self.encoder_layers) - 1, 0))
        self.decoder_options = _pad_options(decoder_options, len(self.decoder_layers) - 1)

    def init(self, seeds: Sequence[int]) -> Params:
        gens = seed_generators(seeds)
        params = init_feedforward_stack(self.encoder_layers,
                                        self.encoder_options["batchnorm"], gens, "encoder/")
        hidden = self.encoder_layers[-1]
        init_dense(params, "mean_nn", hidden, self.n_cvs, gens)
        init_dense(params, "log_var_nn", hidden, self.n_cvs, gens)
        params.update(init_feedforward_stack(self.decoder_layers,
                                             self.decoder_options["batchnorm"], gens,
                                             "decoder/"))
        return params

    def _hidden(self, params, xn, train, generators):
        return feedforward_stack(params, xn, train=train, generators=generators,
                                 prefix="encoder/", **self.encoder_options)

    def forward(self, params: Params, x: torch.Tensor, train: bool = False,
                generators: Optional[List[torch.Generator]] = None):
        """The CV, the latent mean: x (T, B, in) -> (T, B, n_cvs)."""
        h = self._hidden(params, self.normalize_in(x), train, generators)
        return dense_stack(params, h, "mean_nn")

    def elbo_parts(self, params: Params, x: torch.Tensor,
                   generators: List[torch.Generator], train: bool = True):
        """Per-sample (reconstruction MSE, KL) of the ELBO, each (T, B). The
        latent sample z = mean + exp(logvar / 2) eps draws eps from
        `reparam_noise` in training and validation alike; `train` only
        switches dropout. Spans: `vae.encode` (norm_in, hidden stack,
        heads), `vae.sample` (eps and z), `vae.decode`, `vae.elbo`
        (reconstruction and KL)."""
        with annotate("vae.encode"):
            xn = self.normalize_in(x)
            h = self._hidden(params, xn, train, generators)
            mean = dense_stack(params, h, "mean_nn")
            logvar = dense_stack(params, h, "log_var_nn")
        with annotate("vae.sample"):
            z = mean + torch.exp(0.5 * logvar) * reparam_noise(mean.shape, generators)
        with annotate("vae.decode"):
            x_hat = feedforward_stack(params, z, train=train, generators=generators,
                                      prefix="decoder/", **self.decoder_options)
        with annotate("vae.elbo"):
            recon = ((x_hat - xn) ** 2).mean(-1)
            kl = -0.5 * (1 + logvar - mean ** 2 - torch.exp(logvar)).sum(-1)
        return recon, kl


def stack_from_architecture(arch: Dict) -> _Stack:
    """The stack of a deep CV's architecture dict (the model.zip's
    architecture.json, either package's)."""
    kind = arch["kind"]
    norm = (arch.get("norm_mean"), arch.get("norm_range"))
    if kind == "deep_tica":
        return DeepTICAStack(arch["layers"], arch.get("encoder_options") or {}, *norm)
    if kind == "ae":
        return AutoEncoderStack(arch["encoder_layers"], arch["decoder_layers"],
                                arch.get("encoder_options") or {},
                                arch.get("decoder_options") or {}, *norm)
    if kind == "vae":
        return VAEStack(arch["n_cvs"], arch["encoder_layers"], arch["decoder_layers"],
                        arch.get("encoder_options") or {},
                        arch.get("decoder_options") or {}, *norm)
    raise ValueError(f"Unknown deep CV kind: {kind}")


class TrainedNet(nn.Module):
    """One trained try of a stack, (B, in) -> (B, n_cvs): the stack's CV
    with T = 1. `params` are one try's, without the tries axis; only the
    scopes the CV reads (`stack.cv_scopes`) are kept. What the calculator
    applies on top (deep-TICA's TICA layer, the post normalization) is
    outside the module (deploy.NetProjection)."""

    def __init__(self, stack: _Stack, params: Params):
        super().__init__()
        self.stack = stack
        self.names = [k for k in params if k.split("/")[0] in stack.cv_scopes]
        for i, name in enumerate(self.names):
            self.register_buffer(f"param_{i}", params[name].detach()
                                 .to(torch.float32).unsqueeze(0).clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = {name: getattr(self, f"param_{i}")
                  for i, name in enumerate(self.names)}
        return self.stack(params, x.unsqueeze(0))[0]
