"""Floating-point operations of one VAE training step
(`jobs/train_vae.py`), from shapes, counted as `counts.py` counts them:
a dense layer 2 in out a row, its bias and activation 2 out, dropout's
scale and select 2 out; exp counts as one operation."""

from __future__ import annotations

from typing import Sequence

from carto_bench.counts import mlp_forward_flops

SAMPLE_FLOPS = 4   # z = mean + exp(logvar / 2) eps: half, exp, product, sum
RECON_FLOPS = 3    # a feature's difference, square and share of the sum
KL_FLOPS = 6       # 1 + logvar - mean^2 - exp(logvar) and its share of the sum
ADAM_FLOPS = 12    # an entry's Adam update (counts.train_step_flops)


def vae_step_flops(batch: int, tries: int, encoder_layers: Sequence[int], n_cvs: int,
                   decoder_layers: Sequence[int], encoder_dropout_layers: int,
                   decoder_dropout_layers: int, normalized: bool) -> int:
    """One step of every try. Forward, a row: the input normalization (2 a
    feature, where the configuration normalizes), the encoder
    (`encoder_layers` [F, *hidden], dropout on its first
    `encoder_dropout_layers` layers), the mean and log-variance heads (2 h
    n_cvs + n_cvs each), the sample, the decoder (`decoder_layers` [n_cvs,
    *hidden, F], dropout on its first `decoder_dropout_layers`), the
    reconstruction over the F features and the KL over the latent.
    Backward, a row: each dense layer's weight gradient and the input
    gradient of every layer but the first (2 in out each), and the
    forward's element-wise work once more (the normalization takes no
    gradient). Adam: 12 an entry of every parameter."""
    n_features, hidden = encoder_layers[0], encoder_layers[-1]
    dense = (list(zip(encoder_layers[:-1], encoder_layers[1:])) + [(hidden, n_cvs)] * 2
             + list(zip(decoder_layers[:-1], decoder_layers[1:])))
    matmul = sum(2 * a * b for a, b in dense)
    norm = 2 * n_features if normalized else 0
    forward = (norm + mlp_forward_flops(1, encoder_layers, encoder_dropout_layers)
               + 2 * (2 * hidden * n_cvs + n_cvs) + SAMPLE_FLOPS * n_cvs
               + mlp_forward_flops(1, decoder_layers, decoder_dropout_layers)
               + RECON_FLOPS * n_features + KL_FLOPS * n_cvs)
    backward = 2 * matmul - 2 * encoder_layers[0] * encoder_layers[1] + forward - matmul - norm
    n_params = sum(a * b + b for a, b in dense)
    return tries * (batch * (forward + backward) + ADAM_FLOPS * n_params)
