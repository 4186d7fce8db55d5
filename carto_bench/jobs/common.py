"""Pieces the jobs share: the configuration as `train_colvars` resolves
it, comparisons and the blocks the reference runs in."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

REFERENCE_BLOCK_FRAMES = 16384
ENCODER_KEYS = ("activation", "dropout", "batchnorm", "last_layer_activation",
                "last_layer_dropout", "last_layer_batchnorm")


def calculator_config(config: dict, max_epochs: int) -> dict:
    """The deep-TICA configuration `train_colvars` builds from the
    configuration's `train_colvars.common` block (`cv`)."""
    from deep_cartograph_torch.config.schemas import cv_configuration, train_colvars_config

    cfg = cv_configuration(train_colvars_config({"common": config["cv"]}), "deep_tica")
    cfg["training"]["general"]["max_epochs"] = int(max_epochs)
    cfg["training"]["plot_loss"] = False
    return cfg


def resolved_encoder(config: dict, cfg: dict) -> dict:
    """The encoder's per-layer options as the configuration states them
    resolved (`encoder_resolved`), after making sure that `train_colvars`
    resolves the `cv` block to the same (`cfg`, from calculator_config):
    the reference and the served model.zip read the stated options, the
    trainer the resolved ones."""
    stated = config["encoder_resolved"]
    encoder = cfg["architecture"]["encoder"]
    differ = [k for k in ENCODER_KEYS if encoder.get(k) != stated.get(k)]
    if differ:
        raise RuntimeError(f"train_colvars resolves the encoder's {', '.join(differ)} to "
                           f"{[encoder.get(k) for k in differ]}, the configuration states "
                           f"{[stated.get(k) for k in differ]}")
    return {k: stated.get(k) for k in ENCODER_KEYS}


def max_abs_by_column_group(program: np.ndarray, frames: np.ndarray,
                            reference: Callable[[np.ndarray], torch.Tensor],
                            groups: dict, device) -> dict:
    """Largest |program - reference| in each named group of columns, over
    the rows `program` holds for `frames` (indices into the inputs),
    with the reference computed block by block on `device`."""
    worst = {name: 0.0 for name in groups}
    for start in range(0, len(frames), REFERENCE_BLOCK_FRAMES):
        idx = frames[start:start + REFERENCE_BLOCK_FRAMES]
        ref = reference(idx)
        got = torch.as_tensor(np.ascontiguousarray(program[start:start + len(idx)]),
                              device=device).to(ref.dtype)
        if got.shape != ref.shape:
            return {name: float("inf") for name in groups}
        gap = (got - ref).abs()
        gap = torch.where(torch.isnan(gap), torch.full_like(gap, float("inf")), gap)
        for name, cols in groups.items():
            worst[name] = max(worst[name], float(gap[:, cols].max()))
    return worst


def inputs_made(device) -> None:
    """Drop what making the inputs left on the card and restart its
    memory peak, so that the peak a run reports is the program's."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
