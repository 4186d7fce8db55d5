"""Deep-TICA CV calculator (PyTorch): the port of the JAX package's
cv/deep.py training path.

Same semantics as the JAX package: the seeded tries (seed + 1 .. seed + T,
each with its own random split of the lag pairs), early stopping,
best/last model selection, batch-size clamping to a power of two, the
-sum(eigenvalues) loss over a weighted batch TICA with the -dim sanity
bound, the output TICA layer fitted on the network outputs over all pairs,
and the min-max post-normalization of the latent to [-1, 1].

Differences, on purpose:

- The tries always train as one batched program (`Trainer.fit_ensemble`).
  If that fails, the error is raised; the JAX package falls back to serial
  tries, which would hide a fault on the card. `_run_tries_serial` is kept
  as the reference the tests hold the batched tries to.
- Everything runs on the calculator's device (CUDA unless the caller asks
  for the CPU); there is no small-work routing to the host.
- model.zip holds the parameters in Flax's msgpack layout, written and
  read without Flax (`models/msgpack.py`), so either package loads the
  other's; `cv_weights.pt` is the port's own CV traced to TorchScript.
  Try checkpoints are `model.msgpack` + `score.txt` (no Orbax mirror).
- Not yet ported (ROADMAP): batchnorm folding for the deployed net (a
  config with batchnorm raises; Queue 1 item 4), the loss and eigenvalue
  plots (item 6), the AE and VAE calculators (item 4).
"""

from __future__ import annotations

import copy
import json
import logging
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deep_cartograph_torch.cv.base import CVCalculator, cv_names_map
from deep_cartograph_torch.cv.tica_math import (
    generalized_eigh,
    tica,
    timelagged_covariances,
)
from deep_cartograph_torch.deploy import DeepTICAProjection
from deep_cartograph_torch.models.networks import DeepTICANet, DeepTICAStack, Params
from deep_cartograph_torch.models.torch_export import (
    TorchScriptProjector,
    save_torchscript,
)
from deep_cartograph_torch.models.training import (
    KLAnnealing,
    Trainer,
    TrainerConfig,
    TrainResult,
)
from deep_cartograph_torch.models.weights import load_params, save_params
from deep_cartograph_torch.utils.common import remove_files, zip_files
from deep_cartograph_torch.utils.device import DeviceLike

logger = logging.getLogger(__name__)

# Frames per vmap(jacrev) chunk in sensitivity_analysis: bounds the
# (frames, n_cvs, features) Jacobian held on the device at once.
_SENSITIVITY_CHUNK_FRAMES = 4096


def closest_power_of_two(n: int) -> int:
    """Largest power of two strictly below n (cf. reference common.py:645-666)."""
    p = 2 ** math.floor(math.log2(n))
    if p == n:
        p //= 2
    return p


def validation_never_improved(valid_losses) -> bool:
    """True when no later validation loss beat the first one."""
    vl = list(valid_losses)
    return len(vl) > 1 and min(vl[1:]) >= vl[0]


class NonLinear(CVCalculator):
    """Base class of the network-based CV calculators."""

    def __init__(self, configuration=None, output_path=None, device: DeviceLike = None):
        super().__init__(configuration, output_path, device)

        self.training_config: Dict = self.configuration.get("training", {})
        self.general_config: Dict = self.training_config.get("general", {})
        self.early_stopping_config: Dict = self.training_config.get(
            "early_stopping", {}
        )
        self.optimizer_config: Dict = self.training_config.get("optimizer", {})
        self.lr_scheduler: Optional[Dict] = self.training_config.get("lr_scheduler")
        self.model_to_save: str = self.training_config.get("model_to_save", "best")

        self.num_tries: int = self.general_config.get("num_tries", 10)
        self.seed: int = self.general_config.get("seed", 42)
        self.training_validation_lengths: List = self.general_config.get(
            "lengths", [0.8, 0.2]
        )
        self.batch_size: int = self.general_config.get("batch_size", 32)
        self.shuffle: bool = self.general_config.get("shuffle", True)
        self.random_split: bool = self.general_config.get("random_split", True)
        self.max_epochs: int = self.general_config.get("max_epochs", 100)
        self.check_val_every_n_epoch: int = self.general_config.get(
            "check_val_every_n_epoch", 1
        )
        self.save_check_every_n_epoch: int = self.general_config.get(
            "save_check_every_n_epoch", 1
        )
        self.early_stop_patience: int = self.early_stopping_config.get("patience", 20)
        self.early_stop_delta: float = self.early_stopping_config.get(
            "min_delta", 1e-5
        )

        self.encoder_config: Dict = dict(self.architecture_config.get("encoder") or {})
        self.encoder_hidden_layers: List[int] = list(
            self.encoder_config.get("layers", [])
        )

        self.cv_score: Optional[float] = None
        self.metrics: Optional[Dict] = None
        self.try_results: List[Tuple[int, TrainResult]] = []
        self.epoch_seconds: List[float] = []
        self.architecture: Optional[Dict] = None
        self.params: Optional[Params] = None
        self.module = None
        self.post_mean: Optional[np.ndarray] = None
        self.post_range: Optional[np.ndarray] = None
        self.training_metrics_paths: List[str] = []
        self._torch_projector: Optional[TorchScriptProjector] = None

    # ------------------------------------------------------------------
    # Option plumbing
    # ------------------------------------------------------------------
    def _layer_options(self, config: Dict) -> Dict:
        """Per-transition option lists with the last layer appended (cf.
        set_up_encoder_last_layer, cv_calculator.py:1155-1219)."""
        return {
            "activation": list(config.get("activation") or [])
            + [config.get("last_layer_activation")],
            "dropout": list(config.get("dropout") or [])
            + [config.get("last_layer_dropout")],
            "batchnorm": list(config.get("batchnorm") or [])
            + [config.get("last_layer_batchnorm", False)],
        }

    def _norm_arrays(self):
        """norm_in arrays baked into the model, float32 on the device."""
        if self.feats_norm_mode is None:
            return None, None
        return (
            torch.as_tensor(self.features_norm_mean, dtype=torch.float32,
                            device=self.device),
            torch.as_tensor(self.features_norm_range, dtype=torch.float32,
                            device=self.device),
        )

    # Subclass surface --------------------------------------------------
    def build_module(self):
        raise NotImplementedError

    def build_architecture_dict(self) -> Dict:
        raise NotImplementedError

    def loss_fn(self, params, batch, generators, beta, train=True):
        raise NotImplementedError

    def train_datasets(self) -> Dict[str, torch.Tensor]:
        return {"data": self.training_data}

    def valid_datasets(self) -> Optional[Dict[str, torch.Tensor]]:
        if self.validation_data is None:
            return None
        return {"data": self.validation_data}

    def uses_post_annealing(self) -> bool:
        return False

    def kl_annealing_schedule(self) -> Optional[KLAnnealing]:
        return None

    # ------------------------------------------------------------------
    # Training loop (cf. reference NonLinear.train, cv_calculator.py:1456-1553)
    # ------------------------------------------------------------------
    def _split(self, dataset: Dict[str, torch.Tensor], seed: int):
        n = len(next(iter(dataset.values())))
        n_train = int(n * self.training_validation_lengths[0])
        order = (np.random.default_rng(seed).permutation(n) if self.random_split
                 else np.arange(n))
        rows = {}
        for part, idx in (("train", order[:n_train]), ("valid", order[n_train:])):
            idx_t = torch.as_tensor(idx)
            rows[part] = {k: v[idx_t.to(v.device)] for k, v in dataset.items()}
        return rows["train"], rows["valid"]

    def _trainer_config(self, steps_per_epoch: int) -> TrainerConfig:
        lr_scheduler = None
        if self.lr_scheduler:
            name = self.lr_scheduler.get("name", "")
            kwargs = dict(self.lr_scheduler.get("kwargs", {}))
            if name == "OneCycleLR":
                kwargs.setdefault("max_lr", 1e-3)
                kwargs.setdefault("epochs", self.max_epochs)
                kwargs.setdefault("steps_per_epoch", steps_per_epoch)
            elif name == "ReduceLROnPlateau":
                kwargs.setdefault("patience", self.early_stop_patience // 4)
                kwargs.setdefault("cooldown", self.early_stop_patience // 8)
                kl = self.kl_annealing_schedule()
                if kl is not None:
                    kwargs.setdefault(
                        "start_epoch",
                        kl.end_epoch + (self.max_epochs - kl.end_epoch) // 4,
                    )
            lr_scheduler = {"name": name, "kwargs": kwargs}
        return TrainerConfig(
            batch_size=self.batch_size,
            max_epochs=self.max_epochs,
            shuffle=self.shuffle,
            check_val_every_n_epoch=self.check_val_every_n_epoch,
            save_check_every_n_epoch=self.save_check_every_n_epoch,
            early_stop_patience=self.early_stop_patience,
            early_stop_min_delta=self.early_stop_delta,
            optimizer_name=self.optimizer_config.get("name", "Adam"),
            optimizer_kwargs=self.optimizer_config.get("kwargs", {}),
            lr_scheduler=lr_scheduler,
            kl_annealing=self.kl_annealing_schedule(),
            model_to_save=self.model_to_save,
            post_annealing_checkpoint=self.uses_post_annealing(),
        )

    def train(self) -> bool:
        """Train the seeded tries and keep the best valid one. Returns False
        when no try produced a valid model."""
        if any(self._layer_options(self.encoder_config)["batchnorm"]):
            raise NotImplementedError(
                "Batchnorm in the encoder needs fold_feedforward_batchnorm, "
                "which is not ported yet (ROADMAP Queue 1, AE and VAE)."
            )
        logger.info("Training %s ...", cv_names_map[self.cv_name])
        dataset = self.train_datasets()
        provided_valid = self.valid_datasets()

        n_total = len(next(iter(dataset.values())))
        n_train = (
            n_total
            if provided_valid is not None
            else int(n_total * self.training_validation_lengths[0])
        )
        logger.info("Number of training samples: %d", n_train)
        if self.batch_size >= n_train:
            self.batch_size = closest_power_of_two(n_train)
            logger.warning(
                "Batch size larger than the training set; clamped to the "
                "closest power of two: %d", self.batch_size,
            )
        steps_per_epoch = int(np.ceil(n_train / self.batch_size))
        trainer = Trainer(self.loss_fn, self._trainer_config(steps_per_epoch),
                          self.device)
        self.try_results = self._run_tries_ensemble(
            trainer, dataset, provided_valid, n_total, n_train
        )
        self.epoch_seconds = trainer.epoch_seconds

        best: Optional[TrainResult] = None
        for try_num, result in self.try_results:
            self._save_try_checkpoint(result, try_num)
            if validation_never_improved(result.metrics.get("valid_loss") or []):
                logger.warning(
                    "Try %d: validation loss did not decrease during training.",
                    try_num,
                )
            if not self._validate_result(result):
                continue
            logger.info("Try %d/%d: score = %.5f", try_num, self.num_tries,
                        result.score)
            if best is None or result.score < best.score:
                best = result
                logger.info("  -> New best model (try %d).", try_num)

        if best is None:
            logger.error(
                "%s did not produce a valid model after %d tries.",
                cv_names_map[self.cv_name], self.num_tries,
            )
            return False
        self.params = best.params
        self.cv_score = best.score
        self.metrics = best.metrics
        self.finalize_model()
        self.cv = self
        logger.info("Best model score across %d tries: %.5f", self.num_tries,
                    best.score)
        return True

    def _run_tries_serial(
        self, trainer: Trainer, dataset, provided_valid
    ) -> List[Tuple[int, TrainResult]]:
        """One fit per seed, in sequence (the reference's loop): what the
        batched tries are held to."""
        out = []
        for try_num in range(1, self.num_tries + 1):
            seed = self.seed + try_num
            if provided_valid is not None:
                train_data, valid_data = dataset, provided_valid
            else:
                train_data, valid_data = self._split(dataset, seed)
            params = {k: v[0] for k, v in self._init_params_stack([seed]).items()}
            out.append((try_num, trainer.fit(params, train_data, valid_data, seed)))
        return out

    def _init_params_stack(self, seeds: Sequence[int]) -> Params:
        """Flax-like initial parameters of every try, stacked."""
        self.module = self.build_module()
        return self.module.init(seeds)

    def _run_tries_ensemble(
        self, trainer: Trainer, dataset, provided_valid, n_total, n_train
    ) -> List[Tuple[int, TrainResult]]:
        """All seeded tries as one batched program, with per-try splits and
        batch orders identical to the serial path."""
        T = self.num_tries
        seeds = [self.seed + t for t in range(1, T + 1)]
        if provided_valid is not None:
            n_valid = len(next(iter(provided_valid.values())))
            train_idx = np.tile(np.arange(n_total, dtype=np.int32), (T, 1))
            valid_idx = np.tile(np.arange(n_valid, dtype=np.int32), (T, 1))
        else:
            orders = [
                np.random.default_rng(s).permutation(n_total)
                if self.random_split else np.arange(n_total)
                for s in seeds
            ]
            train_idx = np.asarray([o[:n_train] for o in orders], np.int32)
            valid_idx = np.asarray([o[n_train:] for o in orders], np.int32)
        params_stack = self._init_params_stack(seeds)
        logger.info("Training %d seeded tries as one batched program.", T)
        results = trainer.fit_ensemble(
            params_stack, dataset, train_idx, valid_idx, seeds, provided_valid
        )
        return list(zip(range(1, T + 1), results))

    def _save_try_checkpoint(self, result: TrainResult, try_num: int) -> None:
        """Each try's selected model under training/checkpoints/try_N/
        (model.msgpack, score.txt), once the output folders exist."""
        if getattr(self, "training_output_folder", None) is None:
            return
        try:
            folder = os.path.join(str(self.training_output_folder), "checkpoints",
                                  f"try_{try_num}")
            os.makedirs(folder, exist_ok=True)
            save_params(result.params, os.path.join(folder, "model.msgpack"))
            with open(os.path.join(folder, "score.txt"), "w") as fh:
                fh.write(f"{result.score:.7g} ({result.description}, "
                         f"epoch {result.best_epoch})\n")
        except OSError as exc:  # a checkpoint never stops the training
            logger.warning("Could not save try checkpoint: %s", exc)

    def _validate_result(self, result: TrainResult) -> bool:
        """Subclass hook for sanity bounds (DeepTICA loss >= -dim)."""
        return True

    def finalize_model(self) -> None:
        """Post-training hook (DeepTICA fits its output TICA layer here)."""
        self.architecture = self.build_architecture_dict()

    def compute_cv(self) -> None:
        if self.train():
            self.plot_training_metrics()
        else:
            self.cv = None

    # ------------------------------------------------------------------
    # Projection + postprocessing (latent min-max to [-1, 1];
    # cf. reference normalize_cv, cv_calculator.py:1735-1754)
    # ------------------------------------------------------------------
    def latent(self, data) -> np.ndarray:
        raise NotImplementedError

    def normalize_cv(self) -> None:
        latent = self.latent(self.training_data)
        lmin, lmax = latent.min(axis=0), latent.max(axis=0)
        self.post_mean = ((lmax + lmin) / 2).astype(np.float64)
        self.post_range = ((lmax - lmin) / 2).astype(np.float64)
        self.post_range = np.where(
            np.abs(self.post_range) < 1e-12, 1.0, self.post_range
        )
        self.architecture["post_mean"] = self.post_mean.tolist()
        self.architecture["post_range"] = self.post_range.tolist()

    def project_data(self, data, normalize_data: bool = True) -> np.ndarray:
        if self._torch_projector is not None:
            return self._torch_projector(data)
        out = self.latent(data)
        if self.post_mean is not None:
            out = (out - self.post_mean) / self.post_range
        return out.astype(np.float32)

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------
    def save_weights(self, weights_path: str) -> None:
        """TorchScript weights, for PLUMED."""
        save_torchscript(self.projection(), self.num_features, weights_path)

    def save_model(self) -> None:
        super().save_model()
        m = str(self.model_output_folder)
        save_params(self.params, os.path.join(m, "flax_params.msgpack"))
        with open(os.path.join(m, "architecture.json"), "w") as fh:
            json.dump(self.architecture, fh)
        self.save_weights(os.path.join(m, "cv_weights.pt"))
        self._zip_and_clean_model()

    def _load_from_folder(self, folder_path: str) -> None:
        """The parameters and architecture of a model.zip; a zip holding
        only TorchScript weights is served through them."""
        super()._load_from_folder(folder_path)
        m = str(self.model_output_folder)
        arch_path = os.path.join(m, "architecture.json")
        params_path = os.path.join(m, "flax_params.msgpack")
        ts_path = os.path.join(m, "cv_weights.pt")
        if os.path.exists(arch_path) and os.path.exists(params_path):
            with open(arch_path) as fh:
                self.architecture = json.load(fh)
            self._restore_from_architecture()
            self.params = {k: v.to(self.device) for k, v in load_params(params_path).items()}
            self.build_module_from_architecture()
            self.cv = self
        elif os.path.exists(ts_path):
            logger.info("No msgpack weights in the model; loading the TorchScript "
                        "weights.")
            self._torch_projector = TorchScriptProjector(ts_path, self.device)
            self.cv = self
        else:
            raise FileNotFoundError(f"CV model weights not found in {m}")

    def _restore_from_architecture(self) -> None:
        arch = self.architecture
        for name in ("post_mean", "post_range"):
            value = arch.get(name)
            setattr(self, name, None if value is None else np.asarray(value))
        if arch.get("norm_mean") is not None:
            self.features_norm_mean = np.asarray(arch["norm_mean"])
            self.features_norm_range = np.asarray(arch["norm_range"])

    def build_module_from_architecture(self) -> None:
        raise NotImplementedError

    def get_cv_parameters(self) -> Dict:
        return {"cv_name": self.cv_name, "cv_dimension": self.cv_dimension,
                "weights_path": getattr(self, "weights_path", None)}

    def get_cv_type(self) -> str:
        return "non-linear"

    def plot_training_metrics(self) -> None:
        """The loss curves (.npy, zipped into training_metrics.zip) and the
        model score. The plots wait for ROADMAP Queue 1 item 6."""
        if self.metrics is None:
            return
        folder = str(self.training_output_folder)
        if self.training_config.get("save_loss", True):
            for key in ("train_loss", "valid_loss", "epoch"):
                if key in self.metrics:
                    path = os.path.join(folder, f"{key}.npy")
                    np.save(path, np.asarray(self.metrics[key]))
                    self.training_metrics_paths.append(path)
            np.savetxt(os.path.join(folder, "model_score.txt"),
                       np.asarray([self.cv_score]), fmt="%.7g")
        if self.training_metrics_paths:
            zip_files(os.path.join(folder, "training_metrics.zip"),
                      *self.training_metrics_paths)
            remove_files(*self.training_metrics_paths)


def deep_tica_batch_eigvals(module: DeepTICAStack, params: Params, batch,
                            generators, reg: float, train: bool = True):
    """Weighted batch TICA eigenvalues (T, n_cvs) of the network outputs:
    the DeepTICA objective's core (cf. reference cv_calculator.py:2507-2627).
    q_t and q_lag see the same dropout masks, as on the JAX side, where
    both forwards take one key."""
    states = None
    if train and any(module.options["dropout"]):
        states = [g.get_state() for g in generators]
    q_t = module(params, batch["data"], train=train, generators=generators)
    if states is not None:
        for g, state in zip(generators, states):
            g.set_state(state)
    q_lag = module(params, batch["data_lag"], train=train, generators=generators)
    c0, ctau, _ = timelagged_covariances(q_t, q_lag, batch["weight"])
    evals, _ = generalized_eigh(ctau, c0, reg)
    return evals


def make_deep_tica_loss(module: DeepTICAStack, reg: float, dim: int):
    """Trainer-compatible DeepTICA loss over `module` (-sum of eigenvalues)."""

    def loss_fn(params, batch, generators, beta, train=True):
        evals = deep_tica_batch_eigvals(module, params, batch, generators, reg,
                                        train=train)
        aux = {f"eigval_{i + 1}": evals[:, i] for i in range(dim)}
        return -evals.sum(-1), aux

    return loss_fn


class DeepTICACalculator(NonLinear):
    """DeepTICA CV (cf. reference cv_calculator.py:2507-2627)."""

    def __init__(self, configuration=None, output_path=None, device: DeviceLike = None):
        super().__init__(configuration, output_path, device)
        self.cv_name = "deep_tica"
        self.tica_reg = self.configuration.get("tica_regularization", 1e-6)
        self.x_t: Optional[torch.Tensor] = None
        self.x_lag: Optional[torch.Tensor] = None
        self.val_x_t: Optional[torch.Tensor] = None
        self.val_x_lag: Optional[torch.Tensor] = None
        self.tica_evecs: Optional[np.ndarray] = None
        self.eigenvalues_: Optional[np.ndarray] = None
        self.net = None

    def _set_training_data(self, features, traj_labels, feature_names) -> None:
        super()._set_training_data(features, traj_labels, feature_names)
        self.x_t, self.x_lag = self._lag_pairs(
            self.training_data, self.training_data_labels
        )

    def _set_validation_data(self, features, traj_labels) -> None:
        super()._set_validation_data(features, traj_labels)
        self.val_x_t, self.val_x_lag = self._lag_pairs(
            self.validation_data, self.validation_data_labels
        )

    def train_datasets(self):
        return {"data": self.x_t, "data_lag": self.x_lag}

    def valid_datasets(self):
        if self.val_x_t is None:
            return None
        return {"data": self.val_x_t, "data_lag": self.val_x_lag}

    def _layers(self) -> List[int]:
        return [self.num_features] + self.encoder_hidden_layers + [self.cv_dimension]

    def build_module(self) -> DeepTICAStack:
        mean, rng = self._norm_arrays()
        return DeepTICAStack(self._layers(), self._layer_options(self.encoder_config),
                             norm_mean=mean, norm_range=rng)

    def build_architecture_dict(self) -> Dict:
        mean, rng = self._norm_arrays()
        return {
            "kind": "deep_tica",
            "layers": self._layers(),
            "encoder_options": self._layer_options(self.encoder_config),
            "norm_mean": None if mean is None else mean.cpu().numpy().tolist(),
            "norm_range": None if rng is None else rng.cpu().numpy().tolist(),
            "tica_evecs": None,
            "post_mean": None,
            "post_range": None,
        }

    def loss_fn(self, params, batch, generators, beta, train=True):
        loss = make_deep_tica_loss(self.module, self.tica_reg, self.cv_dimension)
        return loss(params, batch, generators, beta, train)

    def _validate_result(self, result: TrainResult) -> bool:
        """DeepTICA sanity bound: loss = -sum(eigvals) >= -dim
        (cf. reference cv_calculator.py:1624-1637)."""
        if result.score < -float(self.cv_dimension):
            logger.warning(
                "Deep TICA validation loss (%.5f) is below the theoretical "
                "minimum (%.5f). Sign of ill-conditioned training; try a "
                "lower learning rate or higher tica_regularization.",
                result.score, -float(self.cv_dimension),
            )
            return False
        return True

    def finalize_model(self) -> None:
        """Build the trained net and fit the output TICA layer on its
        outputs over all training pairs."""
        super().finalize_model()
        self.net = DeepTICANet(self.module.layers, self.module.options, self.params,
                               self.module.norm_mean, self.module.norm_range)
        with torch.no_grad():
            q_t = self.net(self.x_t)
            q_lag = self.net(self.x_lag)
        self.eigenvalues_, self.tica_evecs = tica(
            q_t, q_lag, self.cv_dimension, reg=self.tica_reg, device=self.device
        )
        self.architecture["tica_evecs"] = self.tica_evecs.tolist()

    def build_module_from_architecture(self) -> None:
        arch = self.architecture
        if arch.get("tica_evecs") is not None:
            self.tica_evecs = np.asarray(arch["tica_evecs"])
        self.net = DeepTICANet(arch["layers"], arch["encoder_options"], self.params,
                               arch.get("norm_mean"), arch.get("norm_range")
                               ).to(self.device)

    def projection(self):
        """The trained CV as a serving module (`deploy.FramesToCV`): net,
        TICA layer and post-normalization, as far as they are fitted (or
        the TorchScript module of a zip that holds only that)."""
        if self._torch_projector is not None:
            return self._torch_projector.module
        # a copy: FramesToCV moves its projection to its own device
        return DeepTICAProjection(copy.deepcopy(self.net), self.tica_evecs,
                                  self.post_mean, self.post_range)

    def _evecs(self) -> Optional[torch.Tensor]:
        if self.tica_evecs is None:
            return None
        return torch.as_tensor(self.tica_evecs, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def latent(self, data) -> np.ndarray:
        if self._torch_projector is not None:
            raise RuntimeError("latent() is not available for a TorchScript-only model")
        out = self.net(self._as_device_matrix(data))
        if self.tica_evecs is not None:
            out = out @ self._evecs()
        return out.cpu().numpy()

    def sensitivity_analysis(self) -> None:
        """Mean |d cv_k / d x_j| over the training set and the CV
        components (before post-normalization), by `vmap(jacrev)` over
        chunks of _SENSITIVITY_CHUNK_FRAMES frames on the device."""
        from torch.func import jacrev, vmap

        evecs = self._evecs()

        def forward(x):
            out = self.net(x[None])
            return (out if evecs is None else out @ evecs)[0]

        jac_of = vmap(jacrev(forward))
        total = torch.zeros(self.num_features, dtype=torch.float64, device=self.device)
        data = self.training_data
        step = _SENSITIVITY_CHUNK_FRAMES
        for s in range(0, data.shape[0], step):
            jac = jac_of(data[s : s + step])                # (n, n_cvs, features)
            total += jac.abs().sum((0, 1)).double()
        sens = (total / (data.shape[0] * self.cv_dimension)).float().cpu().numpy()
        self._save_sensitivity(self.features_ref_labels, sens,
                               str(self.sensitivity_output_folder))

    def plot_training_metrics(self) -> None:
        super().plot_training_metrics()
        if self.eigenvalues_ is not None:
            np.savetxt(os.path.join(str(self.training_output_folder), "eigenvalues.txt"),
                       np.asarray(self.eigenvalues_), fmt="%.7g")
