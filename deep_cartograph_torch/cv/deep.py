"""Deep CV calculators (PyTorch): deep-TICA, the autoencoder (AE) and the
variational autoencoder (VAE); the port of the JAX package's cv/deep.py.

Same semantics as the JAX package: the seeded tries (seed + 1 .. seed + T,
each with its own random split of the data), early stopping, best/last
model selection (the VAE's post-annealing checkpoint), KL annealing,
batch-size clamping to a power of two, the decoder's last activation
coupled to the feature normalization, batchnorm folded into the dense
layers with full-training-set statistics once a net is trained, the
deep-TICA -sum(eigenvalues) loss over a weighted batch TICA with the -dim
sanity bound and its output TICA layer fitted on the network outputs over
all pairs, the AE's reconstruction MSE, the VAE's ELBO, and the min-max
post-normalization of the CV to [-1, 1].

Differences, on purpose:

- The tries always train as one batched program (`Trainer.fit_ensemble`).
  If that fails, the error is raised; the JAX package falls back to serial
  tries, which would hide a fault on the card. `_run_tries_serial` is kept
  as the reference the tests hold the batched tries to.
- Everything runs on the calculator's device (CUDA unless the caller asks
  for the CPU); there is no small-work routing to the host.
- Dropout masks and the VAE's noise come from torch generators (one per
  try), so runs with either match the JAX package only in distribution.
- model.zip holds the parameters in Flax's msgpack layout, written and
  read without Flax (`models/msgpack.py`), so either package loads the
  other's; `cv_weights.pt` is the port's own CV traced to TorchScript.
  Try checkpoints are `model.msgpack` + `score.txt` (no Orbax mirror).
- Every training plot (loss, learning rate, deep-TICA's eigenvalues, the
  VAE's KL, reconstruction and beta curves) is drawn only when the
  training's `plot_loss` asks for it; the JAX package draws the last four
  whatever it says.
"""

from __future__ import annotations

import copy
import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deep_cartograph_torch.cv.base import CVCalculator, cv_names_map
from deep_cartograph_torch.cv.tica_math import (
    generalized_eigh,
    generalized_eigvals_sum,
    tica,
    timelagged_covariances,
)
from deep_cartograph_torch.deploy import NetProjection
from deep_cartograph_torch.models.networks import (
    Params,
    TrainedNet,
    fold_feedforward_batchnorm,
    stack_from_architecture,
)
from deep_cartograph_torch.models.torch_export import (
    TorchScriptProjector,
    check_exportable,
    save_torchscript,
)
from deep_cartograph_torch.models.training import (
    CHOLESKY_INFO,
    KLAnnealing,
    Trainer,
    TrainerConfig,
    TrainResult,
)
from deep_cartograph_torch.models.weights import load_params, save_params
from deep_cartograph_torch.utils.common import (
    closest_power_of_two,
    remove_files,
    zip_files,
)
from deep_cartograph_torch.utils.device import DeviceLike
from deep_cartograph_torch.utils.profiling import annotate

logger = logging.getLogger(__name__)

# Frames per vmap(jacrev) chunk in sensitivity_analysis: bounds the
# (frames, n_cvs, features) Jacobian held on the device at once.
_SENSITIVITY_CHUNK_FRAMES = 4096


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
        decoder_config = self.architecture_config.get("decoder")
        self.decoder_config: Optional[Dict] = (
            None if decoder_config is None else dict(decoder_config)
        )
        self.encoder_hidden_layers: List[int] = list(
            self.encoder_config.get("layers", [])
        )
        self.decoder_hidden_layers: List[int] = list(
            (self.decoder_config or {}).get("layers", [])
        )

        self.cv_score: Optional[float] = None
        self.metrics: Optional[Dict] = None
        self.try_results: List[Tuple[int, TrainResult]] = []
        self.architecture: Optional[Dict] = None
        self.params: Optional[Params] = None
        self.module = None
        self.net: Optional[TrainedNet] = None
        self.post_mean: Optional[np.ndarray] = None
        self.post_range: Optional[np.ndarray] = None
        self.training_metrics_paths: List[str] = []
        self._torch_projector: Optional[TorchScriptProjector] = None

    # ------------------------------------------------------------------
    # Option plumbing
    # ------------------------------------------------------------------
    def _layer_options(self, config: Dict, is_decoder: bool = False) -> Dict:
        """Per-transition option lists with the last layer appended (cf.
        set_up_encoder_last_layer / set_up_decoder_last_layer,
        cv_calculator.py:1155-1219). A decoder's last activation follows the
        feature normalization: custom_sigmoid onto min_max_range1's [0, 1],
        tanh onto min_max_range2's [-1, 1]."""
        last_act = config.get("last_layer_activation")
        if is_decoder:
            forced = {"min_max_range1": "custom_sigmoid",
                      "min_max_range2": "tanh"}.get(self.feats_norm_mode)
            if forced is not None and last_act != forced:
                logger.warning("Decoder last activation changed to '%s' to match "
                               "%s normalization.", forced, self.feats_norm_mode)
            last_act = forced or last_act
        return {
            "activation": list(config.get("activation") or []) + [last_act],
            "dropout": list(config.get("dropout") or [])
            + [config.get("last_layer_dropout")],
            "batchnorm": list(config.get("batchnorm") or [])
            + [config.get("last_layer_batchnorm", False)],
        }

    def _decoder_source(self) -> Dict:
        """The decoder's options: its own block, else the encoder's."""
        return self.decoder_config if self.decoder_config is not None else dict(
            self.encoder_config)

    def _mirrored_decoder_hidden(self) -> List[int]:
        """The decoder's hidden widths: its own, else the encoder's reversed."""
        if self.decoder_config is not None:
            return self.decoder_hidden_layers
        return self.encoder_hidden_layers[::-1]

    def _norm_lists(self) -> Tuple[Optional[List[float]], Optional[List[float]]]:
        """norm_in arrays baked into the model: float32 values, as JSON lists."""
        if self.feats_norm_mode is None:
            return None, None
        return (np.asarray(self.features_norm_mean, np.float32).tolist(),
                np.asarray(self.features_norm_range, np.float32).tolist())

    def _normalized_training_inputs(self) -> torch.Tensor:
        """The training inputs as the network sees them (after norm_in)."""
        x = self.training_data
        if self.feats_norm_mode is not None:
            x = (x - torch.as_tensor(self.features_norm_mean, dtype=torch.float32,
                                     device=self.device)) / torch.as_tensor(
                self.features_norm_range, dtype=torch.float32, device=self.device)
        return x

    # Subclass surface --------------------------------------------------
    def build_architecture_dict(self) -> Dict:
        raise NotImplementedError

    def build_module(self):
        """The stack of T tries that training runs, on the device."""
        return stack_from_architecture(self.build_architecture_dict()).to(self.device)

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

    @annotate("cv.train")
    def train(self) -> bool:
        """Train the seeded tries and keep the best valid one. Returns False
        when no try produced a valid model."""
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
        with annotate("cv.finalize"):
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
        """The trained net as deployed: its architecture, batchnorm folded,
        the serving net built (DeepTICA then fits its output TICA layer)."""
        self.architecture = self.build_architecture_dict()
        self._fold_batchnorm_for_eval()
        self.build_module_from_architecture()

    @torch.no_grad()
    def _fold_batchnorm_for_eval(self) -> None:
        """Fold batchnorm into the dense layers for the deployed net.

        Training normalizes with each batch's statistics; the deployed net
        freezes the full training set's and folds them into the dense layer
        before each batchnorm: deterministic projections whatever the batch,
        meaningful sensitivity Jacobians, an exactly exportable plain MLP.
        The architecture's batchnorm flags are cleared accordingly. The
        VAE's decoder takes its statistics over the mean head's latent, the
        path the deployed CV evaluates."""
        arch = self.architecture
        eo = arch.get("encoder_options") or {}
        do = arch.get("decoder_options") or {}
        if not (any(eo.get("batchnorm", [])) or any(do.get("batchnorm", []))):
            return
        kind = arch["kind"]
        xn = self._normalized_training_inputs()
        params = self.params
        if kind == "deep_tica":
            folded, _ = fold_feedforward_batchnorm(
                params, arch["layers"], eo.get("activation", []),
                eo.get("batchnorm", []), xn, "nn/")
        else:
            folded, z = fold_feedforward_batchnorm(
                params, arch["encoder_layers"], eo.get("activation", []),
                eo.get("batchnorm", []), xn, "encoder/")
            decoder_layers = list(arch["decoder_layers"])
            if kind == "vae":
                z = z @ params["mean_nn/kernel"] + params["mean_nn/bias"]
                decoder_layers = [arch["n_cvs"]] + decoder_layers
            dec, _ = fold_feedforward_batchnorm(
                params, decoder_layers, do.get("activation", []),
                do.get("batchnorm", []), z, "decoder/")
            folded.update(dec)
        scopes = {k.split("/")[0] for k in folded}
        self.params = {**{k: v for k, v in params.items()
                          if k.split("/")[0] not in scopes}, **folded}
        for opts in (eo, do):
            if opts:
                opts["batchnorm"] = [False] * len(opts.get("batchnorm", []))
        logger.info("Folded batchnorm (training-set statistics) into the dense "
                    "weights of the deployed model.")

    def compute_cv(self) -> None:
        if self.train():
            self.plot_training_metrics()
        else:
            self.cv = None

    # ------------------------------------------------------------------
    # Projection + postprocessing (latent min-max to [-1, 1];
    # cf. reference normalize_cv, cv_calculator.py:1735-1754)
    # ------------------------------------------------------------------
    def _output_layer(self) -> Optional[np.ndarray]:
        """A linear layer on the net's outputs (deep-TICA's TICA
        eigenvectors), or None."""
        return None

    def _output_tensor(self) -> Optional[torch.Tensor]:
        layer = self._output_layer()
        if layer is None:
            return None
        return torch.as_tensor(layer, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def latent(self, data) -> np.ndarray:
        """The CV before post-normalization (net, then the output layer)."""
        if self._torch_projector is not None:
            raise RuntimeError("latent() is not available for a TorchScript-only model")
        out = self.net(self._as_device_matrix(data))
        layer = self._output_tensor()
        if layer is not None:
            out = out @ layer
        return out.cpu().numpy()

    def projection(self):
        """The trained CV as a serving module (`deploy.FramesToCV`): net,
        output layer and post-normalization, as far as they are fitted (or
        the TorchScript module of a zip that holds only that)."""
        if self._torch_projector is not None:
            return self._torch_projector.module
        # a copy: FramesToCV moves its projection to its own device
        return NetProjection(copy.deepcopy(self.net), self._output_layer(),
                             self.post_mean, self.post_range)

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
        """TorchScript weights, for PLUMED, traced on the calculator's
        device."""
        check_exportable(self.architecture)
        save_torchscript(self.projection(), self.num_features, weights_path, self.device)

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
        """The stack and the serving net of `self.architecture` and
        `self.params`, on the device."""
        self.module = stack_from_architecture(self.architecture).to(self.device)
        self.net = TrainedNet(self.module, self.params).to(self.device)

    def get_cv_parameters(self) -> Dict:
        return {"cv_name": self.cv_name, "cv_dimension": self.cv_dimension,
                "weights_path": getattr(self, "weights_path", None)}

    def get_cv_type(self) -> str:
        return "non-linear"

    def sensitivity_analysis(self) -> None:
        """Mean |d cv_k / d x_j| over the training set and the CV
        components (before post-normalization), by `vmap(jacrev)` over
        chunks of _SENSITIVITY_CHUNK_FRAMES frames on the device."""
        from torch.func import jacrev, vmap

        layer = self._output_tensor()

        def forward(x):
            out = self.net(x[None])
            return (out if layer is None else out @ layer)[0]

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

    def _plot_curves(self, curves) -> None:
        """(keys, labels, file name, yscale) curves of the metrics, drawn
        in the training folder when `plot_loss` asks for them and the
        metrics hold every key."""
        from deep_cartograph_torch.figures.plots import plot_metrics

        if not self.training_config.get("plot_loss", True):
            return
        folder = str(self.training_output_folder)
        for keys, labels, name, yscale in curves:
            if all(k in self.metrics for k in keys):
                plot_metrics(self.metrics, keys=keys, labels=labels, yscale=yscale,
                             path=os.path.join(folder, name))

    def plot_training_metrics(self) -> None:
        """The loss curves (.npy, zipped into training_metrics.zip), the
        model score, and the loss and learning-rate plots."""
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
        self._plot_curves([
            (["train_loss", "valid_loss"], ["Training", "Validation"], "loss.png",
             "linear" if self.cv_name == "deep_tica" else "log"),
            (["lr"], ["Learning Rate"], "learning_rate.png", "log"),
        ])
        if self.training_metrics_paths:
            zip_files(os.path.join(folder, "training_metrics.zip"),
                      *self.training_metrics_paths)
            remove_files(*self.training_metrics_paths)


def _deep_tica_covariances(module, params: Params, batch, generators, train: bool):
    """C0 and Ctau (T, n_cvs, n_cvs) of the network's outputs on the
    weighted batch. q_t and q_lag see the same dropout masks, drawn once by
    q_t's forward, as on the JAX side, where both forwards take one key."""
    masks = {} if train else None
    q_t = module(params, batch["data"], train=train, generators=generators, masks=masks)
    q_lag = module(params, batch["data_lag"], train=train, generators=generators,
                   masks=masks)
    c0, ctau, _ = timelagged_covariances(q_t, q_lag, batch["weight"])
    return c0, ctau


def deep_tica_batch_eigvals(module, params: Params, batch,
                            generators, reg: float, train: bool = True):
    """Weighted batch TICA eigenvalues (T, n_cvs) of the network outputs:
    the DeepTICA objective's core (cf. reference cv_calculator.py:2507-2627)."""
    c0, ctau = _deep_tica_covariances(module, params, batch, generators, train)
    evals, _ = generalized_eigh(ctau, c0, reg)
    return evals


def make_deep_tica_loss(module, reg: float, dim: int):
    """Trainer-compatible DeepTICA loss over `module`: -sum of the batch's
    TICA eigenvalues. In training, the sum is the whitened Ctau's trace,
    which waits for no eigh nor for Cholesky's check: the aux carries
    Cholesky's `info` for the trainer to check (`CHOLESKY_INFO`). In
    validation, the aux holds each eigenvalue."""

    def loss_fn(params, batch, generators, beta, train=True):
        if train:
            c0, ctau = _deep_tica_covariances(module, params, batch, generators, True)
            total, info = generalized_eigvals_sum(ctau, c0, reg)
            return -total, {CHOLESKY_INFO: info}
        evals = deep_tica_batch_eigvals(module, params, batch, generators, reg,
                                        train=False)
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

    def build_architecture_dict(self) -> Dict:
        mean, rng = self._norm_lists()
        return {
            "kind": "deep_tica",
            "layers": self._layers(),
            "encoder_options": self._layer_options(self.encoder_config),
            "norm_mean": mean,
            "norm_range": rng,
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
        """The deployed net, then the output TICA layer fitted on its
        outputs over all training pairs."""
        super().finalize_model()
        with torch.no_grad():
            q_t = self.net(self.x_t)
            q_lag = self.net(self.x_lag)
        self.eigenvalues_, self.tica_evecs = tica(
            q_t, q_lag, self.cv_dimension, reg=self.tica_reg, device=self.device
        )
        self.architecture["tica_evecs"] = self.tica_evecs.tolist()

    def _restore_from_architecture(self) -> None:
        super()._restore_from_architecture()
        if self.architecture.get("tica_evecs") is not None:
            self.tica_evecs = np.asarray(self.architecture["tica_evecs"])

    def _output_layer(self) -> Optional[np.ndarray]:
        return self.tica_evecs

    def plot_training_metrics(self) -> None:
        super().plot_training_metrics()
        if self.eigenvalues_ is not None:
            np.savetxt(os.path.join(str(self.training_output_folder), "eigenvalues.txt"),
                       np.asarray(self.eigenvalues_), fmt="%.7g")
        self._plot_curves([
            ([f"valid_eigval_{i + 1}" for i in range(self.cv_dimension)],
             [f"Eigenvalue {i + 1}" for i in range(self.cv_dimension)],
             "eigenvalues.png", "linear"),
        ])


def weighted_mean(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Per try, the mean of (T, B) values over the rows of weight 1 (padded
    rows of a ragged batch weigh 0): (T,)."""
    return (values * weights).sum(-1) / weights.sum(-1).clamp_min(1e-12)


class AECalculator(NonLinear):
    """Autoencoder CV (cf. reference cv_calculator.py:2386-2505): the
    encoder's latent, trained by the decoder's reconstruction MSE of the
    normalized input."""

    def __init__(self, configuration=None, output_path=None, device: DeviceLike = None):
        super().__init__(configuration, output_path, device)
        self.cv_name = "ae"

    def build_architecture_dict(self) -> Dict:
        mean, rng = self._norm_lists()
        return {
            "kind": "ae",
            "encoder_layers": [self.num_features] + self.encoder_hidden_layers
            + [self.cv_dimension],
            "decoder_layers": [self.cv_dimension] + self._mirrored_decoder_hidden()
            + [self.num_features],
            "encoder_options": self._layer_options(self.encoder_config),
            "decoder_options": self._layer_options(self._decoder_source(),
                                                   is_decoder=True),
            "norm_mean": mean,
            "norm_range": rng,
            "post_mean": None,
            "post_range": None,
        }

    def loss_fn(self, params, batch, generators, beta, train=True):
        """Reconstruction MSE per try; train=False (validation) turns
        dropout off."""
        x_hat, xn = self.module.reconstruct(params, batch["data"], train, generators)
        return weighted_mean(((x_hat - xn) ** 2).mean(-1), batch["weight"]), {}


class VAECalculator(NonLinear):
    """Variational autoencoder CV (cf. reference cv_calculator.py:2629-2949):
    the latent mean, trained by the ELBO (reconstruction MSE + beta KL)
    under KL annealing; the best model is taken after the annealing."""

    def __init__(self, configuration=None, output_path=None, device: DeviceLike = None):
        super().__init__(configuration, output_path, device)
        self.cv_name = "vae"
        kl_cfg = self.training_config.get("kl_annealing")
        if kl_cfg is not None:
            self._kl = KLAnnealing(
                type=kl_cfg.get("type", "linear"),
                start_beta=kl_cfg.get("start_beta", 1e-6),
                max_beta=kl_cfg.get("max_beta", 0.01),
                start_epoch=kl_cfg.get("start_epoch", self.max_epochs // 2),
                n_cycles=kl_cfg.get("n_cycles", 4),
                n_epochs_anneal=kl_cfg.get("n_epochs_anneal", self.max_epochs // 4),
            )
        else:
            # the reference's defaults (cf. cv_calculator.py:2654-2661)
            self._kl = KLAnnealing(
                type="sigmoid", start_beta=1e-6, max_beta=0.01,
                start_epoch=self.max_epochs // 2, n_cycles=1,
                n_epochs_anneal=self.max_epochs // 4,
            )

    def kl_annealing_schedule(self) -> KLAnnealing:
        return self._kl

    def uses_post_annealing(self) -> bool:
        return self._kl.n_epochs_anneal > 0

    def build_architecture_dict(self) -> Dict:
        mean, rng = self._norm_lists()
        # the hidden stack keeps the user's per-layer options as they are
        # (cf. reference set_up_encoder_last_layer special-casing the VAE)
        return {
            "kind": "vae",
            "n_cvs": self.cv_dimension,
            "encoder_layers": [self.num_features] + self.encoder_hidden_layers,
            "decoder_layers": self._mirrored_decoder_hidden() + [self.num_features],
            "encoder_options": {
                key: list(self.encoder_config.get(key) or [])
                for key in ("activation", "dropout", "batchnorm")
            },
            "decoder_options": self._layer_options(self._decoder_source(),
                                                   is_decoder=True),
            "norm_mean": mean,
            "norm_range": rng,
            "post_mean": None,
            "post_range": None,
        }

    def loss_fn(self, params, batch, generators, beta, train=True):
        """ELBO per try, with its two parts as metrics; train=False
        (validation) turns dropout off, the latent sample stays random, as
        in mlcolvar."""
        recon, kl = self.module.elbo_parts(params, batch["data"], generators, train)
        recon_m = weighted_mean(recon, batch["weight"])
        kl_m = weighted_mean(kl, batch["weight"])
        return recon_m + beta * kl_m, {"reconstruction_loss": recon_m, "kl_loss": kl_m}

    def plot_training_metrics(self) -> None:
        super().plot_training_metrics()
        self._plot_curves([
            (["valid_kl_loss"], ["Validation KL"], "vae_kl_loss.png", "log"),
            (["valid_reconstruction_loss"], ["Validation Reconstruction"],
             "vae_reconstruction_loss.png", "log"),
            (["beta"], ["Beta"], "vae_beta.png", "linear"),
        ])
