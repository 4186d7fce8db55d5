"""Deep-CV training engine (PyTorch): the port of the JAX package's
models/training.py.

Kept 1:1 from the JAX side: the seeded batch orders (numpy
`default_rng(seed)`, so both packages see the same batches), early
stopping on the validation loss, the checkpoint cadence and its
misalignment fallback, best / last / post-annealing model selection, KL
annealing, the optax optimizer chains, optax's one-cycle schedule and the
host-side ReduceLROnPlateau.

All seeded tries train as one batched program: parameters carry a leading
tries axis T (see `models/networks.py`), the dataset is held once on the
device and gathered per try with global row indices, and every step
updates all tries together. Each loop turn is one epoch: its batch indices
go up once, and its losses come back in one read of the host. `Trainer.fit`
is the same program with T = 1. With a mesh of n devices that divides T
(`parallel.mesh.mesh_for`, set by the caller's `use_mesh`), each device
holds T / n of the tries, their optimizer state and a copy of the
dataset, and its worker thread (`parallel.mesh.run_per_device`) runs the
epoch's steps on them with no collective; results come back in try order.

The optimizers are written out on the stacked tensors, following optax's
formulas, because torch's differ: RMSprop's epsilon sits inside the square
root, AdamW's weight decay is whatever the config passes, OneCycle is
optax's cosine schedule of the update count (torch's `OneCycleLR` moves its
phase boundaries by one step and cycles Adam's beta1).
"""

from __future__ import annotations

import logging
import math
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deep_cartograph_torch.parallel.mesh import Mesh, mesh_for, run_per_device
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device
from deep_cartograph_torch.utils.profiling import annotate

logger = logging.getLogger(__name__)

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Optimizers and schedules (optax's formulas, on stacked tensors)
# ---------------------------------------------------------------------------

class Optimizer:
    """torch.optim-style optimizer names -> the optax chains of the JAX
    package's `make_optimizer`, as updates u with p <- p - lr * u.

    weight_decay follows torch's L2-in-gradient convention for Adam, SGD and
    RMSprop (optax `add_decayed_weights` before the core); AdamW decays
    decoupled (optax `adamw`, which takes only the learning rate and the
    weight decay from the config)."""

    def __init__(self, name: str, kwargs: Optional[Dict] = None):
        kwargs = dict(kwargs or {})
        self.name = name.lower()
        self.weight_decay = float(kwargs.pop("weight_decay", 0.0))
        kwargs.pop("lr", None)
        betas = kwargs.get("betas", (0.9, 0.999))
        if self.name == "adam":
            self.b1, self.b2 = betas
            self.eps = kwargs.get("eps", 1e-8)
        elif self.name == "adamw":
            self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        elif self.name == "sgd":
            self.momentum = kwargs.get("momentum", 0.0)
            self.nesterov = kwargs.get("nesterov", False)
        elif self.name == "rmsprop":
            self.decay = kwargs.get("alpha", 0.99)
            self.eps = kwargs.get("eps", 1e-8)
        else:
            raise ValueError(f"Optimizer {name} not recognized.")

    def init(self, params: Params) -> Dict:
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}  # noqa: E731
        if self.name in ("adam", "adamw"):
            return {"count": 0, "mu": zeros(), "nu": zeros()}
        if self.name == "sgd":
            return {"trace": zeros()} if self.momentum else {}
        return {"nu": zeros()}

    @torch.no_grad()
    def step(self, params: Params, grads: Params, state: Dict,
             lr: torch.Tensor) -> None:
        """One update of every try in place; `lr` is (T,), one rate per
        try."""
        if self.name in ("adam", "adamw"):
            state["count"] += 1
            # bias corrections in float32, as optax computes them
            count = np.float32(state["count"])
            bc1 = np.float32(1) - np.float32(self.b1) ** count
            bc2 = np.float32(1) - np.float32(self.b2) ** count
        for k, p in params.items():
            g = grads[k]
            if self.weight_decay and self.name != "adamw":
                g = g + self.weight_decay * p
            if self.name in ("adam", "adamw"):
                mu = state["mu"][k]
                nu = state["nu"][k]
                mu.copy_((1 - self.b1) * g + self.b1 * mu)
                nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                if self.name == "adamw" and self.weight_decay:
                    u = u + self.weight_decay * p
            elif self.name == "sgd":
                if self.momentum:
                    trace = state["trace"][k]
                    trace.copy_(g + self.momentum * trace)
                    u = g + self.momentum * trace if self.nesterov else trace
                else:
                    u = g
            else:
                nu = state["nu"][k]
                nu.copy_((1 - self.decay) * (g * g) + self.decay * nu)
                u = g * torch.rsqrt(nu + self.eps)
            p.add_(u * (-lr).view((-1,) + (1,) * (p.dim() - 1)))


def one_cycle_schedule(max_lr: float, total_steps: int, **kwargs) -> Callable[[int], float]:
    """optax's `cosine_onecycle_schedule` (the JAX package's stand-in for
    torch's OneCycleLR): cosine from max_lr/div_factor up to max_lr over
    int(pct_start * total) updates, then down to
    max_lr/(div_factor * final_div_factor) at `total`; evaluated in float32
    like optax."""
    total = max(int(total_steps), 1)
    div = kwargs.get("div_factor", 25.0)
    final_div = kwargs.get("final_div_factor", 1e4)
    bounds = np.array([0, int(kwargs.get("pct_start", 0.3) * total), total])
    values = np.cumprod([max_lr / div, div, 1.0 / (div * final_div)])
    sizes = (bounds[1:] - bounds[:-1]).astype(np.float32)

    def schedule(count: int) -> float:
        count = np.int32(count)
        start, end = values[:-1].astype(np.float32), values[1:].astype(np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            # an empty phase gives NaN here, as in optax
            pct = ((count - bounds[:-1]).astype(np.float32) / sizes).astype(np.float32)
            interp = end + (start - end) / np.float32(2) * (
                np.cos(np.float32(np.pi) * pct) + np.float32(1))
        inside = (bounds[:-1] <= count) & (count < bounds[1:])
        return float(np.float32(inside.astype(np.float32).dot(interp)
                                + np.float32(bounds[-1] <= count) * values[-1]))

    return schedule


class ReduceLROnPlateau:
    """Host-side ReduceLROnPlateau with a delayed start (the reference
    combines torch's scheduler with an LROnPlateauManager callback,
    ml.py:243-273); the JAX package's class, unchanged."""

    def __init__(
        self,
        factor: float = 0.1,
        patience: int = 10,
        cooldown: int = 0,
        min_lr: float = 0.0,
        threshold: float = 1e-4,
        start_epoch: int = 0,
    ):
        self.factor = factor
        self.patience = patience
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.threshold = threshold
        self.start_epoch = start_epoch
        self.best = math.inf
        self.num_bad = 0
        self.cooldown_counter = 0
        self.scale = 1.0

    def step(self, epoch: int, valid_loss: float) -> float:
        if epoch < self.start_epoch:
            return self.scale
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if valid_loss < self.best * (1 - self.threshold):
            self.best = valid_loss
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.scale = max(self.scale * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        return self.scale


# ---------------------------------------------------------------------------
# KL annealing (cf. reference modules/ml/ml.py:51-241)
# ---------------------------------------------------------------------------

@dataclass
class KLAnnealing:
    type: str = "linear"
    start_beta: float = 0.0
    max_beta: float = 0.01
    start_epoch: int = 1000
    n_cycles: int = 4
    n_epochs_anneal: int = 1000

    def beta(self, current_epoch: int) -> float:
        if current_epoch <= self.start_epoch:
            return self.start_beta
        epoch = current_epoch - self.start_epoch
        if self.type == "linear":
            return self._linear(epoch, self.n_epochs_anneal)
        if self.type == "sigmoid":
            return self._sigmoid(epoch, self.n_epochs_anneal)
        if self.type == "cyclical":
            return self._cyclical(epoch, self.n_epochs_anneal)
        raise ValueError(f"Invalid KL annealing type {self.type}")

    def _linear(self, epoch: int, n_epochs: int) -> float:
        if epoch >= n_epochs:
            return self.max_beta
        return self.start_beta + (self.max_beta - self.start_beta) * (
            epoch / n_epochs
        )

    def _cyclical(self, epoch: int, n_epochs: int) -> float:
        if epoch >= n_epochs:
            return self.max_beta
        cycle_length = max(n_epochs // self.n_cycles, 1)
        return self._linear(epoch % cycle_length, max(cycle_length // 2, 1))

    def _sigmoid(self, epoch: int, n_epochs: int) -> float:
        eps = 1e-3
        midpoint = self.start_epoch + n_epochs // 2
        denom = self.start_epoch - midpoint
        steepness = np.log(eps / (1 - eps)) / denom if denom != 0 else 1.0
        e = epoch + self.start_epoch
        return self.start_beta + (self.max_beta - self.start_beta) / (
            1 + np.exp(-steepness * (e - midpoint))
        )

    @property
    def end_epoch(self) -> int:
        return self.start_epoch + self.n_epochs_anneal


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

@dataclass
class TrainerConfig:
    batch_size: int = 32
    max_epochs: int = 1000
    shuffle: bool = True
    check_val_every_n_epoch: int = 1
    # Checkpoint cadence (Lightning ModelCheckpoint every_n_epochs): the
    # best-model snapshot is only eligible on these epochs.
    save_check_every_n_epoch: int = 1
    early_stop_patience: int = 20
    early_stop_min_delta: float = 1e-5
    optimizer_name: str = "Adam"
    optimizer_kwargs: Dict = field(default_factory=dict)
    lr_scheduler: Optional[Dict] = None       # {'name': ..., 'kwargs': {...}}
    kl_annealing: Optional[KLAnnealing] = None
    model_to_save: str = "best"               # 'best' | 'last'
    # VAE: only checkpoint 'best' after KL annealing completes
    post_annealing_checkpoint: bool = False


@dataclass
class TrainResult:
    params: Params          # the try's parameters, without the tries axis
    score: float
    metrics: Dict[str, List]
    best_epoch: int
    description: str


def _make_batches(
    n: int, batch_size: int, shuffle: bool, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """(n_batches, batch_size) index array + weight mask (ragged tail padded
    with repeated index 0 at weight 0)."""
    order = rng.permutation(n) if shuffle else np.arange(n)
    n_batches = int(np.ceil(n / batch_size))
    padded = np.zeros(n_batches * batch_size, dtype=np.int32)
    weights = np.zeros(n_batches * batch_size, dtype=np.float32)
    padded[:n] = order
    weights[:n] = 1.0
    return (
        padded.reshape(n_batches, batch_size),
        weights.reshape(n_batches, batch_size),
    )


def _select(mask: np.ndarray, new: Params, old: Params) -> Params:
    """Per try: new where mask, else old (copies, never views)."""
    out = {}
    for k, v in new.items():
        m = torch.as_tensor(mask, device=v.device).view((-1,) + (1,) * (v.dim() - 1))
        out[k] = torch.where(m, v.detach(), old[k])
    return out


def _to_device(values, device: torch.device) -> torch.Tensor:
    """Data on the device; floating point as float32, as the JAX package
    holds it."""
    t = torch.as_tensor(values)
    return t.to(device, torch.float32) if t.is_floating_point() else t.to(device)


LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclass
class _Lane:
    """The tries that train on one device, and their state there."""

    device: torch.device
    tries: slice
    data: Dict[str, torch.Tensor] = field(default_factory=dict)
    valid_batch: Dict[str, torch.Tensor] = field(default_factory=dict)
    params: Params = field(default_factory=dict)
    opt_state: Dict = field(default_factory=dict)
    gens: List[torch.Generator] = field(default_factory=list)

# The name of each training step's span in a torch.profiler trace.
STEP_SPAN = "trainer.step"


@dataclass
class TrainStats:
    """Counters of the trainer (`Trainer.fit_ensemble`): the optimizer
    `steps` it ran (an epoch's steps once, however many lanes ran them),
    the `plateau_steps` among them whose KL weight beta had reached the
    annealing's `max_beta`, and the `post_annealing_selections`, tries
    whose returned model was chosen after the KL annealing. Callers reset
    them (`reset()`, or a field to 0) around a region they measure. The
    counts are taken under a lock: the mesh's worker threads may count at
    once."""

    steps: int = 0
    plateau_steps: int = 0
    post_annealing_selections: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def count_epoch(self, steps: int, beta: float, max_beta: Optional[float]) -> None:
        """Count one epoch's `steps`, all at the KL weight `beta`."""
        with self._lock:
            self.steps += steps
            self.plateau_steps += steps if max_beta is not None and beta == max_beta else 0

    def count_post_annealing(self, tries: int) -> None:
        with self._lock:
            self.post_annealing_selections += tries

    def reset(self) -> None:
        with self._lock:
            self.steps = self.plateau_steps = self.post_annealing_selections = 0


TRAIN_STATS = TrainStats()


class Trainer:
    """Seeded trainer over (dict of data arrays, loss function).

    loss_fn(params, batch, generators, beta, train) -> (loss (T,), aux: dict
    of (T,) tensors). `params` and every batch entry carry the tries axis
    first; the batch carries a (T, B) 'weight' mask for padded rows, which
    the loss must use. `generators` are one torch.Generator per try, on the
    device, for dropout and the VAE's noise; validation calls the loss with
    train=False (dropout off). `beta` is the epoch's KL weight (0 without
    KL annealing).
    """

    def __init__(self, loss_fn: LossFn, config: TrainerConfig,
                 device: DeviceLike = None):
        """`device`: None means CUDA (raises without a card); "cpu" runs on
        the host."""
        self.loss_fn = loss_fn
        self.config = config
        self.device = resolve_device(device)

    def _plateaus(self, n: int) -> Optional[List[ReduceLROnPlateau]]:
        """One host-side plateau scheduler per try, or None."""
        cfg = self.config
        if not (cfg.lr_scheduler and cfg.lr_scheduler.get("name", "") == "ReduceLROnPlateau"):
            return None
        kwargs = dict(cfg.lr_scheduler.get("kwargs", {}))
        return [ReduceLROnPlateau(
            factor=kwargs.get("factor", 0.1),
            patience=kwargs.get("patience", cfg.early_stop_patience // 4),
            cooldown=kwargs.get("cooldown", cfg.early_stop_patience // 8),
            min_lr=kwargs.get("min_lr", 0.0),
            start_epoch=kwargs.get("start_epoch", 0),
        ) for _ in range(n)]

    def _one_cycle(self, steps_per_epoch: int) -> Optional[Callable[[int], float]]:
        cfg = self.config
        if not cfg.lr_scheduler:
            return None
        name = cfg.lr_scheduler.get("name", "")
        if name == "ReduceLROnPlateau":
            return None
        if name != "OneCycleLR":
            raise ValueError(f"Learning rate scheduler {name} not recognized.")
        kwargs = dict(cfg.lr_scheduler.get("kwargs", {}))
        max_lr = kwargs.pop("max_lr", 1e-3)
        total = kwargs.pop("epochs", cfg.max_epochs) * kwargs.pop(
            "steps_per_epoch", steps_per_epoch
        )
        return one_cycle_schedule(max_lr, total, **kwargs)

    def fit(
        self,
        params: Params,
        train_data: Dict[str, np.ndarray],
        valid_data: Dict[str, np.ndarray],
        seed: int,
    ) -> TrainResult:
        """One try: `fit_ensemble` with T = 1 on the given split.
        `params` have no tries axis."""
        n_train = len(next(iter(train_data.values())))
        n_valid = len(next(iter(valid_data.values())))
        result = self.fit_ensemble(
            {k: torch.as_tensor(v)[None] for k, v in params.items()},
            train_data,
            np.arange(n_train, dtype=np.int32)[None],
            np.arange(n_valid, dtype=np.int32)[None],
            [seed],
            valid_data=valid_data,
        )[0]
        if result.description == "last":
            # the JAX package's fit() reports the last epoch of the budget,
            # even after an early stop
            result.best_epoch = self.config.max_epochs - 1
        return result

    @annotate("trainer.fit")
    def fit_ensemble(
        self,
        params_stack: Params,
        full_data: Dict[str, np.ndarray],
        train_idx: np.ndarray,  # (T, n_train) global indices
        valid_idx: np.ndarray,  # (T, n_valid) global indices into the valid source
        seeds: Sequence[int],
        valid_data: Optional[Dict[str, np.ndarray]] = None,
        index_offsets: Optional[Dict[str, int]] = None,
    ) -> List[TrainResult]:
        """Train all T seeded tries together.

        Per try, the batch order stream (numpy, seeded), the early
        stopping, checkpoint selection and plateau bookkeeping are those of
        the JAX package's `fit_ensemble`. valid_data defaults to full_data
        (random-split case). `index_offsets` maps data keys to a row offset
        added to every gather index for that key: zero-copy time-lagged
        batching, one (N, D) buffer passed as both "data" and "data_lag"
        with {"data_lag": lag} and indices in [0, N - lag). The offsets
        apply to the validation gather only when it reads full_data.
        """
        cfg = self.config
        T, n_train = train_idx.shape
        n_valid = valid_idx.shape[1]
        steps = int(np.ceil(n_train / cfg.batch_size))
        off = dict(index_offsets or {})
        voff = off if valid_data is None else {}
        train_idx = np.asarray(train_idx, np.int64)
        mesh, lanes = self._lanes(T)

        # The dataset once per device; each lane holds its tries' validation
        # rows, parameters, optimizer state and generators. Each device's
        # worker copies its own (`parallel.mesh.run_per_device`).
        def place(dev):
            data = {k: _to_device(v, dev) for k, v in full_data.items()}
            return data, (data if valid_data is None else
                          {k: _to_device(v, dev) for k, v in valid_data.items()})

        devices = list(dict.fromkeys(mesh.devices))
        optimizer = Optimizer(cfg.optimizer_name, cfg.optimizer_kwargs)

        def set_up(dev, lane):
            lane.data, vdata = placed[dev]
            vidx = torch.as_tensor(np.asarray(valid_idx, np.int64)[lane.tries], device=dev)
            lane.valid_batch = {k: v[vidx + voff.get(k, 0)] for k, v in vdata.items()}
            lane.valid_batch["weight"] = torch.ones(vidx.shape, device=dev)
            lane.params = {k: v[lane.tries].detach().to(dev, torch.float32)
                           .clone().requires_grad_(True) for k, v in params_stack.items()}
            lane.gens = [torch.Generator(device=dev).manual_seed(int(s))
                         for s in list(seeds)[lane.tries]]
            lane.opt_state = optimizer.init(lane.params)

        with annotate("trainer.place"):
            placed = dict(zip(devices, run_per_device(place, Mesh(devices))))
            run_per_device(set_up, mesh, lanes)
        base_lr = cfg.optimizer_kwargs.get("lr", 1e-3)
        schedule = self._one_cycle(steps)
        plateaus = self._plateaus(T)
        np_rngs = [np.random.default_rng(s) for s in seeds]

        metrics: List[Dict[str, List]] = [
            {"epoch": [], "train_loss": [], "valid_loss": [], "lr": []}
            for _ in range(T)
        ]
        if cfg.kl_annealing is not None:
            for m in metrics:
                m["beta"] = []

        def snapshot():
            return [{k: v.detach().clone() for k, v in lane.params.items()} for lane in lanes]

        def select(mask, new, old):
            return [_select(mask[lane.tries], n, o) for lane, n, o in zip(lanes, new, old)]

        def current():
            return [lane.params for lane in lanes]

        best_score = np.full(T, np.inf)
        es_best = np.full(T, np.inf)
        best_params = snapshot()
        best_epoch = np.full(T, -1, np.int64)
        post_best_score = np.full(T, np.inf)
        post_best_params = best_params
        post_has_best = np.zeros(T, bool)
        post_best_epoch = np.full(T, -1, np.int64)
        bad_checks = np.zeros(T, np.int64)
        stopped = np.zeros(T, bool)
        last_valid = np.full(T, np.inf)
        last_epoch = np.full(T, cfg.max_epochs - 1, np.int64)
        last_params = best_params
        anneal_end = (
            cfg.kl_annealing.end_epoch if cfg.kl_annealing is not None else 0
        )
        save_every = max(cfg.save_check_every_n_epoch, 1)
        check_every = max(cfg.check_val_every_n_epoch, 1)
        save_misaligned = math.lcm(save_every, check_every) > cfg.max_epochs
        if save_misaligned:
            # Validation epochs never (within max_epochs) land on the save
            # grid: checkpoint at every validation instead.
            logger.warning(
                "save_check_every_n_epoch=%d never aligns with "
                "check_val_every_n_epoch=%d within %d epochs; "
                "checkpointing at every validation instead.",
                cfg.save_check_every_n_epoch, cfg.check_val_every_n_epoch,
                cfg.max_epochs,
            )
        lr_tries = np.full(T, base_lr, np.float32)

        for epoch in range(cfg.max_epochs):
            if stopped.all():
                break
            with annotate("trainer.epoch_setup"):
                beta = (cfg.kl_annealing.beta(epoch)
                        if cfg.kl_annealing is not None else 0.0)
                gb = np.empty((T, steps, cfg.batch_size), np.int64)
                wb = np.empty((T, steps, cfg.batch_size), np.float32)
                for t in range(T):
                    batches, weights = _make_batches(
                        n_train, cfg.batch_size, cfg.shuffle, np_rngs[t]
                    )
                    gb[t] = train_idx[t][batches]
                    wb[t] = weights
                if schedule is not None:
                    lrs = np.array(
                        [schedule(epoch * steps + s) for s in range(steps)], np.float32
                    )[:, None].repeat(T, 1)
                else:
                    lrs = lr_tries[None].repeat(steps, 0)
            validate = (epoch + 1) % check_every == 0

            def run_epoch(dev, lane):
                """The lane's steps of the epoch, then, at a validation
                epoch, its (2 + aux, tries) losses on the host."""
                with annotate("trainer.epoch_setup"):
                    gb_d = torch.as_tensor(gb[lane.tries], device=dev)
                    wb_d = torch.as_tensor(wb[lane.tries], device=dev)
                    lrs_d = torch.as_tensor(lrs[:, lane.tries], device=dev)
                    loss_sum = torch.zeros(gb_d.shape[0], device=dev)
                for s in range(steps):
                    with annotate(STEP_SPAN):
                        idx = gb_d[:, s]
                        batch = {k: v[idx + off.get(k, 0)] for k, v in lane.data.items()}
                        batch["weight"] = wb_d[:, s]
                        with annotate("trainer.forward"):
                            loss, _ = self.loss_fn(lane.params, batch, lane.gens, beta, True)
                        with annotate("trainer.backward"):
                            grads = torch.autograd.grad(loss.sum(),
                                                        list(lane.params.values()))
                        with annotate("trainer.optimizer"):
                            optimizer.step(lane.params, dict(zip(lane.params, grads)),
                                           lane.opt_state, lrs_d[s])
                        loss_sum += loss.detach()
                if not validate:
                    return None
                with annotate("trainer.validate"), torch.no_grad():
                    valid_loss, valid_aux = self.loss_fn(
                        lane.params, lane.valid_batch, lane.gens, beta, False
                    )
                    return list(valid_aux), torch.stack(
                        [loss_sum / steps, valid_loss] + list(valid_aux.values())
                    ).cpu().numpy().astype(np.float64)

            ran = run_per_device(run_epoch, mesh, lanes)
            TRAIN_STATS.count_epoch(steps, beta, None if cfg.kl_annealing is None
                                    else cfg.kl_annealing.max_beta)
            if not validate:
                continue
            aux_keys = ran[0][0]
            parts = [part for _, part in ran]
            host = np.concatenate(parts, axis=1)
            tl_host, vl_host = host[0], host[1]
            if schedule is not None:
                # the rate of the epoch's last update, as the JAX side reads it
                lr_arr = np.full(T, schedule((epoch + 1) * steps - 1))
            elif plateaus is not None:
                lr_arr = np.array([base_lr * p.scale for p in plateaus])
            else:
                lr_arr = np.full(T, base_lr)

            active = ~stopped
            for t in np.nonzero(active)[0]:
                last_valid[t] = vl_host[t]
                metrics[t]["epoch"].append(epoch)
                metrics[t]["train_loss"].append(float(tl_host[t]))
                metrics[t]["valid_loss"].append(float(vl_host[t]))
                metrics[t]["lr"].append(float(lr_arr[t]))
                if cfg.kl_annealing is not None:
                    metrics[t]["beta"].append(beta)
                for j, k in enumerate(aux_keys):
                    metrics[t].setdefault(f"valid_{k}", []).append(float(host[2 + j, t]))

            improved = vl_host < es_best - cfg.early_stop_min_delta
            es_best = np.where(active & improved, vl_host, es_best)
            bad_checks = np.where(
                active, np.where(improved, 0, bad_checks + 1), bad_checks
            )

            save_eligible = save_misaligned or (epoch + 1) % save_every == 0
            if save_eligible:
                cap = active & (vl_host < best_score)
                if cap.any():
                    best_params = select(cap, current(), best_params)
                    best_score = np.where(cap, vl_host, best_score)
                    best_epoch = np.where(cap, epoch, best_epoch)
                if cfg.post_annealing_checkpoint and epoch >= anneal_end:
                    pcap = active & (vl_host < post_best_score)
                    if pcap.any():
                        post_best_params = select(pcap, current(), post_best_params)
                        post_best_score = np.where(pcap, vl_host, post_best_score)
                        post_best_epoch = np.where(pcap, epoch, post_best_epoch)
                        post_has_best |= pcap

            if plateaus is not None:
                for t in range(T):
                    if active[t]:
                        plateaus[t].step(epoch, float(vl_host[t]))
                lr_tries = np.array(
                    [base_lr * p.scale for p in plateaus], np.float32
                )

            newly_stopped = ~stopped & (bad_checks >= cfg.early_stop_patience)
            if newly_stopped.any():
                # Freeze each stopping try's "last" params at ITS stop epoch.
                last_params = select(newly_stopped, current(), last_params)
                last_epoch = np.where(newly_stopped, epoch, last_epoch)
                stopped |= newly_stopped

        if (~stopped).any():
            last_params = select(~stopped, current(), last_params)

        # Results in try order, gathered from the lanes to the trainer's
        # device.
        where = [(li, j) for li, lane in enumerate(lanes)
                 for j in range(lane.tries.stop - lane.tries.start)]
        results: List[TrainResult] = []
        for t in range(T):
            li, j = where[t]

            def take(trees):
                return {k: v[j].to(self.device, copy=True) for k, v in trees[li].items()}

            if cfg.post_annealing_checkpoint and post_has_best[t]:
                TRAIN_STATS.count_post_annealing(1)
                results.append(TrainResult(
                    take(post_best_params), float(post_best_score[t]),
                    metrics[t], int(post_best_epoch[t]), "best post-annealing",
                ))
            elif cfg.model_to_save == "best" and best_epoch[t] >= 0:
                results.append(TrainResult(
                    take(best_params), float(best_score[t]), metrics[t],
                    int(best_epoch[t]), "best overall",
                ))
            else:
                results.append(TrainResult(
                    take(last_params), float(last_valid[t]), metrics[t],
                    int(last_epoch[t]), "last",
                ))
        return results

    def _lanes(self, T: int) -> Tuple[Mesh, List["_Lane"]]:
        """The mesh the T tries train on and its lanes: with a mesh that
        divides T (`parallel.mesh.mesh_for`), T / n
        contiguous tries on each of its n devices, with no collective; else
        all on the trainer's device."""
        mesh = mesh_for(self.device)
        if T % len(mesh):
            mesh = Mesh((self.device,))
        if len(mesh) > 1:
            logger.info("Sharding %d training tries over %d devices.", T, len(mesh))
        per = T // len(mesh)
        return mesh, [_Lane(dev, slice(i * per, (i + 1) * per))
                      for i, dev in enumerate(mesh.devices)]
