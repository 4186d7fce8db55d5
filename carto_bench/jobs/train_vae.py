"""Train the VAE: `VAECalculator.train()` on a feature matrix handed over
as `train_colvars` hands it, one call of the mix's epochs a call, with the
configuration `train_colvars` resolves for `cvs: ['vae']` from the
configuration's `train_colvars.common` block (`cv`). Each call's epoch
stands for the published schedule's `timed_epoch`: the job moves the KL
annealing's `start_epoch` back by it, so beta is at `max_beta` in every
step and the post-annealing selection picks the call's model.

Set-up builds the one calculator the window drives and runs its first
call. Every call runs with the optimizer, the loss and the noise observed:
the first steps' losses, reconstructions and KL terms, the optimizer's
first moment after step 1 (the first gradient), the parameters before step
1 and after the last observed step, the steps at another beta than
`max_beta`, and the noise the call's validation drew. The check takes the
last call the run made. The reference (`reference_vae.py`, float64) works
the first steps out again from the seed (initial parameters, split, batch
order, dropout masks and noise) and checks the stage after them from the
program's own final parameters: each try's validation reconstruction and
KL with the noise the program drew, and the CV (the latent mean) on every
frame. The program's trainer counter (`training.TRAIN_STATS`) gives the
steps at another beta and the tries chosen without the post-annealing
selection, over every call after set-up; a program without the counter is
read from the job's own record of the same.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.profiler import record_function

from carto_bench import reference, reference_vae, synth
from carto_bench.jobs.common import REFERENCE_BLOCK_FRAMES, inputs_made
from carto_bench.jobs.train import Job as TrainJob

OPTION_KEYS = ("activation", "dropout", "batchnorm")
POST_ANNEALING = "best post-annealing"


def calculator_config(config: dict, max_epochs: int) -> dict:
    """The VAE configuration `train_colvars` builds from the
    configuration's `train_colvars.common` block, with the mix's epochs and
    the annealing moved so that epoch 0 is the published `timed_epoch`."""
    from deep_cartograph_torch.config.schemas import cv_configuration, train_colvars_config

    cfg = cv_configuration(train_colvars_config({"common": config["cv"]}), "vae")
    kl = cfg["training"]["kl_annealing"]
    kl["start_epoch"] = int(kl["start_epoch"]) - int(config["timed_epoch"])
    cfg["training"]["general"]["max_epochs"] = int(max_epochs)
    cfg["training"]["plot_loss"] = False
    return cfg


def resolved_options(config: dict, calc) -> dict:
    """The encoder's and decoder's per-layer options and the widths as
    the configuration states them resolved, after making sure that the
    program resolves them alike: the reference reads the stated ones."""
    from deep_cartograph_torch.models.networks import stack_from_architecture

    module = stack_from_architecture(calc.build_architecture_dict())
    got = {"encoder": {k: module.encoder_options[k] for k in OPTION_KEYS},
           "decoder": {k: module.decoder_options[k] for k in OPTION_KEYS}}
    stated = {"encoder": config["encoder_resolved"], "decoder": config["decoder_resolved"]}
    differ = [f"{block}.{k}" for block in stated for k in OPTION_KEYS
              if got[block][k] != stated[block][k]]
    if calc.feats_norm_mode != config["features_normalization_resolved"]:
        differ.append("features_normalization")
    if differ:
        raise RuntimeError(f"train_colvars resolves {', '.join(differ)} otherwise than the "
                           f"configuration states: {got}, {calc.feats_norm_mode!r}")
    return {**stated, "encoder_layers": module.encoder_layers,
            "decoder_layers": module.decoder_layers}


def observe_first_steps(calc, steps: int, max_beta: float):
    """calc.train() with its optimizer's and loss's first `steps` steps,
    the steps at another beta than `max_beta` and the last noise drawn (the
    validation's) recorded: (train's result, the record)."""
    import deep_cartograph_torch.models.training as training
    from deep_cartograph_torch.models import networks

    rec = {"losses": [], "recon": [], "kl": [], "off_beta_steps": 0}
    base, draw, loss_fn = training.Optimizer, networks.reparam_noise, calc.loss_fn

    class Observed(base):
        calls = 0

        def step(self, params, grads, state, lr):
            if Observed.calls == 0:
                rec["params0"] = {k: v.detach().clone() for k, v in params.items()}
            super().step(params, grads, state, lr)
            Observed.calls += 1
            if Observed.calls == 1:
                rec["mu1"] = {k: v.clone() for k, v in state["mu"].items()}
                rec["b1"] = self.b1
            if Observed.calls == steps:
                rec["params"] = {k: v.detach().clone() for k, v in params.items()}

    def recording(params, batch, generators, beta, train=True):
        loss, aux = loss_fn(params, batch, generators, beta, train)
        if train:
            rec["off_beta_steps"] += int(beta != max_beta)
            if len(rec["losses"]) < steps:
                rec["losses"].append(loss.detach().clone())
                rec["recon"].append(aux["reconstruction_loss"].detach().clone())
                rec["kl"].append(aux["kl_loss"].detach().clone())
        return loss, aux

    def noted(shape, generators):
        rec["eps"] = draw(shape, generators)
        return rec["eps"]

    training.Optimizer, networks.reparam_noise = Observed, noted
    calc.loss_fn = recording
    try:
        ok = calc.train()
    finally:
        training.Optimizer, networks.reparam_noise = base, draw
        del calc.loss_fn
    return ok, rec


def train_stats():
    """The program's trainer counter, or None for a program without it."""
    import deep_cartograph_torch.models.training as training

    return getattr(training, "TRAIN_STATS", None)


class Job:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        from deep_cartograph_torch.cv.deep import VAECalculator

        self.mix, self.device = mix, torch.device(device)
        self.mol = mol = synth.Molecule.from_config(config)
        coords = synth.trajectory(config, int(config["frames"]), seed, device)
        self.x = (reference.features(coords, mol.ca_index, mol.pairs, mol.quads)
                  .float().cpu().numpy())
        del coords
        inputs_made(device)
        self.cfg = calculator_config(config, mix["max_epochs"])
        self.calc = VAECalculator(self.cfg, device=device)
        self.calc._set_training_data(self.x, np.zeros(len(self.x), np.int64), mol.labels())
        self.options = resolved_options(config, self.calc)
        if self.calc.feats_norm_mode is not None:
            raise ValueError("the job checks a configuration that normalizes no feature")
        general = self.cfg["training"]["general"]
        self.n_cvs = int(self.cfg["dimension"])
        self.plan = reference_vae.layer_plan(mol.n_features, self.options["encoder_layers"][1:],
                                             self.n_cvs, self.options["decoder_layers"][1:-1])
        self.seeds = [general["seed"] + t for t in range(1, general["num_tries"] + 1)]
        self.batch = int(general["batch_size"])
        self.n_train = int(len(self.x) * general["lengths"][0])
        self.steps_per_call = int(mix["max_epochs"]) * math.ceil(self.n_train / self.batch)
        self.observed_steps = int(mix["check_steps"])
        self.max_beta = float(self.cfg["training"]["kl_annealing"]["max_beta"])
        self.lr = float(self.cfg["training"]["optimizer"]["kwargs"]["lr"])
        self.final = None
        self.calls = self.off_beta_steps = self.selections = 0
        self.call(-1)
        # what the counters and the job's own record cover: every call after set-up
        self.calls = self.off_beta_steps = self.selections = 0
        if train_stats() is not None:
            train_stats().reset()

    def call(self, i: int) -> dict:
        with record_function("bench.train"):
            ok, self.record = observe_first_steps(self.calc, self.observed_steps, self.max_beta)
        self.calls += 1
        self.off_beta_steps += self.record["off_beta_steps"]
        self.selections += sum(r.description == POST_ANNEALING for _, r in self.calc.try_results)
        return {"steps": self.steps_per_call, "failed": not ok}

    def end_to_end(self, window) -> dict:
        return {"train_step_ms": 1e3 * window.seconds / window.total("steps")}

    def prepare_control(self) -> None:
        pass

    def release(self) -> None:
        """Keep what the last call left for the check, then free the rest."""
        self.final = self.program_final()
        self.calc = None

    def program_final(self) -> dict:
        """The stage after the steps as the program left it: each try's
        final parameters and validation reconstruction and KL, the noise its
        validation drew, and the CV of every frame."""
        calc = self.calc
        results = [r for _, r in getattr(calc, "try_results", [])]
        eps = self.record.get("eps")
        if len(results) != len(self.seeds) or calc.params is None or eps is None:
            return {}
        with torch.no_grad():
            return {"params": [{k: v.detach().clone() for k, v in r.params.items()}
                               for r in results],
                    "valid_recon": [r.metrics["valid_reconstruction_loss"][-1] for r in results],
                    "valid_kl": [r.metrics["valid_kl_loss"][-1] for r in results],
                    "eps": eps.detach().clone(),
                    "chosen": {k: v.detach().clone() for k, v in calc.params.items()},
                    "cv": np.asarray(calc.latent(self.x), np.float64)}

    # ------------------------------------------------------------------
    def reference_steps(self, p: "reference.Precision", keep_rows: float = 1.0,
                        beta: float = None, zero_eps: bool = False) -> dict:
        """The first steps worked out again from the data and the seed."""
        enc, dec = self.options["encoder"], self.options["decoder"]
        x = torch.as_tensor(self.x, device=self.device)
        batches = reference.first_batches(len(self.x), self.cfg["training"]["general"]
                                          ["lengths"][0], self.batch, self.seeds,
                                          self.observed_steps)
        step_draws = reference_vae.draws(self.batch, self.seeds, self.n_cvs,
                                         self.options["encoder_layers"][1:], enc["dropout"],
                                         self.options["decoder_layers"][1:], dec["dropout"],
                                         self.observed_steps, self.device)
        params = {k: v.to(self.device) for k, v in
                  reference_vae.initial_params(self.plan, self.seeds, torch.float32).items()}
        with p.scope():
            out = reference_vae.adam_steps(
                x, None, params, batches, step_draws, self.options,
                self.max_beta if beta is None else beta, self.lr, p=p, keep_rows=keep_rows,
                zero_eps=zero_eps)
        out["params0"] = {k: v.to(self.device) for k, v in reference_vae.initial_params(
            self.plan, self.seeds, torch.float64).items()}
        out["off_beta_steps"] = 0 if beta is None or beta == self.max_beta else self.observed_steps
        return out

    def step_gaps(self, got: dict, ref: dict) -> dict:
        """Each of the first steps' loss, reconstruction and KL gaps
        (largest over steps and tries), and the first gradient's worst leaf
        and the change's median leaf as `jobs/train.py` defines them."""
        if not got:
            return {}
        out = {f"{k}_gap": float((got[k].double() - ref[k].double()).abs().max())
               for k in ("recon", "kl")}
        leaves = TrainJob.gaps(self, got, ref)
        out.update({k: leaves[k] for k in ("loss_gap", "grad_gap", "grad_worst_leaf",
                                           "change_median_gap", "change_gap",
                                           "change_worst_leaf")})
        return out

    def program_steps(self) -> dict:
        rec = self.record
        if len(rec["losses"]) < self.observed_steps or "params" not in rec:
            return {}
        return {"losses": torch.stack(rec["losses"]), "recon": torch.stack(rec["recon"]),
                "kl": torch.stack(rec["kl"]),
                "first_grad": {k: v / (1 - rec["b1"]) for k, v in rec["mu1"].items()},
                "params0": rec["params0"], "params": rec["params"]}

    def reference_stage(self, final: dict, p: "reference.Precision",
                        zero_eps: bool = False) -> dict:
        """The stage after the steps from the program's final parameters:
        each try's validation reconstruction and KL (its split from its
        seed, no dropout, the noise the program's validation drew) and the
        CV of every frame from the chosen parameters, computed in blocks."""
        n_total = len(self.x)
        x = torch.as_tensor(self.x, device=self.device)
        eps = torch.zeros_like(final["eps"]) if zero_eps else final["eps"]

        def weights(tree):
            return {k: v.to(self.device, p.dtype) for k, v in tree.items()}

        recon, kl = [], []
        with p.scope(), torch.no_grad():
            for t, seed in enumerate(self.seeds):
                valid = torch.as_tensor(
                    np.random.default_rng(seed).permutation(n_total)[self.n_train:],
                    device=self.device)
                w = {k: v.unsqueeze(0) for k, v in weights(final["params"][t]).items()}
                r, k = reference_vae.elbo_parts(w, x[valid].unsqueeze(0), None, self.options,
                                                eps[t:t + 1], p=p)
                recon.append(float(r.mean()))
                kl.append(float(k.mean()))
            w = {k: v.unsqueeze(0) for k, v in weights(final["chosen"]).items()}
            cv = torch.cat([reference_vae.latent_mean(w, x[a:a + REFERENCE_BLOCK_FRAMES]
                                                      .unsqueeze(0), None, self.options, p)[0]
                            for a in range(0, n_total, REFERENCE_BLOCK_FRAMES)])
        return {"valid_recon": recon, "valid_kl": kl, "cv": cv.double().cpu().numpy()}

    def stage_gaps(self, got: dict, ref: dict) -> dict:
        """The largest gap of a try's validation reconstruction and KL and
        of the CV of a frame."""
        bad = {k: math.inf for k in ("valid_recon_gap", "valid_kl_gap", "cv_gap")}
        if not got or not ref or np.shape(got["cv"]) != np.shape(ref["cv"]):
            return bad
        out = {f"{k}_gap": float(np.max(np.abs(np.subtract(got[k], ref[k]))))
               for k in ("valid_recon", "valid_kl")}
        out["cv_gap"] = float(np.max(np.abs(got["cv"] - ref["cv"])))
        return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}

    def counter_values(self) -> dict:
        """Steps at another beta than `max_beta`, and tries returned without
        the post-annealing selection, over every call after set-up: from the
        program's counter, or from the job's record where it has none."""
        stats = train_stats()
        if stats is None:
            off, selections = self.off_beta_steps, self.selections
        else:
            off = stats.steps - stats.plateau_steps
            selections = stats.post_annealing_selections
        return {"beta_off_steps": float(off),
                "calls_without_selection": float(self.calls * len(self.seeds) - selections)}

    def check(self) -> dict:
        final = self.final or {}
        ref = self.reference_stage(final, reference.FLOAT64) if final else {}
        return {**self.step_gaps(self.program_steps(),
                                 self.reference_steps(reference.FLOAT64)),
                **self.stage_gaps(final, ref), **self.counter_values()}

    def stand_in(self, p: "reference.Precision", **fault) -> dict:
        """The reference put in the program's place: its steps in `p`, with
        a planted fault where asked (`keep_rows`, `beta`, `zero_eps`), and
        the stage from the program's final parameters; its counts are its
        own steps at another beta and no missing selection."""
        final = self.final or {}
        steps = self.reference_steps(p, **fault)
        values = self.step_gaps(steps, self.reference_steps(reference.FLOAT64))
        ref = self.reference_stage(final, reference.FLOAT64) if final else {}
        stage = (self.reference_stage(final, p, fault.get("zero_eps", False))
                 if final else {})
        return {**values, **self.stage_gaps(stage, ref),
                "beta_off_steps": float(steps["off_beta_steps"]),
                "calls_without_selection": 0.0}

    def control_check(self) -> dict:
        """The control: the reference in float32 with TF32 matrix products."""
        return self.stand_in(reference.Precision(torch.float32, "tf32"))

    def fault_checks(self) -> dict:
        """Planted faults, each in the float64 reference put in the
        program's place: beta forced to 0 (the KL left out), eps = 0 (no
        sampling), half of each batch left out."""
        return {"fault_beta0": self.stand_in(reference.FLOAT64, beta=0.0),
                "fault_eps0": self.stand_in(reference.FLOAT64, zero_eps=True),
                "fault_half_batch": self.stand_in(reference.FLOAT64, keep_rows=0.5)}

    def close(self) -> None:
        pass
