"""Train: `DeepTICACalculator.train()` on a feature matrix handed over as
`train_colvars` hands it, one call of the mix's epochs a call (the seeded
tries as one batched program, validation at each epoch's end, the best
try's TICA layer).

Set-up builds the one calculator the window drives and runs its first
call. Every call runs with the optimizer and the loss observed: each of
the first steps' losses, the optimizer's first moment after step 1 (the
first gradient, as the optimizer got it) and the parameters before step 1
and after the last observed step. The check takes the last call the run
made. The reference works its first steps out again in float64 from the
seed (initial parameters, splits, batch orders, dropout masks). It cannot
follow the rest of the epoch, where float32 and float64 part by round-off
that Adam magnifies in leaves whose gradient is near nought, so the stage
after the steps is checked by itself from the program's own state at the
call's end: each try's validation loss from its parameters, the try chosen,
and the TICA layer fitted on the chosen try's outputs with the CV it gives
on every frame.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.profiler import record_function

from carto_bench import reference, synth
from carto_bench.jobs.common import calculator_config, inputs_made, resolved_encoder

CHANGE_RULE = 1e-3    # leaves whose reference gradient is under this share of
                      # the median leaf's move by round-off alone under Adam
KINK_REACH = 2e-6     # a pre-activation this near 0 may take the other side
                      # of leaky_relu in float32 (a diagnostic, not compared)


def observe_first_steps(calc, steps: int):
    """calc.train() with its optimizer's and loss's first `steps` steps
    recorded: (train's result, the record)."""
    import deep_cartograph_torch.models.training as training

    rec = {"losses": []}
    base = training.Optimizer

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

    loss_fn = calc.loss_fn

    def recording(params, batch, generators, beta, train=True):
        loss, aux = loss_fn(params, batch, generators, beta, train)
        if train and len(rec["losses"]) < steps:
            rec["losses"].append(loss.detach().clone())
        return loss, aux

    training.Optimizer = Observed
    calc.loss_fn = recording
    try:
        ok = calc.train()
    finally:
        training.Optimizer = base
        del calc.loss_fn
    return ok, rec


class Job:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        from deep_cartograph_torch.cv.deep import DeepTICACalculator

        self.mix, self.device = mix, torch.device(device)
        self.mol = mol = synth.Molecule.from_config(config)
        coords = synth.trajectory(config, int(config["frames"]), seed, device)
        self.x = reference.features(coords, mol.ca_index, mol.pairs, mol.quads).float().cpu().numpy()
        del coords
        inputs_made(device)
        self.cfg = calculator_config(config, mix["max_epochs"])
        self.calc = DeepTICACalculator(self.cfg, device=device)
        self.calc._set_training_data(self.x, np.zeros(len(self.x), np.int64), mol.labels())
        general = self.cfg["training"]["general"]
        hidden = list(self.cfg["architecture"]["encoder"]["layers"])
        self.layers = [mol.n_features] + hidden + [int(self.cfg["dimension"])]
        self.options = reference.layer_options(resolved_encoder(config, self.cfg),
                                               len(self.layers) - 1)
        self.seeds = [general["seed"] + t for t in range(1, general["num_tries"] + 1)]
        lag = int(self.cfg["lag_time"])
        self.n_train = int((len(self.x) - lag) * general["lengths"][0])
        self.steps_per_call = int(mix["max_epochs"]) * math.ceil(self.n_train / general["batch_size"])
        self.observed_steps = int(mix["check_steps"])
        self.final = None
        self.first_ok = not self.call(-1)["failed"]

    def call(self, i: int) -> dict:
        with record_function("bench.train"):
            ok, self.record = observe_first_steps(self.calc, self.observed_steps)
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
        parameters and validation score, the chosen try's score, the TICA
        layer's eigenvalues and the CV before post-normalization of every
        frame."""
        calc = self.calc
        results = [r for _, r in getattr(calc, "try_results", [])]
        if len(results) != len(self.seeds) or calc.eigenvalues_ is None:
            return {}
        with torch.no_grad():
            return {"params": [{k: v.detach().clone() for k, v in r.params.items()}
                               for r in results],
                    "scores": [float(r.score) for r in results],
                    "chosen_score": float(calc.cv_score),
                    "eigenvalues": np.asarray(calc.eigenvalues_, np.float64),
                    "cv": np.asarray(calc.latent(self.x), np.float64)}

    # ------------------------------------------------------------------
    def reference_steps(self, p: "reference.Precision", keep_rows: float = 1.0) -> dict:
        """The first steps worked out again from the data and the seed."""
        cfg, layers, options, seeds = self.cfg, self.layers, self.options, self.seeds
        general = cfg["training"]["general"]
        lag = int(cfg["lag_time"])
        x = torch.as_tensor(self.x, device=self.device)
        mean = x.double().mean(0)
        std = x.double().std(0, unbiased=False)
        std = torch.where(std.abs() < 1e-8, torch.ones_like(std), std)
        batches = reference.first_batches(len(self.x) - lag, general["lengths"][0],
                                          general["batch_size"], seeds, self.observed_steps)
        widths = [(general["batch_size"], w) for w in layers[1:]]
        masks = reference.dropout_masks(widths, seeds, options, self.observed_steps, self.device)
        params = self.initial_params(torch.float32)
        opt = cfg["training"]["optimizer"]["kwargs"]
        with p.scope():
            out = reference.adam_steps(x[:-lag], x[lag:], mean, std, params, batches, masks,
                                       options, cfg["tica_regularization"], opt["lr"],
                                       p=p, keep_rows=keep_rows)
        out["params0"] = self.initial_params(torch.float64)
        return out

    def initial_params(self, dtype) -> dict:
        return {k: v.to(self.device) for k, v in
                reference.initial_params(self.layers, self.seeds, dtype).items()}

    def gaps(self, got: dict, ref: dict) -> dict:
        """Each step's loss gap (largest over tries), the first gradient's
        worst leaf and the change's median leaf: |norm(program) -
        norm(reference)| over the larger of the reference's norm and the
        median leaf's; a leaf is one parameter of one try. The change
        leaves out leaves whose reference gradient is under CHANGE_RULE of
        the median leaf's. Its worst leaf (`change_gap`) and the
        pre-activations near leaky_relu's kink are reported, not compared:
        a bias of 2 or 15 entries whose gradient is near round-off moves by
        a random share of the learning rate under Adam."""
        out = {"loss_gap": float((got["losses"].double() - ref["losses"].double())
                                 .abs().max())}

        def leaf_norms(tree):
            return {(k, t): float(v[t].double().norm()) for k, v in tree.items()
                    for t in range(v.shape[0])}

        g_ref = leaf_norms(ref["first_grad"])
        g_got = leaf_norms(got["first_grad"])
        med = float(np.median(list(g_ref.values())))
        grad = {k: abs(g_got[k] - g_ref[k]) / max(g_ref[k], med) for k in g_ref}
        out["grad_gap"] = max(grad.values())
        out["grad_worst_leaf"] = "%s[%d]" % max(grad, key=grad.get)
        d_ref = leaf_norms({k: ref["params"][k].double() - ref["params0"][k].double()
                            for k in ref["params"]})
        d_got = leaf_norms({k: got["params"][k].double() - got["params0"][k].double()
                            for k in got["params"]})
        kept = [k for k in g_ref if g_ref[k] >= CHANGE_RULE * med]
        med_d = float(np.median([d_ref[k] for k in kept]))
        change = {k: abs(d_got[k] - d_ref[k]) / max(d_ref[k], med_d) for k in kept}
        out["change_median_gap"] = float(np.median(list(change.values())))
        out["change_gap"] = max(change.values())
        out["change_worst_leaf"] = "%s[%d]" % max(change, key=change.get)
        out["change_leaves_left_out"] = len(g_ref) - len(kept)
        # pre-activations within float32 reach of leaky_relu's kink, by step
        out["near_kink_by_step"] = [int(sum(int((x.abs() < KINK_REACH).sum()) for x in step))
                                    for step in ref.get("pre_activations", [])]
        return out

    def program_steps(self) -> dict:
        rec = self.record
        if len(rec["losses"]) < self.observed_steps or "params" not in rec:
            return {}
        return {"losses": torch.stack(rec["losses"]),
                "first_grad": {k: v / (1 - rec["b1"]) for k, v in rec["mu1"].items()},
                "params0": rec["params0"], "params": rec["params"]}

    def reference_final(self, tries: list, p: "reference.Precision", chosen=None) -> dict:
        """The stage after the steps, worked out again from each try's
        parameters (`tries`): every try's validation loss (its split from
        its seed, no dropout), the try chosen (the least loss, or
        `chosen`), and the TICA layer on the chosen try's outputs over
        every lag pair with the CV it gives on every frame."""
        lag = int(self.cfg["lag_time"])
        reg = float(self.cfg["tica_regularization"])
        x = torch.as_tensor(self.x, device=self.device).double()
        std = x.std(0, unbiased=False)
        xn = ((x - x.mean(0)) / torch.where(std.abs() < 1e-8, torch.ones_like(std), std))
        xn = xn.to(p.dtype)
        del x
        n_pairs = len(xn) - lag

        def net(t):
            w = {k: v.to(self.device, p.dtype) for k, v in tries[t].items()}
            return lambda v: reference.mlp(w, v, self.options, p=p)

        with p.scope():
            scores = []
            for t, seed in enumerate(self.seeds):
                valid = torch.as_tensor(
                    np.random.default_rng(seed).permutation(n_pairs)[self.n_train:],
                    device=self.device)
                f = net(t)
                scores.append(float(reference.deep_tica_loss(f(xn[valid]), f(xn[valid + lag]),
                                                             reg, p)))
            chosen = int(np.argmin(scores)) if chosen is None else chosen
            q = net(chosen)(xn)
            evals, evecs = reference.tica_layer(q[:-lag], q[lag:], reg, p)
            cv = p.mm(q, evecs)
        return {"scores": scores, "chosen": chosen,
                "eigenvalues": evals.double().cpu().numpy(), "cv": cv.double().cpu().numpy()}

    def final_gaps(self, got: dict, tries: list) -> dict:
        """The stage's numbers: the largest gap of a try's validation loss,
        the regret of the try chosen (the reference's loss of it less the
        least), the largest gap of a TICA eigenvalue and of the CV of a
        frame, against the float64 stage from the same parameters."""
        bad = {k: math.inf for k in ("valid_loss_gap", "best_try_regret",
                                     "tica_eval_gap", "tica_cv_gap")}
        if not got or got["chosen"] is None:
            return bad
        ref = self.reference_final(tries, reference.FLOAT64, got["chosen"])
        if got["cv"].shape != ref["cv"].shape or len(got["scores"]) != len(ref["scores"]):
            return bad
        out = {"valid_loss_gap": float(np.max(np.abs(np.subtract(got["scores"],
                                                                 ref["scores"])))),
               "best_try_regret": ref["scores"][got["chosen"]] - min(ref["scores"]),
               "tica_eval_gap": float(np.max(np.abs(got["eigenvalues"] - ref["eigenvalues"]))),
               "tica_cv_gap": float(np.max(np.abs(got["cv"] - ref["cv"])))}
        return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}

    def program_final_values(self) -> dict:
        got = self.final or {}
        if not got:
            return self.final_gaps({}, [])
        chosen = [t for t, sc in enumerate(got["scores"]) if sc == got["chosen_score"]]
        return self.final_gaps({**got, "chosen": chosen[0] if chosen else None},
                               got["params"])

    def _values(self, got: dict) -> dict:
        if not got:
            return {}
        ref = self.reference_steps(reference.FLOAT64)
        values = self.gaps(got, ref)
        values["first_call_failed"] = 0.0 if self.first_ok else 1.0
        return values

    def check(self) -> dict:
        return {**self._values(self.program_steps()), **self.program_final_values()}

    def control_check(self, keep_rows: float = 1.0) -> dict:
        """The reference put in the program's place: in float32 with TF32
        matrix products (the control), or with `keep_rows` of each batch
        (a planted fault). The stage after the steps takes the program's
        parameters at the call's end, as the reference does."""
        p = reference.Precision(torch.float32, "tf32") if keep_rows == 1.0 else reference.FLOAT64
        values = self._values(self.reference_steps(p, keep_rows))
        tries = (self.final or {}).get("params", [])
        stage = self.reference_final(tries, p) if tries else {}
        return {**values, **self.final_gaps(stage, tries)}

    def worst_try_check(self) -> dict:
        """The stage's numbers had the program chosen its worst try (a
        planted fault)."""
        got = self.final or {}
        if not got:
            return self.final_gaps({}, [])
        return self.final_gaps({**got, "chosen": int(np.argmax(got["scores"]))},
                               got["params"])

    def close(self) -> None:
        pass
