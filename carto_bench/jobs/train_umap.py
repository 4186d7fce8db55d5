"""Fit the UMAP CV: the calculator `train_colvars` builds for `cvs:
['umap']` from the configuration's `train_colvars.common` block (`cv`),
the feature matrix handed over as `train_colvars` hands it, one whole fit
a call as `UMAP.run()` runs it up to its save: `compute_cv()` (the
features normalized, the kNN, sigma, the fuzzy union, the PCA start, the
layout's epochs), `normalize_cv()`, then the normalized projection of the
training data. The save (`np.savez_compressed` of the training data) is
left out: file I/O on the host, not the CV's work.

Every call runs with the module functions `_knn` and `layout_epoch`
observed: the fit's kNN, the layout's graph and start, the draws and
embeddings of the first 3 epochs, and the last epoch's input and draws.
The check takes the last call the run made and works each stage out
again in float64 (`reference_umap.py`) from the features or from what the
program handed the stage: the kNN of rows drawn from the seed against all
frames, the graph from the program's kNN, the PCA start, the first 3
epochs and the last each from the program's embedding before it (the
first from its start), its graph and its draws, and the normalized CV
from the program's embedding. The layout is chaotic (`umap_float32_floor.py`), so
the epochs between cannot be compared. The port's counter
(`umap_cv.UMAP_STATS`) gives the epochs run and the rows left not finite
over every call after set-up; a program without it is read from the
job's own record of the same.
"""

from __future__ import annotations

import math
import os
import tempfile

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from carto_bench import reference, reference_umap, synth
from carto_bench.jobs.common import inputs_made
from carto_bench.spans import device_us_by_span, load_events

SETTING_KEYS = ("n_neighbors", "min_dist", "metric", "seed", "dimension",
                "features_normalization", "layout_epochs", "learning_rate",
                "negative_samples")


def calculator_config(config: dict) -> dict:
    """The UMAP configuration `train_colvars` builds from the
    configuration's `train_colvars.common` block."""
    from deep_cartograph_torch.config.schemas import cv_configuration, train_colvars_config

    return cv_configuration(train_colvars_config({"common": config["cv"]}), "umap")


def resolved_settings(config: dict, calc) -> dict:
    """The fit's settings as the configuration states them resolved
    (`umap_resolved`), after making sure that the program resolves them
    alike: the reference reads the stated ones."""
    from deep_cartograph_torch.cv.umap_cv import UMAPModel

    model = UMAPModel(calc.cv_dimension, device=calc.device)
    got = {"n_neighbors": calc.n_neighbors, "min_dist": calc.min_dist, "metric": calc.metric,
           "seed": calc.seed, "dimension": calc.cv_dimension,
           "features_normalization": calc.feats_norm_mode, "layout_epochs": model.n_epochs,
           "learning_rate": model.learning_rate, "negative_samples": model.negative_samples}
    stated = config["umap_resolved"]
    differ = [k for k in SETTING_KEYS if got[k] != stated[k]]
    if differ:
        raise RuntimeError(f"train_colvars resolves {', '.join(differ)} otherwise than the "
                           f"configuration states: {got}")
    return dict(stated)


def observe_fit(calc) -> dict:
    """One fit as `UMAP.run()` makes it up to its save, with the kNN, the
    layout's graph, start, early epochs and last epoch recorded."""
    from deep_cartograph_torch.cv import umap_cv

    rec = {"early": [], "epochs_run": 0}
    knn, epoch = umap_cv._knn, umap_cv.layout_epoch

    def kept_knn(data, queries, k, exclude_self, *args, **kwargs):
        out = knn(data, queries, k, exclude_self, *args, **kwargs)
        if exclude_self:
            rec["knn_dists"], rec["knn_idx"] = out
        return out

    def kept_epoch(emb, heads, tails, weights, uniform, negatives, alpha, a, b):
        e = rec["epochs_run"]
        if e == 0:
            rec.update(heads=heads, tails=tails, weights=weights, init=emb.clone())
        rec["last"] = {"input": emb.clone(), "uniform": uniform, "negatives": negatives}
        out = epoch(emb, heads, tails, weights, uniform, negatives, alpha, a, b)
        if e < reference_umap.EARLY_EPOCHS:
            rec["early"].append({"uniform": uniform, "negatives": negatives,
                                 "output": out.clone()})
        rec["epochs_run"] = e + 1
        return out

    umap_cv._knn, umap_cv.layout_epoch = kept_knn, kept_epoch
    try:
        calc.compute_cv()
        calc.set_labels()
        if calc.cv is not None:
            calc.normalize_cv()
            rec["embedding"] = calc.cv.embedding_
            rec["cv"] = np.asarray((calc.cv.embedding_ - calc.cv_norm_mean)
                                   / calc.cv_norm_range, np.float32)
    finally:
        umap_cv._knn, umap_cv.layout_epoch = knn, epoch
    return rec


def umap_stats():
    """The program's UMAP counter, or None for a program without it."""
    from deep_cartograph_torch.cv import umap_cv

    return getattr(umap_cv, "UMAP_STATS", None)


def nonfinite_rows(emb) -> int:
    return int((~torch.isfinite(torch.as_tensor(emb))).any(1).sum())


def worst(gap: torch.Tensor) -> float:
    """The largest entry of |gap|, infinite where one is not a number."""
    if gap.numel() == 0:
        return 0.0
    value = float(gap.abs().max())
    return value if math.isfinite(value) else math.inf


class Job:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        from deep_cartograph_torch.cv import cv_calculators_map

        self.mix, self.device, self.seed = mix, torch.device(device), seed
        self.mol = mol = synth.Molecule.from_config(config)
        coords = synth.trajectory(config, int(config["frames"]), seed, device)
        self.x = (reference.features(coords, mol.ca_index, mol.pairs, mol.quads)
                  .float().cpu().numpy())
        del coords
        inputs_made(device)
        self.cfg = calculator_config(config)
        self.calc = cv_calculators_map["umap"](self.cfg, device=device)
        self.calc._set_training_data(self.x, np.zeros(len(self.x), np.int64), mol.labels())
        self.settings = resolved_settings(config, self.calc)
        self.epochs_per_fit = int(self.settings["layout_epochs"])
        n = len(self.x)
        self.check_rows = np.sort(np.random.default_rng(seed).choice(
            n, min(int(mix["check_rows"]), n), replace=False))
        self.final, self.record, self._profiled = None, {}, None
        self._ref_x = self._ref_pca = None
        self.calls = self.epochs_seen = self.nonfinite = 0
        self.call(-1)
        # what the counter and the job's own record cover: every call after set-up
        self.calls = self.epochs_seen = self.nonfinite = 0
        if umap_stats() is not None:
            umap_stats().reset()

    def call(self, i: int) -> dict:
        with record_function("bench.fit"):
            self.record = observe_fit(self.calc)
        self.calls += 1
        self.epochs_seen += self.record["epochs_run"]
        emb = self.record.get("embedding")
        self.nonfinite += nonfinite_rows(emb) if emb is not None else 0
        return {"steps": self.epochs_per_fit, "fits": 1, "failed": emb is None}

    def end_to_end(self, window) -> dict:
        return {"train_step_ms": 1e3 * window.seconds / window.total("steps")}

    def prepare_control(self) -> None:
        pass

    def release(self) -> None:
        """Keep what the last call left for the check, then free the rest."""
        self.final = self.record
        self.calc = None

    # ------------------------------------------------------------------
    def profiled_call(self, first_call: int) -> dict:
        """One more call under a profiler of the job's own (the harness's
        trace keeps no correlation ids), once, shared by the readers:
        device microseconds by the innermost program span that held each
        launch (`spans.device_us_by_span`), the epochs the counter counted
        over the call (None without the counter) and the call's edges."""
        if self._profiled is not None:
            return self._profiled
        on_card = self.device.type == "cuda"
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        stats = umap_stats()
        before = stats.epochs if stats is not None else None
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        sync()
        with profile(activities=activities) as prof:
            self.call(first_call)
            sync()
        fd, path = tempfile.mkstemp(suffix=".json", dir=os.environ.get("TMPDIR"))
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            by_span = device_us_by_span(load_events(path))
        finally:
            os.remove(path)
        edges = self.record.get("heads")
        self._profiled = {"by_span": by_span,
                          "epochs": None if stats is None else stats.epochs - before,
                          "edges": 0 if edges is None else len(edges)}
        return self._profiled

    # ------------------------------------------------------------------
    def reference_x(self) -> torch.Tensor:
        """The features normalized in float64 as the configuration states,
        on the device; made once."""
        if self._ref_x is None:
            self._ref_x = reference_umap.normalize(
                torch.as_tensor(self.x, device=self.device),
                self.settings["features_normalization"])
        return self._ref_x

    def reference_pca(self):
        """The float64 PCA start of the normalized features and the
        covariance's eigenvalues; made once."""
        if self._ref_pca is None:
            self._ref_pca = reference_umap.pca_init(self.reference_x(),
                                                    int(self.settings["dimension"]))
        return self._ref_pca

    def knn_gaps(self, rec: dict) -> dict:
        """The kNN of the check rows against float64 over every frame:
        each reported neighbour's exact d2 less the exact one of its rank,
        over the float32 bound of the d2 expansion, 2 (2d + 5) u (|q|^2 +
        max |x|^2) (`knn_excess_of_bound`, infinite where a row reports
        itself, an index twice or out of range, or another count), and the
        reported distances against the exact ones of the same pairs
        (`knn_dist_gap`)."""
        bad = {"knn_excess_of_bound": math.inf, "knn_dist_gap": math.inf}
        x = self.reference_x()
        n, d = x.shape
        k = int(self.settings["n_neighbors"])
        idx, dists = rec.get("knn_idx"), rec.get("knn_dists")
        if idx is None or tuple(idx.shape) != (n, k):
            return bad
        rows = torch.as_tensor(self.check_rows, device=self.device)
        got_idx = idx.to(self.device)[rows].long()
        got_d = dists.to(self.device)[rows].double()
        own = got_idx == rows[:, None]
        repeated = (got_idx.sort(1).values.diff(1) == 0).any()
        if own.any() or repeated or got_idx.min() < 0 or got_idx.max() >= n:
            return bad
        sq = (x * x).sum(1)
        excess, gap = [], []
        block = max(1, reference_umap.KNN_BLOCK_ELEMENTS // n)
        for a in range(0, len(rows), block):
            r = rows[a:a + block]
            d2 = reference_umap.squared_distances(x[r], x)
            d2[torch.arange(len(r), device=d2.device), r] = math.inf
            exact = torch.topk(d2, k, dim=1, largest=False).values
            mine = torch.gather(d2, 1, got_idx[a:a + block])
            bound = (2 * (2 * d + 5) * reference_umap.FLOAT32_UNIT_ROUNDOFF
                     * (sq[r] + sq.max()))
            excess.append((mine - exact) / bound[:, None])
            gap.append(got_d[a:a + block] - torch.sqrt(torch.clamp_min(mine, 0.0)))
        return {"knn_excess_of_bound": float(torch.cat(excess).max()),
                "knn_dist_gap": worst(torch.cat(gap))}

    def graph(self, rec: dict) -> dict:
        """The layout's graph as the record holds it, on the device, in
        float64."""
        return {"heads": rec["heads"].to(self.device).long(),
                "tails": rec["tails"].to(self.device).long(),
                "weights": rec["weights"].to(self.device).double()}

    def graph_gaps(self, rec: dict) -> dict:
        """rho, sigma and the fuzzy union worked out in float64 from the
        record's own kNN, against the layout's graph: edges in one graph
        and not the other (`graph_edge_mismatch`), and the largest weight
        gap of an edge (`graph_weight_gap`; infinite where the edges
        differ)."""
        if "heads" not in rec or "knn_dists" not in rec:
            return {"graph_edge_mismatch": math.inf, "graph_weight_gap": math.inf}
        dists = rec["knn_dists"].to(self.device).double()
        n = len(dists)
        w = reference_umap.membership(dists, *reference_umap.smooth_knn(
            dists, int(self.settings["n_neighbors"])))
        ref = reference_umap.fuzzy_union(rec["knn_idx"].to(self.device).long(), w, n)
        got = self.graph(rec)
        key = got["heads"] * n + got["tails"]
        order = torch.argsort(key)
        key, weights = key[order], got["weights"][order]
        ref_key = ref["heads"] * n + ref["tails"]
        if len(key) == len(ref_key) and bool((key == ref_key).all()):
            return {"graph_edge_mismatch": 0.0,
                    "graph_weight_gap": worst(weights - ref["weights"])}
        mismatch = int((~torch.isin(key, ref_key)).sum() + (~torch.isin(ref_key, key)).sum())
        return {"graph_edge_mismatch": float(max(mismatch, 1)), "graph_weight_gap": math.inf}

    def pca_gaps(self, rec: dict) -> dict:
        """The PCA start against float64's, each component's sign aligned:
        the largest gap (`pca_init_gap`) times the leading eigenvalues'
        smallest relative gap (`pca_eigengap`), `pca_init_scaled_gap`. To
        first order a covariance off by dC turns a component by |dC| over
        its eigengap, so the product reads the precision the covariance was
        formed in whatever the spectrum: the synthetic spectra put that
        gap anywhere from 0.8 to 44 %, and compared raw, a near-degenerate
        pair in float32 reads as far off as the TF32 control on a wide
        one."""
        bad = {"pca_init_scaled_gap": math.inf}
        if "init" not in rec:
            return bad
        c = int(self.settings["dimension"])
        ref, evals = self.reference_pca()
        got = rec["init"].to(self.device).double()
        if got.shape != ref.shape:
            return bad
        got = got * torch.sign((got * ref).sum(0))
        lead = evals[:c + 1]
        gap, eigengap = worst(got - ref), float(((lead[:-1] - lead[1:]) / lead[:-1]).min())
        return {"pca_init_scaled_gap": gap * eigengap, "pca_init_gap": gap,
                "pca_eigengap": eigengap}

    def epoch_gaps(self, rec: dict) -> dict:
        """Each of the first 3 epochs replayed in float64 from the
        record's embedding before it (the start, then the epoch before's
        output), its graph and its draws (`early_epochs_gap`, the largest
        of the 3), and the last epoch likewise (`last_epoch_gap`), each at
        the rate the configuration gives its epoch; the normalized CV from
        the record's final embedding (`cv_gap`). Beside them, the 3 first
        epochs replayed one after another from the start alone
        (`early_chained_gap`, not compared): the layout is chaotic, and at
        the cell's size float32 and float64 part by up to about 1 within 3
        epochs that way."""
        out = {"early_epochs_gap": math.inf, "last_epoch_gap": math.inf, "cv_gap": math.inf}
        if "heads" not in rec:
            return out
        a, b = reference_umap.fit_ab(float(self.settings["min_dist"]))
        epochs, lr = self.epochs_per_fit, float(self.settings["learning_rate"])
        graph = self.graph(rec)

        def epoch(emb, draws, e):
            return reference_umap.layout_epoch(
                emb.to(self.device).double(), graph, draws["uniform"].to(self.device),
                draws["negatives"].to(self.device), reference_umap.learning_rate(e, epochs, lr),
                a, b)

        with torch.no_grad():
            early = rec["early"]
            if len(early) == reference_umap.EARLY_EPOCHS:
                inputs = [rec["init"]] + [step["output"] for step in early[:-1]]
                chained, one, gaps = rec["init"].to(self.device).double(), [], []
                for e, (before, step) in enumerate(zip(inputs, early)):
                    got = step["output"].to(self.device).double()
                    one.append(worst(got - epoch(before, step, e)))
                    chained = epoch(chained, step, e)
                    gaps.append(worst(got - chained))
                out["early_epochs_gap"], out["early_chained_gap"] = max(one), max(gaps)
            final = torch.as_tensor(rec.get("embedding"), device=self.device).double()
            if "last" not in rec:
                return out
            last = epoch(rec["last"]["input"], rec["last"], epochs - 1)
            if final.shape == last.shape:
                out["last_epoch_gap"] = worst(final - last)
            cv = torch.as_tensor(rec.get("cv"), device=self.device).double()
            if cv.shape == final.shape:
                out["cv_gap"] = worst(cv - reference_umap.normalized_cv(final))
        return out

    def gaps(self, rec: dict) -> dict:
        if not rec or rec.get("embedding") is None:
            return {}
        return {**self.knn_gaps(rec), **self.graph_gaps(rec), **self.pca_gaps(rec),
                **self.epoch_gaps(rec)}

    def counter_values(self) -> dict:
        """Epochs run against the configuration's a fit, and embedding rows
        not finite, over every call after set-up: from the program's
        counter, or from the job's own record where it has none."""
        stats = umap_stats()
        epochs, nonfinite = ((self.epochs_seen, self.nonfinite) if stats is None
                             else (stats.epochs, stats.nonfinite_rows))
        return {"epochs_off": float(abs(self.calls * self.epochs_per_fit - epochs)),
                "nonfinite_rows": float(nonfinite)}

    def check(self) -> dict:
        return {**self.gaps(self.final or {}), **self.counter_values()}

    def stand_in(self, p: "reference.Precision", **fault) -> dict:
        """The reference put in the program's place: a whole fit of the
        normalized features in `p`, with a planted fault where asked
        (`reference_umap.fit`), checked as the program's last call is; its
        counts are its own."""
        x = self.reference_x()
        rec = reference_umap.fit(x, self.settings, int(self.settings["seed"]), p, **fault)
        return {**self.gaps(rec),
                "epochs_off": float(abs(self.epochs_per_fit - rec["epochs_run"])),
                "nonfinite_rows": float(nonfinite_rows(rec["embedding"]))}

    def control_check(self) -> dict:
        """The control: the reference in float32 with TF32 matrix products
        (the kNN's and the PCA start's)."""
        return self.stand_in(reference.Precision(torch.float32, "tf32"))

    def fault_checks(self) -> dict:
        """Planted faults, each in the float64 reference put in the
        program's place: no repulsion, k - 1 neighbours, W in place of the
        fuzzy union, half the epochs."""
        return {"fault_no_repulsion": self.stand_in(reference.FLOAT64, no_repulsion=True),
                "fault_k_minus_1": self.stand_in(reference.FLOAT64, neighbours_short=1),
                "fault_w_not_union": self.stand_in(reference.FLOAT64, union=False),
                "fault_half_epochs": self.stand_in(reference.FLOAT64, epochs_share=0.5)}

    def close(self) -> None:
        pass
