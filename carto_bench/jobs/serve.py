"""Serve: a deep-TICA model.zip projecting host coordinates, as users
project new trajectories with `FramesToCV.from_model_zip` (upload, K1 and
the dihedrals, the normalization, the network, the TICA layer, the post
normalization, the copy back), one trajectory a call.

The network is the one `train_colvars` trains from the configuration's
CV settings (its per-layer options as it resolves them); its weights, the
normalization and the TICA layer are the benchmark's, made from the seed;
the program reads them from the model.zip that set-up writes. Checked: rows drawn from the seed of every call (its first and
last frame among them) against the reference's float64 CV.
"""

from __future__ import annotations

import json
import os
import shutil
import zipfile

import numpy as np
import torch
from torch.profiler import record_function

from carto_bench import reference, synth
from carto_bench.jobs.common import (calculator_config, inputs_made,
                                     max_abs_by_column_group, resolved_encoder)

NORM_FRAMES = 20000   # frames the benchmark's normalization is taken over


class Job:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        from deep_cartograph_torch.deploy import FramesToCV

        self.mix, self.device = mix, torch.device(device)
        self.mol = mol = synth.Molecule.from_config(config)
        self.dir = synth.scratch_dir("serve")
        self.pool = synth.trajectory(config, int(config["frames"]), seed, device).cpu().numpy()
        pdb = os.path.join(self.dir, "top.pdb")
        synth.write_pdb(pdb, mol, self.pool[0])

        cfg = calculator_config(config, 1)
        encoder = resolved_encoder(config, cfg)
        dim = int(cfg["dimension"])
        self.layers = [mol.n_features] + list(cfg["architecture"]["encoder"]["layers"]) + [dim]
        self.options = reference.layer_options(encoder, len(self.layers) - 1)
        self.weights = self._weights(seed)
        zip_path = os.path.join(self.dir, "model.zip")
        self._write_zip(zip_path, pdb, encoder, dim)
        inputs_made(device)
        self.pipeline = FramesToCV.from_model_zip(
            zip_path, pdb, output_path=os.path.join(self.dir, "served"), device=device)

        self.lengths = synth.log_lengths(int(mix["min_frames"]), int(mix["max_frames"]),
                                         int(mix["distinct_lengths"]), seed)
        self.rng = np.random.default_rng(seed)
        self.samples = []
        for n in (self.lengths.max(), self.lengths.min()):   # first use, largest shape
            self.project(0, int(n))

    def _weights(self, seed: int) -> dict:
        """The served CV's weights from the seed, float32: the network, the
        normalization (mean and population std of the features of the
        first frames), the TICA layer, and the post normalization that maps
        those frames' CV onto [-1, 1]."""
        w = synth.dense_weights(self.layers, seed + 1, self.device)
        gen = torch.Generator(device=self.device).manual_seed(int(seed) + 2)
        dim = self.layers[-1]
        w["tica_evecs"] = torch.randn(dim, dim, generator=gen, device=self.device)
        frames = torch.as_tensor(self.pool[:NORM_FRAMES], device=self.device)
        feats = reference.features(frames, self.mol.ca_index, self.mol.pairs, self.mol.quads)
        w["norm_mean"] = feats.mean(0).float()
        w["norm_range"] = feats.std(0, unbiased=False).float()
        w["post_mean"] = torch.zeros(dim, device=self.device)
        w["post_range"] = torch.ones(dim, device=self.device)
        cv = reference.served_cv(feats, w, self.options)
        lo, hi = cv.min(0).values, cv.max(0).values
        w["post_mean"] = ((hi + lo) / 2).float()
        w["post_range"] = ((hi - lo) / 2).float()
        return {k: v.float().cpu() for k, v in w.items()}

    def _write_zip(self, path: str, pdb: str, encoder: dict, dim: int) -> None:
        """A deep-TICA model.zip as upstream deep_cartograph lays it out,
        with the per-layer options of the resolved encoder as a trained
        model's architecture holds them (the hidden layers' lists, then the
        last layer's entry); the parameters go through the program's
        msgpack writer."""
        from deep_cartograph_torch.models.weights import save_params

        w = self.weights
        arch = {
            "kind": "deep_tica", "layers": self.layers,
            "encoder_options": {
                key: list(encoder[key] or []) + [encoder[f"last_layer_{key}"]]
                for key in ("activation", "dropout", "batchnorm")},
            "norm_mean": w["norm_mean"].double().tolist(),
            "norm_range": w["norm_range"].double().tolist(),
            "tica_evecs": w["tica_evecs"].double().tolist(),
            "post_mean": w["post_mean"].double().tolist(),
            "post_range": w["post_range"].double().tolist(),
        }
        params_path = os.path.join(self.dir, "flax_params.msgpack")
        save_params({k: v for k, v in w.items() if k.startswith("nn/")}, params_path)
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("model/metadata.json",
                        json.dumps({"cv_name": "deep_tica", "cv_dimension": dim}))
            zf.writestr("model/features_labels.txt", "\n".join(self.mol.labels()) + "\n")
            zf.write(pdb, "model/ref_topology.pdb")
            zf.writestr("model/architecture.json", json.dumps(arch))
            zf.write(params_path, "model/flax_params.msgpack")

    def project(self, offset: int, n: int) -> np.ndarray:
        with record_function("bench.FramesToCV"):
            out = self.pipeline(self.pool[offset:offset + n])
        k = min(int(self.mix["check_rows"]), n)
        rows = np.unique(np.concatenate([[0, n - 1], self.rng.choice(n, k, replace=False)]))
        self.samples.append((offset + rows, out[rows] if len(out) == n else out))
        return out

    def call(self, i: int) -> dict:
        n = int(self.lengths[i % len(self.lengths)])
        offset = int(self.rng.integers(0, len(self.pool) - n + 1))
        self.project(offset, n)
        return {"frames": n}

    def end_to_end(self, window) -> dict:
        return {"project_fps": window.total("frames") / window.seconds}

    def prepare_control(self) -> None:
        pass

    def release(self) -> None:
        self.pipeline = None

    def _check(self, p: "reference.Precision") -> dict:
        rows = np.concatenate([r for r, _ in self.samples])
        values = [v for _, v in self.samples]
        if any(v.shape[1:] != (self.layers[-1],) or len(v) != len(r)
               for r, v in self.samples):
            return {"cv_max_abs": float("inf")}
        values = np.concatenate(values)
        mol = self.mol

        def cv(idx, prec=reference.FLOAT64):
            frames = torch.as_tensor(self.pool[idx], device=self.device)
            with prec.scope():
                feats = reference.features(frames, mol.ca_index, mol.pairs, mol.quads, prec)
                return reference.served_cv(feats, self.weights, self.options, prec)

        if p is not reference.FLOAT64:
            values = np.concatenate([cv(rows[s:s + 16384], p).cpu().numpy()
                                     for s in range(0, len(rows), 16384)])
        return max_abs_by_column_group(values, rows, cv,
                                       {"cv_max_abs": slice(None)}, self.device)

    def check(self) -> dict:
        return self._check(reference.FLOAT64)

    def control_check(self) -> dict:
        """The reference in the program's place, in float32 with TF32
        matrix products."""
        return self._check(reference.Precision(torch.float32, "tf32"))

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
