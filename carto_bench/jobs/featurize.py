"""Featurize: a DCD on disk to the (frames, features) matrix on the host
through `Featurizer.featurize_trajectory` (decode, upload, K1 and the
dihedrals, the copy back), one pass over the file a call.

Checked: the whole of the last pass, and rows drawn from the seed of every
other pass, against the reference's float64 features of the coordinates
the file was written from.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from carto_bench import reference, synth
from carto_bench.jobs.common import inputs_made, max_abs_by_column_group


class Job:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        from deep_cartograph_torch.geom.engine import Featurizer
        from deep_cartograph_torch.io.topology import Topology

        self.mix, self.device = mix, torch.device(device)
        self.mol = synth.Molecule.from_config(config)
        self.dir = synth.scratch_dir("featurize")
        self.coords = synth.trajectory(config, int(config["frames"]), seed, device).cpu().numpy()
        pdb = os.path.join(self.dir, "top.pdb")
        self.dcd = os.path.join(self.dir, "traj.dcd")
        synth.write_pdb(pdb, self.mol, self.coords[0])
        synth.write_dcd(self.dcd, self.coords)
        inputs_made(device)
        self.featurizer = Featurizer(Topology.from_pdb(pdb), self.mol.labels(), device=device)
        self.rng = np.random.default_rng(seed)
        self.samples, self.last, self.control_out = [], None, None
        self.call(-1)   # first use: K1 and the DCD reader load, the allocator fills

    def featurize(self, upload: str) -> np.ndarray:
        return self.featurizer.featurize_trajectory(
            self.dcd, frame_chunk=int(self.mix["frame_chunk"]), upload=upload)

    def call(self, i: int) -> dict:
        out = self.featurize(self.mix["upload"])
        n = min(int(self.mix["check_rows"]), len(out))
        rows = np.sort(self.rng.choice(len(out), n, replace=False))
        self.samples.append((rows, out[rows]))
        self.last = out
        return {"frames": len(out)}

    def end_to_end(self, window) -> dict:
        return {"featurize_fps": window.total("frames") / window.seconds}

    def prepare_control(self) -> None:
        """The program's own lower-precision transport: the int16 upload."""
        self.control_out = self.featurize("int16")

    def release(self) -> None:
        self.featurizer = None

    def _gaps(self, rows: np.ndarray, values: np.ndarray) -> dict:
        mol, coords = self.mol, self.coords
        n_dist = len(mol.pairs)
        groups = {"dist_max_abs_nm": slice(0, n_dist),
                  "sincos_max_abs": slice(n_dist, mol.n_features)}

        def ref(idx):
            block = torch.as_tensor(coords[idx], device=self.device)
            return reference.features(block, mol.ca_index, mol.pairs, mol.quads)

        if values.shape != (len(rows), mol.n_features):
            return {name: float("inf") for name in groups}
        return max_abs_by_column_group(values, rows, ref, groups, self.device)

    def _check(self, last: np.ndarray, samples) -> dict:
        worst = {}
        parts = [(np.arange(len(self.coords)), last)] if last is not None else []
        if last is not None and len(last) != len(self.coords):
            return {"dist_max_abs_nm": float("inf"), "sincos_max_abs": float("inf")}
        for rows, values in parts + list(samples):
            for k, v in self._gaps(rows, values).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst

    def check(self) -> dict:
        return self._check(self.last, self.samples[:-1])

    def control_check(self) -> dict:
        return self._check(self.control_out, [])

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
