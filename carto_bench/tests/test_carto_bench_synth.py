"""The inputs made from a seed."""

import numpy as np
import pytest
import torch

from carto_bench import synth
from carto_bench.harness import Cell

LAMBDA = Cell.find("lambda80.featurize").config


def test_same_seed_same_trajectory_other_seed_another():
    a = synth.trajectory(LAMBDA, 50, 2**31 + 5, "cpu")
    b = synth.trajectory(LAMBDA, 50, 2**31 + 5, "cpu")
    c = synth.trajectory(LAMBDA, 50, 2**31 + 6, "cpu")
    assert a.shape == (50, 320, 3) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_protein_spacing_and_feature_counts():
    mol = synth.Molecule.from_config(LAMBDA)
    assert (mol.n_atoms, len(mol.pairs), len(mol.quads), mol.n_features) == (320, 3081, 77, 3235)
    assert len(mol.labels()) == mol.n_features == LAMBDA["features"]["n_features"]
    assert mol.labels()[0] == "dist-@CA_1-@CA_3"
    assert mol.labels()[-1] == "cos-@CA_77-@CA_78-@CA_79-@CA_80"
    coords = synth.trajectory(LAMBDA, 200, 7, "cpu").numpy()
    ca = coords[:, mol.ca_index]
    bond = np.linalg.norm(np.diff(ca, axis=1), axis=-1)
    assert 3.5 < float(np.median(bond)) < 4.5   # 3.8 at rest, modes and jitter about it


def test_dcd_holds_the_coordinates(tmp_path):
    from deep_cartograph_torch.io.dcd import read_dcd

    coords = synth.trajectory(LAMBDA, 37, 11, "cpu").numpy()
    path = str(tmp_path / "t.dcd")
    synth.write_dcd(path, coords, block=10)
    assert np.array_equal(read_dcd(path), coords)


def test_log_lengths_same_set_for_every_seed():
    a = synth.log_lengths(2000, 200000, 64, 1)
    b = synth.log_lengths(2000, 200000, 64, 2**31 + 3)
    assert sorted(a) == sorted(b) and not np.array_equal(a, b)
    assert a.min() == 2000 and a.max() == 200000


@pytest.mark.parametrize("seed", [0, 2**31 + 1])
def test_served_weights_repeat(seed):
    w1 = synth.dense_weights([10, 4, 2], seed, "cpu")
    w2 = synth.dense_weights([10, 4, 2], seed, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert w1["nn/dense_0/kernel"].shape == (10, 4)
