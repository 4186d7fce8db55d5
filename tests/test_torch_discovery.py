"""The port's feature discovery (deep_cartograph_torch/features/discovery.py,
common.py) and multi-trajectory featurization (geom/engine.py) against the
JAX package's, on the CPU."""

import os

import numpy as np
import pytest

import deep_cartograph_torch.features.discovery as td
import deep_cartograph_tpu.features.discovery as jd
from deep_cartograph_torch.features.common import find_common_features
from deep_cartograph_torch.geom.engine import Featurizer, featurize_trajectory
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.io.traj import write_traj
from deep_cartograph_tpu.features.common import (
    find_common_features as jax_find_common_features,
)
from deep_cartograph_tpu.geom.engine import Featurizer as JaxFeaturizer
from deep_cartograph_tpu.geom.engine import featurize_trajectory as jax_featurize_trajectory
from deep_cartograph_tpu.io.topology import Topology as JaxTopology
from tests.fixtures import make_backbone_system, make_shifted_ca_pdb

FEATURE_TOL = 1e-5   # nm / radians, float32 geometry in two programs

DISTANCES = {
    "all": {"first_selection": "all", "second_selection": "all"},
    "strides_neighbors": {"first_selection": "name CA", "second_selection": "all",
                          "first_stride": 2, "second_stride": 3,
                          "skip_neigh_residues": True},
    "bonded": {"first_selection": "all", "second_selection": "name C or name N",
               "skip_bonded_atoms": True},
}


@pytest.fixture(scope="module")
def backbone(tmp_path_factory):
    return make_backbone_system(str(tmp_path_factory.mktemp("backbone")),
                                n_residues=5, n_frames=40)


def configs():
    cases = {f"dist_{k}": {"distance_groups": {"g": v}} for k, v in DISTANCES.items()}
    cases["coordinates"] = {"coordinate_groups": {"c": {"selection": "name CA",
                                                        "stride": 2}}}
    for mode in ("virtual", "protein_backbone", "real"):
        cases[f"dihedral_{mode}"] = {"dihedral_groups": {"d": {"selection": "all",
                                                               "search_mode": mode}}}
    cases["dihedral_torsions"] = {"dihedral_groups": {"d": {
        "selection": "name CA", "search_mode": "virtual", "periodic_encoding": False}}}
    cases["every_group"] = {
        "coordinate_groups": {"c": {"selection": "name N"}},
        "distance_groups": {"a": DISTANCES["all"], "b": DISTANCES["bonded"]},
        "dihedral_groups": {"d": {"search_mode": "real"}},
        "distance_to_center_groups": {"t": {"selection": "name CA",
                                            "center_selection": "name CA"}},
    }
    return cases


@pytest.mark.parametrize("case", sorted(configs()))
@pytest.mark.parametrize("system", ["ca", "backbone"])
def test_get_features_list_equals_jax(case, system, ca_system, backbone):
    config = configs()[case]
    pdb = ca_system.pdb_path if system == "ca" else backbone.pdb_path
    got = outcome(td.get_features_list, config, pdb)
    assert got == outcome(jd.get_features_list, config, pdb)
    # A CA-only chain has no N or C atoms, and its CA atoms lie 3.8 A apart,
    # so no bond is guessed and no real dihedral is found.
    assert got[0] == "error" if system == "ca" and ("real" in str(config)
                                                    or "name C " in str(config)) \
        else len(got[1]) > 0


def outcome(fn, *args):
    """("labels", result) or ("error", message) of fn(*args)."""
    try:
        return "labels", fn(*args)
    except ValueError as exc:
        return "error", str(exc)


def test_dihedral_searches_equal_jax(backbone, ca_system):
    for pdb in (ca_system.pdb_path, backbone.pdb_path):
        top, jtop = Topology.from_file(pdb), JaxTopology.from_file(pdb)
        for mode in ("virtual", "protein_backbone", "real"):
            assert td.find_dihedrals(top, "all", mode) == jd.find_dihedrals(jtop, "all", mode)
        with pytest.raises(ValueError, match="not supported"):
            td.find_dihedrals(top, "all", "nope")


@pytest.mark.parametrize("call", [
    lambda m, top: m.find_distances(top, "name XX", "all", 1, 1, False, False),
    lambda m, top: m.find_distances(top, "all", "name XX", 1, 1, False, False),
    lambda m, top: m.find_coordinates(top, "name XX", 1),
    lambda m, top: m.find_virtual_dihedrals(top, "name XX"),
    lambda m, top: m.find_real_dihedrals(top, "name XX"),
    lambda m, top: m.get_features_list({}, top.source_path),
])
def test_discovery_errors_equal_jax(call, ca_system):
    with pytest.raises(ValueError) as port_err:
        call(td, Topology.from_file(ca_system.pdb_path))
    with pytest.raises(ValueError) as jax_err:
        call(jd, JaxTopology.from_file(ca_system.pdb_path))
    assert str(port_err.value) == str(jax_err.value)


def test_find_common_features_equals_jax(tmp_path, ca_system):
    shifted = make_shifted_ca_pdb(str(tmp_path), ca_system, resid_offset=100)
    config = {"distance_groups": {"g": DISTANCES["all"]},
              "dihedral_groups": {"d": {"search_mode": "virtual"}}}
    topologies = [ca_system.pdb_path, shifted]
    got = find_common_features(config, topologies, output_folder=str(tmp_path / "port"))
    want = jax_find_common_features(config, topologies, output_folder=str(tmp_path / "jax"))
    assert got == want and len(got) > 0
    assert (open(tmp_path / "port" / "common_features.txt").read()
            == open(tmp_path / "jax" / "common_features.txt").read())
    assert find_common_features(config, topologies, reference_topology=shifted) == \
        jax_find_common_features(config, topologies, reference_topology=shifted)


# ---------------------------------------------------------------------------
# Multi-trajectory featurization
# ---------------------------------------------------------------------------

LABELS = ["dist-@CA_1-@CA_5", "dist-@CA_2-@CA_9", "dist-@CA_3-@CA_12",
          "sin-@CA_1-@CA_2-@CA_3-@CA_4", "cos-@CA_5-@CA_6-@CA_7-@CA_8",
          "tor-@CA_8-@CA_9-@CA_10-@CA_11"]


@pytest.mark.parametrize("suffix", [".dcd", ".xtc"])
@pytest.mark.parametrize("frame_chunk,stride", [(16, 1), (7, 2), (64, 1)])
def test_featurize_trajectories_equals_jax(tmp_path, ca_system, suffix, frame_chunk,
                                           stride):
    """Three trajectories of uneven length, so that the seams fall inside the
    shared chunks; the concatenation equals the single trajectory."""
    coords = ca_system.coords
    parts = np.split(coords, [11, 37])
    paths = []
    for i, part in enumerate(parts):
        paths.append(str(tmp_path / f"part{i}{suffix}"))
        write_traj(paths[-1], part)
    whole = str(tmp_path / f"whole{suffix}")
    write_traj(whole, coords)
    top = Topology.from_pdb(ca_system.pdb_path)
    port = Featurizer(top, LABELS, device="cpu")
    got = port.featurize_trajectories(paths, traj_stride=stride, frame_chunk=frame_chunk)
    jax = JaxFeaturizer(JaxTopology.from_pdb(ca_system.pdb_path), LABELS, device="cpu")
    want = jax.featurize_trajectories(paths, traj_stride=stride, frame_chunk=frame_chunk)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=FEATURE_TOL, rtol=0)
    single = port.featurize_trajectory(whole, frame_chunk=frame_chunk)
    if stride == 1:
        np.testing.assert_array_equal(np.concatenate(got), single)
    else:
        np.testing.assert_array_equal(
            np.concatenate(got), np.concatenate([single[:11:2], single[11:37][::2],
                                                 single[37:][::2]]))
    order = [p for p, _ in port.iter_featurize_trajectories(paths, frame_chunk=frame_chunk)]
    assert order == paths


def test_featurize_trajectories_timeout_is_per_trajectory(tmp_path, ca_system):
    path = str(tmp_path / "t.dcd")
    write_traj(path, ca_system.coords)
    port = Featurizer(Topology.from_pdb(ca_system.pdb_path), LABELS, device="cpu")
    assert len(port.featurize_trajectories([path, path], timeout=60.0)) == 2
    with pytest.raises(TimeoutError, match="t.dcd"):
        port.featurize_trajectories([path], frame_chunk=8, timeout=-1.0)


def test_featurize_trajectory_helper_equals_jax(ca_system):
    got = featurize_trajectory(ca_system.dcd_path, ca_system.pdb_path, LABELS,
                               traj_stride=3, frame_chunk=16, device="cpu")
    want = jax_featurize_trajectory(ca_system.dcd_path, ca_system.pdb_path, LABELS,
                                    traj_stride=3, frame_chunk=16, device="cpu")
    np.testing.assert_allclose(got, want, atol=FEATURE_TOL, rtol=0)
    assert got.shape == (20, len(LABELS))
    assert os.path.exists(ca_system.dcd_path)
