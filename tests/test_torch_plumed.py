"""The port's PLUMED deployment files against the JAX package's, on the CPU:
every builder of plumed/command.py (same text for the same arguments); for
each ported family (PCA, TICA, HTICA, deep-TICA, AE, VAE) a model.zip
written by the JAX package, loaded into both packages, exported by each
with write_plumed_files under every bias method and with the waypoint RMSD
restraint (the same file lists; the inputs equal after the header line,
which names the port; the PDBs equal byte for byte); the TorchScript
weights against the JAX export (1e-6); the linear inputs evaluated on the
trajectory against the projection (1e-4); the RMSD template and the
waypoint reference against the JAX package's."""

import copy
import os
import zipfile

import numpy as np
import pytest
import torch

from deep_cartograph_tpu.cv import cv_calculators_map as jax_calculators
from deep_cartograph_tpu.cv.base import CVCalculator as JaxCVCalculator
from deep_cartograph_tpu.geom import structure as jax_structure
from deep_cartograph_tpu.io.colvars import write_colvars
from deep_cartograph_tpu.io.topology import Topology as JaxTopology
from deep_cartograph_tpu.plumed import command as jax_command
from deep_cartograph_torch.cv import CVCalculator
from deep_cartograph_torch.geom import structure
from deep_cartograph_torch.plumed import command
from deep_cartograph_torch.plumed.assembler import HEADER
from tests.fixtures import make_backbone_system
from tests.test_cv import base_config
from tests.test_golden import GOLDEN_DIR, _feature_labels, _fixture_system
from tests.test_plumed_semantics import evaluate_plumed_input

torch.set_num_threads(2)

CVS = ("pca", "tica", "htica", "deep_tica", "ae", "vae")
LINEAR = ("pca", "tica", "htica")
METHODS = ("wt_metadynamics", "opes_metad", "opes_metad_explore", "opes_expanded")
TORCHSCRIPT_TOL = 1e-6
LINEAR_INPUT_TOL = 1e-4


# ---------------------------------------------------------------------------
# The builders
# ---------------------------------------------------------------------------

_ARGS = ["cv.node-0", "cv.node-1"]
BUILDER_CALLS = {
    "molinfo": [("t.pdb",), ("t.pdb", "protein")],
    "wholemolecules": [([1, 2, 3, 48],)],
    "fit_to_template": [("fit_template.pdb",)],
    "position": [("coord-@CA_3", "@CA-3")],
    "distance": [("d", ["@CA-1", "@CA-5"]), ("d", "center_a,@CA-5")],
    "custom": [("s", "sin(x)", ["tor"]), ("s", "cos(x)", ["tor"], True)],
    "torsion": [("t", ["@CA-1", "@CA-2", "@CA-3", "@CA-4"]), ("t", "@phi-2")],
    "alphabeta": [("ab", [1, 2, 3, 4], 0.5)],
    "sin_old": [("so", [1, 2, 3, 4])],
    "cos_old": [("co", [1, 2, 3, 4])],
    "read": [("r", "colvars.dat", "a", True), ("r", "colvars.dat", "a,b", False)],
    "combine": [("c", ["a", "b"]),
                ("c", ["a", "b"], [0.1, np.float32(1 / 3)], [np.float64(2 / 3), -1e-9],
                 [1, 2], True)],
    "rmsd": [("rmsd", "ref.pdb"), ("rmsd", "ref.pdb", "SIMPLE")],
    "upper_walls": [("w", ["rmsd"], [0.4], [5000.0]),
                    ("w", ["a", "b"], [0.1, 0.2], [1.0, 2.0], [2, 4], [1.0, 1.0],
                     [0.0, 0.1])],
    "print_": [(_ARGS, "out.dat"), (_ARGS, "out.dat", 10, "%.6f")],
    "histogram": [("h", _ARGS, [-1, -1], [1, 1], 1, "GAUSSIAN", "true"),
                  ("h", _ARGS, [-1, -1], [1, 1], 5, "DISCRETE", "ndata", [50, 50],
                   [0.1, 0.1], "bias", 100)],
    "dumpgrid": [(["h"], "h.dat"), (["h"], "h.dat", 100)],
    "convert_to_fes": [("f", ["h"], 300.0), ("f", ["h"], 310.5, False)],
    "reweight_bias": [("rw", ["opes.bias"], 300.0)],
    "external": [("ext", _ARGS, "bias.grid")],
    "opes_metad": [("opes", _ARGS, 300.0, 500, [0.05, 0.05], 50.0, 0.1)],
    "opes_metad_explore": [("opes", _ARGS, 300.0, 500, [0.05, 0.05], 50.0, 0.1)],
    "opes_expanded": [("opes", ["ecv.*"], 500, 100)],
    "ecv_umbrellas_line": [("ecv", _ARGS, 300.0, [-1.0, -1.0], [1.0, 1.0],
                            [0.05, 0.05], 50.0)],
    "metad": [("metad", _ARGS, [0.05, 0.05], 1.0, 10.0, 300.0, 500, [-1, -1],
               [1, 1], [300, 300])],
    "com": [("com", [1, 2, 3])],
    "center": [("center_a", [1, 2, 3]), ("center_a", "1-12")],
    "pytorch_model": [("ae", _ARGS, "ae_weights.pt")],
}


def test_every_builder_is_exercised():
    public = {name for name, value in vars(command).items()
              if callable(value) and not name.startswith("_")
              and value.__module__ == command.__name__}
    assert public == set(BUILDER_CALLS) | {"print"}
    assert command.print is command.print_


@pytest.mark.parametrize("name", sorted(BUILDER_CALLS))
def test_builder_text_matches_jax(name):
    for args in BUILDER_CALLS[name]:
        ours = getattr(command, name)(*args)
        theirs = getattr(jax_command, name)(*args)
        assert ours == theirs, args
        assert ours.endswith("\n")


# ---------------------------------------------------------------------------
# write_plumed_files on a model.zip that the JAX package wrote
# ---------------------------------------------------------------------------

def _config():
    cfg = base_config()
    cfg["training"]["general"].update({"num_tries": 2, "max_epochs": 6,
                                       "batch_size": 16})
    return cfg


def _write_waypoints(system, folder):
    """Three waypoint PDBs of the fixture: the first and last frames, and the
    first frame rotated, shifted and with residues 1-2 moved 4 Angstrom (so
    the alignment matters and those residues fall past the 2 Angstrom
    threshold)."""
    top = JaxTopology.from_pdb(system.pdb_path)
    theta = 0.7
    rot = np.array([[np.cos(theta), -np.sin(theta), 0.0],
                    [np.sin(theta), np.cos(theta), 0.0],
                    [0.0, 0.0, 1.0]], np.float32)
    moved = system.coords[0] @ rot.T + np.float32(5.0)
    moved[:2, 0] += np.float32(4.0)
    paths = []
    for k, positions in enumerate((system.coords[0], system.coords[-1], moved)):
        path = os.path.join(folder, f"waypoint_{k}.pdb")
        top.write_pdb(path, positions=positions)
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def jax_zips(tmp_path_factory):
    """Every family trained by the JAX package on the golden fixture and
    saved as model.zip; the fixture system, the waypoints, the features, the
    zips and the JAX calculators that wrote them."""
    tmp = str(tmp_path_factory.mktemp("plumed"))
    system = _fixture_system(tmp)
    features = np.load(os.path.join(GOLDEN_DIR, "features.npy"))
    path = os.path.join(tmp, "colvars.dat")
    write_colvars(path, np.column_stack([np.arange(60, dtype=np.float32), features]),
                  ["time"] + _feature_labels(), fmt="%.9g")
    zips, runs = {}, {}
    for cv in CVS:
        calc = jax_calculators[cv](configuration=_config(), output_path=tmp)
        calc.load_training_data([path], [system.pdb_path],
                                features_list=_feature_labels())
        calc.run()
        zips[cv] = os.path.join(tmp, cv, "model.zip")
        runs[cv] = calc
    return system, _write_waypoints(system, tmp), features, zips, runs


def _export(pkg, source, folder, topology, bias=None, waypoints=None):
    """Write the PLUMED files of `source` into `folder`: a zip loaded into
    `pkg` ("port" or "jax"), or (`pkg` "run") the JAX calculator that wrote
    it. Returns the calculator and {zip name: {member: bytes}}."""
    os.makedirs(folder)
    if pkg == "port":
        calc = CVCalculator.load(source, os.path.join(folder, "load"), device="cpu")
    elif pkg == "jax":
        calc = JaxCVCalculator.load(source, os.path.join(folder, "load"))
    else:
        calc = source
    calc.bias = {} if bias is None else bias
    calc.write_plumed_files(topology, folder, waypoints)
    written = {}
    for name in sorted(os.listdir(folder)):
        if name.endswith(".zip"):
            with zipfile.ZipFile(os.path.join(folder, name)) as zf:
                written[name] = {m: zf.read(m) for m in zf.namelist()}
    return calc, written


def _bias(method, rmsd_restraint=False):
    bias = copy.deepcopy(base_config()["bias"])
    bias["method"] = method
    bias["add_rmsd_restraint"] = rmsd_restraint
    return bias


def _assert_exports_match(ours, theirs, cv, inputs=True):
    """The same zips and members; inputs equal after the header line (unless
    not `inputs`), the port's header naming the port; the PDBs byte for
    byte. TorchScript weights are compared by value (test below)."""
    assert list(ours) == list(theirs)
    for name, members in theirs.items():
        assert list(ours[name]) == list(members), name
        for member, data in members.items():
            got = ours[name][member]
            if member.endswith(".dat"):
                head, _, body = got.decode().partition("\n")
                jax_head, _, jax_body = data.decode().partition("\n")
                assert head + "\n" == HEADER and jax_head.startswith("# PLUMED input")
                assert body == jax_body or not inputs, (name, member)
            elif member.endswith(".pt"):
                assert member == f"{cv}_weights.pt"
            else:
                assert got == data, (name, member)


def _exports(jax_zips, tmp_path, cv, bias=None, waypoints=None):
    """The PLUMED files of the JAX package's zip loaded into the port, and
    the JAX package's, both from the zip and from the calculator that wrote
    it; held to each other (`_assert_exports_match`)."""
    system, _, _, zips, runs = jax_zips
    exports = {pkg: _export(pkg, source, str(tmp_path / pkg), system.pdb_path, bias,
                            waypoints)[1]
               for pkg, source in (("port", zips[cv]), ("jax", zips[cv]),
                                   ("run", runs[cv]))}
    _assert_exports_match(exports["port"], exports["run"], cv)
    if cv in LINEAR:
        # The JAX package drops a loaded linear CV's feature normalization
        # (ROADMAP Queue 3); the port writes it, as for the calculator run
        _assert_exports_match(exports["port"], exports["jax"], cv, inputs=False)
        text = exports["jax"][f"plumed_{cv}_unbiased.zip"][f"plumed_input_{cv}.dat"]
        assert b"# Normalized features" not in text
    else:
        _assert_exports_match(exports["port"], exports["jax"], cv)
    return exports["port"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("cv", CVS)
def test_plumed_zips_match_jax(jax_zips, tmp_path, cv, method):
    ours = _exports(jax_zips, tmp_path, cv, _bias(method))
    assert list(ours) == [f"plumed_{cv}_biased.zip", f"plumed_{cv}_unbiased.zip"]
    assert f"plumed_input_{cv}_{method}.dat" in ours[f"plumed_{cv}_biased.zip"]


@pytest.mark.parametrize("cv", CVS)
def test_plumed_zips_with_rmsd_restraint_match_jax(jax_zips, tmp_path, cv):
    """add_rmsd_restraint with the three waypoints: the biased zip carries
    the waypoint reference and the RMSD wall, as the JAX package's."""
    exports = {"port": _exports(jax_zips, tmp_path, cv, _bias("opes_metad", True),
                                jax_zips[1])}
    biased = exports["port"][f"plumed_{cv}_biased.zip"]
    assert "rmsd_restraint_reference.pdb" in biased
    text = biased[f"plumed_input_{cv}_opes_metad.dat"].decode()
    assert "rmsd_restraint: RMSD REFERENCE=rmsd_restraint_reference.pdb" in text


def test_loaded_zip_without_bias_writes_the_unbiased_input(jax_zips, tmp_path):
    """A model loaded from a zip carries no bias configuration: only the
    unbiased zip is written, as by the JAX package."""
    ours = _exports(jax_zips, tmp_path, "tica")
    assert list(ours) == ["plumed_tica_unbiased.zip"]
    assert sorted(os.listdir(tmp_path / "port")) == ["load", "plumed_tica_unbiased.zip"]


@pytest.mark.parametrize("cv", ["deep_tica", "ae", "vae"])
def test_plumed_torchscript_matches_jax_export(jax_zips, tmp_path, cv):
    """The `<cv>_weights.pt` of the two packages' zips on the same inputs:
    within 1e-6 of each other, and of the port's projection."""
    system, _, features, zips, _ = jax_zips
    runs = {pkg: _export(pkg, zips[cv], str(tmp_path / pkg), system.pdb_path,
                         _bias("opes_metad")) for pkg in ("port", "jax")}
    x = torch.from_numpy(features)
    outs = {}
    for pkg, (_, written) in runs.items():
        path = str(tmp_path / f"{pkg}.pt")
        with open(path, "wb") as fh:
            fh.write(written[f"plumed_{cv}_unbiased.zip"][f"{cv}_weights.pt"])
        with torch.no_grad():
            outs[pkg] = torch.jit.load(path)(x).numpy()
    assert outs["port"].shape == (len(features), 2)
    np.testing.assert_allclose(outs["port"], outs["jax"], atol=TORCHSCRIPT_TOL)
    np.testing.assert_allclose(outs["port"], runs["port"][0].project_data(features),
                               atol=TORCHSCRIPT_TOL)


@pytest.mark.parametrize("cv", ["pca", "tica", "htica"])
def test_linear_plumed_input_evaluates_to_the_projection(jax_zips, tmp_path, cv):
    """The port's unbiased input, read as PLUMED would (DISTANCE, TORSION,
    CUSTOM, COMBINE) on the fixture's frames, against the port's
    projection of the same frames' features."""
    system, _, features, zips, _ = jax_zips
    calc, written = _export("port", zips[cv], str(tmp_path / "port"), system.pdb_path)
    text = written[f"plumed_{cv}_unbiased.zip"][f"plumed_input_{cv}.dat"].decode()
    values = evaluate_plumed_input(text, system.coords.astype(np.float64),
                                   JaxTopology.from_pdb(system.pdb_path))
    want = calc.project_data(features)
    for i in range(2):
        np.testing.assert_allclose(values[f"norm_{cv}_{i}"], want[:, i],
                                   atol=LINEAR_INPUT_TOL)


# ---------------------------------------------------------------------------
# The structures
# ---------------------------------------------------------------------------

def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("align", [True, False])
def test_waypoint_reference_matches_jax(jax_zips, tmp_path, align):
    """The RMSD restraint's reference: the same CA atoms marked, the same
    bytes, with the waypoints aligned (Kabsch) or not."""
    system, waypoints, _, _, _ = jax_zips
    ours, theirs = str(tmp_path / "port.pdb"), str(tmp_path / "jax.pdb")
    structure.create_rmsd_waypoint_reference(waypoints, system.pdb_path, ours, align,
                                             device="cpu")
    jax_structure.create_rmsd_waypoint_reference(waypoints, system.pdb_path, theirs, align)
    assert _read(ours) == _read(theirs)
    marked = [float(line[54:60]) for line in _read(ours).decode().splitlines()
              if line.startswith("ATOM")]
    if align:  # residues 1-2 moved 4 Angstrom in one waypoint: the fit
        # takes part of it, residue 1 stays past the threshold
        assert marked[0] == 0.0 and len(marked) - 2 <= sum(marked) < len(marked)
    else:  # and every residue, rotated
        assert sum(marked) == 0


@pytest.mark.parametrize("selections", [("backbone", "backbone"), ("name CA", "name N")])
def test_rmsd_template_matches_jax(tmp_path, selections):
    """The FIT_TO_TEMPLATE template on a backbone peptide: occupancy on the
    alignment atoms, B-factor on the RMSD atoms, the same bytes."""
    system = make_backbone_system(str(tmp_path / "system"))
    ours, theirs = str(tmp_path / "port.pdb"), str(tmp_path / "jax.pdb")
    structure.create_plumed_rmsd_template(system.pdb_path, ours, *selections)
    jax_structure.create_plumed_rmsd_template(system.pdb_path, theirs, *selections)
    assert _read(ours) == _read(theirs)
    with pytest.raises(ValueError, match="is empty"):
        structure.create_plumed_rmsd_template(system.pdb_path, ours, "name XYZ")
