"""The port's tools against the JAX package's, on the CPU, on the CA system
(12 residues, 60 frames) with the same configurations: the same files,
the same CSV headers and row counts, PLUMED inputs equal after the header
line, and the values within one step of the CSVs' %.4f (1.0001e-4) where
both packages compute the same thing. Deep-TICA and the AE start from the
JAX package's initial parameters; the VAE and UMAP draw their own noise,
so they are held to their own model.zip projections."""

import copy
import csv
import importlib
import os
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from deep_cartograph_torch import tools as port_tools
from deep_cartograph_torch.cv.base import CVCalculator
from deep_cartograph_torch.cv.deep import NonLinear
from deep_cartograph_torch.io.traj import read_traj
from deep_cartograph_torch.models.weights import params_from_flax
from deep_cartograph_tpu import tools as jax_tools
from deep_cartograph_tpu.cv.deep import NonLinear as JaxNonLinear
from tests.fixtures import make_ca_system
from tests.test_torch_jax_native import jax_native, jax_native_library  # noqa: F401

torch.set_num_threads(2)

STEP = 1.0001e-4  # one step of %.4f
ROUNDING = 5.0001e-5  # half a step: a value against its %.4f rounding

# Files only one package writes: figures, logs, the JAX package's Orbax
# mirror of each try checkpoint, and the unzipped copy of each model that
# traj_projection loads (<cv>/model/): the JAX package unzips every model
# into one shared folder, and a model loaded before and not yet collected
# leaves its files in the next one's copy (the port empties the folder).
SKIPPED = (".png", ".log")


def _is_model_copy(dirpath):
    path = Path(dirpath)
    return path.name == "model" and path.parent.parent.name == "traj_projection"


def file_tree(root):
    out = []
    for dirpath, _, files in os.walk(root):
        if _is_model_copy(dirpath):
            continue
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), root)
            if rel.endswith(SKIPPED) or f"{os.sep}orbax{os.sep}" in rel:
                continue
            out.append(rel)
    return sorted(out)


def assert_same_tree(jax_root, port_root):
    assert file_tree(port_root) == file_tree(jax_root)


def read_table(path):
    """A CSV as (header, rows of strings)."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    return rows[0], rows[1:]


def assert_same_table(jax_path, port_path, tol=0.0, columns=None):
    """Same header and rows; numeric cells within `tol` (only in
    `columns` when given, the others equal)."""
    jh, jrows = read_table(jax_path)
    ph, prows = read_table(port_path)
    assert ph == jh
    assert len(prows) == len(jrows)
    for jr, pr in zip(jrows, prows):
        for name, a, b in zip(jh, jr, pr):
            if a == b:
                continue
            assert columns is None or name in columns, (port_path, name, a, b)
            assert abs(float(a) - float(b)) <= tol, (port_path, name, a, b)


def cv_values(path):
    header, rows = read_table(path)
    return header, np.array(rows, dtype=np.float64).reshape(len(rows), -1)


def assert_same_plumed_text(jax_text, port_text, tol=0.0):
    """Equal after the header line; with `tol`, numbers may differ by it."""
    jbody = jax_text.partition("\n")[2].split()
    pbody = port_text.partition("\n")[2].split()
    assert len(pbody) == len(jbody)
    for a, b in zip(jbody, pbody):
        if a == b:
            continue
        ka, _, va = a.rpartition("=")
        kb, _, vb = b.rpartition("=")
        assert ka == kb, (a, b)
        na = np.array(va.split(","), np.float64)
        nb = np.array(vb.split(","), np.float64)
        np.testing.assert_allclose(nb, na, atol=tol, rtol=0)


def assert_same_zip(jax_zip, port_zip, tol=0.0):
    """The same members; PLUMED inputs equal after their header line,
    weights files present, every other member byte for byte."""
    with zipfile.ZipFile(jax_zip) as jz, zipfile.ZipFile(port_zip) as pz:
        assert pz.namelist() == jz.namelist()
        for member in jz.namelist():
            if member.endswith(".dat"):
                assert_same_plumed_text(jz.read(member).decode(),
                                        pz.read(member).decode(), tol)
            elif not member.endswith(".pt"):
                assert pz.read(member) == jz.read(member), member


def assert_same_configuration(jax_folder, port_folder):
    with open(os.path.join(jax_folder, "configuration.yml")) as fh:
        want = yaml.safe_load(fh)
    with open(os.path.join(port_folder, "configuration.yml")) as fh:
        assert yaml.safe_load(fh) == want


class InitialParameters:
    """Records the JAX package's initial parameters of each deep CV and
    hands them to the port's calculator of the same CV."""

    def __init__(self, monkeypatch):
        self.params = {}
        jax_init = JaxNonLinear._init_params_stack
        port_init = NonLinear._init_params_stack
        recorded = self.params

        def record(calc, rngs):
            out = jax_init(calc, rngs)
            recorded[calc.cv_name] = jax.tree.map(np.asarray, out)
            return out

        def carried(calc, seeds):
            port_init(calc, seeds)  # builds the module
            return params_from_flax(recorded[calc.cv_name])

        monkeypatch.setattr(JaxNonLinear, "_init_params_stack", record)
        monkeypatch.setattr(NonLinear, "_init_params_stack", carried)


def features_config():
    return {
        "plumed_settings": {
            "traj_stride": 1,
            "features": {
                "distance_groups": {
                    "ca_dist": {
                        "first_selection": "name CA",
                        "second_selection": "name CA",
                        "first_stride": 1,
                        "second_stride": 3,
                        "skip_neigh_residues": True,
                        "skip_bonded_atoms": False,
                    }
                },
                "dihedral_groups": {
                    "tors": {
                        "selection": "name CA",
                        "periodic_encoding": True,
                        "search_mode": "virtual",
                    }
                },
            },
        },
        "engine": {"frame_chunk": 16},
    }


FILTER_CONFIG = {
    "filter_settings": {
        "diptest_significance_level": None,
        "entropy_quantile": None,
        # 10 of the 44 features: the TICA covariance of so few is well
        # conditioned (~2e3), so float32 rounding moves the TICA and HTICA
        # projections by ~3e-5, below one step of %.4f
        "std_quantile": 0.8,
    }
}

ALL_CVS = ["pca", "tica", "htica", "deep_tica", "ae", "vae", "umap"]
HELD_TO_JAX = ["pca", "tica", "htica", "deep_tica", "ae"]


def train_config():
    return {
        "cvs": ALL_CVS,
        "common": {
            "dimension": 2,
            "lag_time": 1,
            "num_subspaces": 2,
            "subspaces_dimension": 2,
            "n_neighbors": 10,
            "features_normalization": "mean_std",
            "architecture": {"encoder": {"layers": [8], "activation": ["tanh"]}},
            "training": {
                "general": {
                    "num_tries": 1,
                    "seed": 42,
                    "batch_size": 16,
                    "max_epochs": 6,
                    "check_val_every_n_epoch": 1,
                },
                "optimizer": {"name": "Adam", "kwargs": {"lr": 1e-2}},
                "plot_loss": False,
            },
        },
        "figures": {"fes": {"compute": False}, "traj_projection": {"plot": False}},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every tool of both packages on the same inputs: (root, systems)."""
    root = tmp_path_factory.mktemp("tools")
    main = make_ca_system(str(root / "main"), 12, 60, seed=7)
    sup = make_ca_system(str(root / "sup"), 12, 20, seed=3)
    os.rename(sup.dcd_path, str(root / "sup" / "sup_traj.dcd"))
    os.rename(sup.pdb_path, str(root / "sup" / "sup_traj.pdb"))
    sup_dcd, sup_pdb = str(root / "sup" / "sup_traj.dcd"), str(root / "sup" / "sup_traj.pdb")
    with pytest.MonkeyPatch.context() as mp:
        InitialParameters(mp)
        for pkg, mod, extra in (("jax", jax_tools, {}), ("port", port_tools,
                                                           {"device": "cpu"})):
            out = root / pkg
            colvars = mod.compute_features(
                features_config(), [main.dcd_path], [main.pdb_path],
                output_folder=str(out / "compute_features"), **extra)
            sup_colvars = mod.compute_features(
                features_config(), [sup_dcd], [sup_pdb], reference_topology=main.pdb_path,
                output_folder=str(out / "compute_sup_features"), **extra)
            features = mod.filter_features(
                FILTER_CONFIG, colvars, topologies=[main.pdb_path],
                output_folder=str(out / "filter_features"), **extra)
            with open(features) as fh:
                kept = [line.strip() for line in fh if line.strip()]
            trained = mod.train_colvars(
                train_config(), colvars, [main.pdb_path], features_list=kept,
                sup_topologies=[sup_pdb], sup_traj_names=["sup_traj"],
                output_folder=str(out / "train_colvars"), **extra)
            mod.traj_projection(
                {"figures": {"fes": {"compute": False},
                             "traj_projection": {"plot": False}}},
                sup_colvars, [sup_pdb], ["sup_traj"],
                model_paths=[trained[cv]["model_path"] for cv in ALL_CVS],
                model_traj_paths=[trained[cv]["traj_paths"] for cv in ALL_CVS],
                output_folder=str(out / "traj_projection"), **extra)
    return root, main, (sup_dcd, sup_pdb)


def test_compute_features_matches_jax(runs):
    root, _, _ = runs
    for folder in ("compute_features", "compute_sup_features"):
        jax_dir, port_dir = root / "jax" / folder, root / "port" / folder
        assert_same_tree(jax_dir, port_dir)
        assert_same_configuration(jax_dir, port_dir)
        for rel in file_tree(jax_dir):
            jpath, ppath = jax_dir / rel, port_dir / rel
            if rel.endswith("colvars.dat"):
                assert ppath.read_text().partition("\n")[0] == \
                    jpath.read_text().partition("\n")[0]
                jdata = np.loadtxt(jpath, comments="#", ndmin=2)
                pdata = np.loadtxt(ppath, comments="#", ndmin=2)
                assert pdata.shape == jdata.shape
                np.testing.assert_allclose(pdata, jdata, atol=STEP, rtol=0)
            elif rel.endswith("plumed_input.dat"):
                assert_same_plumed_text(
                    jpath.read_text().replace(str(root / "jax"), str(root / "port")),
                    ppath.read_text())
            elif rel.endswith((".pdb", ".txt")):
                assert ppath.read_bytes() == jpath.read_bytes(), rel


def test_compute_features_restart_skips(runs, monkeypatch):
    root, main, _ = runs
    folder = root / "port" / "compute_features"
    colvars = folder / "ca_example" / "colvars.dat"
    before = colvars.stat().st_mtime_ns
    module = importlib.import_module("deep_cartograph_torch.tools.compute_features")
    monkeypatch.setattr(module.Featurizer, "__init__",
                        lambda *a, **k: pytest.fail("featurized again"))
    assert port_tools.compute_features(
        features_config(), [main.dcd_path], [main.pdb_path],
        output_folder=str(folder), device="cpu") == [str(colvars)]
    assert colvars.stat().st_mtime_ns == before


def test_filter_features_matches_jax(runs):
    root, _, _ = runs
    jax_dir, port_dir = root / "jax" / "filter_features", root / "port" / "filter_features"
    assert_same_tree(jax_dir, port_dir)
    assert_same_configuration(jax_dir, port_dir)
    assert (port_dir / "filtered_features.txt").read_text() == \
        (jax_dir / "filtered_features.txt").read_text()
    for rel in file_tree(jax_dir):
        if rel.endswith(".csv"):
            assert_same_table(jax_dir / rel, port_dir / rel, 1e-5)


@pytest.mark.parametrize("cv", ALL_CVS)
def test_train_colvars_matches_jax(runs, cv):
    root, _, _ = runs
    jax_dir = root / "jax" / "train_colvars" / cv
    port_dir = root / "port" / "train_colvars" / cv
    assert_same_tree(jax_dir, port_dir)
    jproj = jax_dir / "traj_data" / "colvars" / "projected_trajectory.csv"
    pproj = port_dir / "traj_data" / "colvars" / "projected_trajectory.csv"
    header, got = cv_values(pproj)
    assert got.shape == (60, 2) and np.isfinite(got).all()
    if cv in HELD_TO_JAX:
        assert_same_table(jproj, pproj, STEP)
    else:
        assert header == read_table(jproj)[0]
        served = CVCalculator.load(str(port_dir / "model.zip"),
                                   str(root / "load" / cv), device="cpu")
        if cv == "umap":
            # UMAP's training frames are its fitted embedding, kept in the zip
            want = (served.cv.embedding_ - served.cv_norm_mean) / served.cv_norm_range
        else:
            want, _ = served.project_colvars(
                [str(root / "port" / "compute_features" / "ca_example" / "colvars.dat")],
                [runs[1].pdb_path])
        np.testing.assert_allclose(got, want, atol=ROUNDING, rtol=0)
    for name in ("colvars", "sup_traj"):
        plumed = Path("traj_data") / name / "plumed_inputs"
        for zname in sorted(os.listdir(jax_dir / plumed)):
            assert_same_zip(jax_dir / plumed / zname, port_dir / plumed / zname,
                            tol=STEP if cv in ("pca", "tica", "htica") else 0.0)
    sens = Path("sensitivity_analysis")
    for rel in file_tree(jax_dir / sens):
        if rel.endswith(".csv") and cv in HELD_TO_JAX:
            jh, jrows = read_table(jax_dir / sens / rel)
            ph, prows = read_table(port_dir / sens / rel)
            assert ph == jh and [r[0] for r in prows] == [r[0] for r in jrows]


def test_train_colvars_configuration_and_restart(runs, monkeypatch):
    root, main, _ = runs
    out = root / "port" / "train_colvars"
    assert_same_configuration(root / "jax" / "train_colvars", out)
    stamps = {p: p.stat().st_mtime_ns for p in out.rglob("*") if p.is_file()}
    module = importlib.import_module("deep_cartograph_torch.tools.train_colvars")
    monkeypatch.setattr(module, "cv_calculators_map", {})
    colvars = [str(root / "port" / "compute_features" / "ca_example" / "colvars.dat")]
    port_tools.train_colvars(train_config(), colvars, [main.pdb_path],
                             output_folder=str(out), device="cpu")
    changed = [p for p, t in stamps.items() if p.stat().st_mtime_ns != t]
    assert changed == [out / "configuration.yml"]


@pytest.mark.parametrize("cv", ALL_CVS)
def test_traj_projection_matches_jax(runs, cv):
    root, _, (_, sup_pdb) = runs
    jax_dir = root / "jax" / "traj_projection"
    port_dir = root / "port" / "traj_projection"
    assert_same_tree(jax_dir, port_dir)
    rel = Path(cv) / "sup_traj" / "projected_trajectory.csv"
    header, got = cv_values(port_dir / rel)
    assert got.shape == (20, 2)
    if cv in HELD_TO_JAX:
        assert_same_table(jax_dir / rel, port_dir / rel, STEP)
    else:
        assert header == read_table(jax_dir / rel)[0]
        served = CVCalculator.load(
            str(root / "port" / "train_colvars" / cv / "model.zip"),
            str(root / "load_sup" / cv), device="cpu")
        want, _ = served.project_colvars(
            [str(root / "port" / "compute_sup_features" / "sup_traj" / "colvars.dat")],
            [sup_pdb])
        np.testing.assert_allclose(got, want, atol=ROUNDING, rtol=0)


def test_loads_into_one_folder_keep_their_own_files(runs, tmp_path):
    """Two models loaded into one output folder while the first is still
    alive (as traj_projection loads its models): each copy holds its own
    model's files only, not the first's left in the shared unzip folder."""
    root, _, _ = runs
    zips = {cv: root / "port" / "train_colvars" / cv / "model.zip" for cv in ("ae", "pca")}
    first = CVCalculator.load(str(zips["ae"]), str(tmp_path), device="cpu")
    second = CVCalculator.load(str(zips["pca"]), str(tmp_path), device="cpu")
    for calc, cv in ((first, "ae"), (second, "pca")):
        with zipfile.ZipFile(zips[cv]) as zf:
            want = sorted(os.path.relpath(m, "model") for m in zf.namelist())
        assert calc.cv_name == cv
        assert sorted(os.listdir(tmp_path / cv / "model")) == want, cv
    # the port's traj_projection keeps each model's own copy too
    for cv in ALL_CVS:
        with zipfile.ZipFile(zips.get(cv, root / "port" / "train_colvars" / cv
                                      / "model.zip")) as zf:
            want = sorted(os.path.relpath(m, "model") for m in zf.namelist())
        copy_dir = root / "port" / "traj_projection" / cv / "model"
        assert sorted(os.listdir(copy_dir)) == want, cv


def test_traj_projection_configuration(runs):
    root, _, _ = runs
    assert_same_configuration(root / "jax" / "traj_projection",
                              root / "port" / "traj_projection")


def _cluster_both(runs, tmp_path, algorithm, **settings):
    """traj_cluster of both packages on the JAX package's PCA projections
    (training and supplementary)."""
    root, main, (sup_dcd, sup_pdb) = runs
    cv_csv = str(root / "jax" / "train_colvars" / "pca" / "traj_data" / "colvars"
                 / "projected_trajectory.csv")
    sup_csv = str(root / "jax" / "traj_projection" / "pca" / "sup_traj"
                  / "projected_trajectory.csv")
    config = {"algorithm": algorithm, "figures": {"plot": False},
              "output_structures": "all", **settings}
    for pkg, fn, extra in (("jax", jax_tools.traj_cluster, {}),
                           ("port", port_tools.traj_cluster, {"device": "cpu"})):
        fn(copy.deepcopy(config), [cv_csv], [main.dcd_path], [main.pdb_path],
           sup_cv_traj_paths=[sup_csv], sup_trajectories=[sup_dcd],
           sup_topologies=[sup_pdb], output_folder=str(tmp_path / pkg), **extra)
    return tmp_path / "jax", tmp_path / "port"


def _relabelling(jax_labels, port_labels):
    pairs = set(zip(jax_labels.tolist(), port_labels.tolist()))
    mapping = dict(pairs)
    assert len(mapping) == len(pairs) == len(set(mapping.values()))
    return mapping


@pytest.mark.parametrize("algorithm,settings", [
    ("hierarchical", {"search_interval": [2, 5]}),
    ("hdbscan", {"min_cluster_size": 5, "min_samples": 3}),
])
def test_traj_cluster_matches_jax(runs, tmp_path, algorithm, settings):
    jax_dir, port_dir = _cluster_both(runs, tmp_path, algorithm, **settings)
    assert_same_configuration(jax_dir, port_dir)
    jh, jrows = read_table(jax_dir / "ca_example" / "projected_trajectory.csv")
    ph, prows = read_table(port_dir / "ca_example" / "projected_trajectory.csv")
    assert ph == jh == ["PC 1", "PC 2", "traj_label", "cluster", "centroid", "frame"]
    jcols, pcols = np.array(jrows).T, np.array(prows).T
    for i in (0, 1, 2, 5):
        assert (pcols[i] == jcols[i]).all()
    mapping = _relabelling(jcols[3].astype(int), pcols[3].astype(int))
    assert (pcols[4] == jcols[4]).all()  # the same centroid frames
    centroid_rows = np.nonzero(jcols[4] == "True")[0]
    assert sorted(os.listdir(port_dir / "centroids")) == sorted(
        f"cluster_{mapping[int(jcols[3][r])]}.pdb" for r in centroid_rows)
    for r in centroid_rows:
        jpdb = jax_dir / "centroids" / f"cluster_{jcols[3][r]}.pdb"
        ppdb = port_dir / "centroids" / f"cluster_{mapping[int(jcols[3][r])]}.pdb"
        assert ppdb.read_bytes() == jpdb.read_bytes()
    for name in os.listdir(jax_dir / "ca_example"):
        if name.endswith(".xtc"):
            label = mapping[int(name[len("cluster_"):-len(".xtc")])]
            np.testing.assert_array_equal(
                read_traj(str(port_dir / "ca_example" / f"cluster_{label}.xtc")),
                read_traj(str(jax_dir / "ca_example" / name)))
    jh, jrows = read_table(jax_dir / "sup_sup_traj" / "projected_trajectory.csv")
    ph, prows = read_table(port_dir / "sup_sup_traj" / "projected_trajectory.csv")
    assert ph == jh == ["PC 1", "PC 2", "traj_label", "cluster"]
    assert [r[:3] for r in prows] == [r[:3] for r in jrows]
    assert [int(r[3]) for r in prows] == [mapping[int(r[3])] for r in jrows]


def test_traj_cluster_kmeans_structure(runs, tmp_path):
    """k-means++ seeding differs by design: the files and the columns."""
    jax_dir, port_dir = _cluster_both(runs, tmp_path, "kmeans",
                                      search_interval=[2, 4], n_init=3)
    assert sorted(p for p in file_tree(port_dir) if "cluster_" not in p) == \
        sorted(p for p in file_tree(jax_dir) if "cluster_" not in p)
    ph, prows = read_table(port_dir / "ca_example" / "projected_trajectory.csv")
    assert ph == ["PC 1", "PC 2", "traj_label", "cluster", "centroid", "frame"]
    cluster = np.array([int(r[3]) for r in prows])
    k = len(np.unique(cluster))
    assert 2 <= k <= 4
    assert sum(r[4] == "True" for r in prows) == k
    assert len(os.listdir(port_dir / "centroids")) == k


def test_analyze_geometry_matches_jax(ca_system, tmp_path):
    config = {
        "dt_per_frame": 2.0,
        "analysis": {
            "RMSD": {"rmsd": {"title": "RMSD", "selection": "name CA",
                              "fit_selection": "name CA"}},
            "RMSF": {"rmsf": {"title": "RMSF", "selection": "name CA",
                              "fit_selection": "name CA"}},
            "dRMSD": {"drmsd": {"title": "dRMSD", "selection": "name CA",
                                "selection_stride": 2}},
        },
    }
    for pkg, fn, extra in (("jax", jax_tools.analyze_geometry, {}),
                           ("port", port_tools.analyze_geometry, {"device": "cpu"})):
        fn(copy.deepcopy(config), [ca_system.dcd_path], [ca_system.pdb_path],
           output_folder=str(tmp_path / pkg), **extra)
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    assert_same_configuration(tmp_path / "jax", tmp_path / "port")
    for rel in file_tree(tmp_path / "jax"):
        if rel.endswith(".csv"):
            want = np.loadtxt(tmp_path / "jax" / rel, delimiter=",", skiprows=1)
            got = np.loadtxt(tmp_path / "port" / rel, delimiter=",", skiprows=1)
            assert read_table(tmp_path / "port" / rel)[0] == \
                read_table(tmp_path / "jax" / rel)[0]
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_traj_augmentation_matches_jax(ca_system, tmp_path):
    config = {"num_frames": 40, "interpolation_method": "pchip", "traj_format": "dcd"}
    outs = {}
    for pkg, fn in (("jax", jax_tools.traj_augmentation),
                    ("port", port_tools.traj_augmentation)):
        outs[pkg] = fn(copy.deepcopy(config), [ca_system.dcd_path],
                       [ca_system.pdb_path], num_replicas=2,
                       output_folder=str(tmp_path / pkg))
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    assert_same_configuration(tmp_path / "jax", tmp_path / "port")
    for (jt, jp), (pt, pp) in zip(zip(*outs["jax"]), zip(*outs["port"])):
        assert Path(pt).name == Path(jt).name and Path(pp).name == Path(jp).name
        np.testing.assert_allclose(read_traj(pt), read_traj(jt), atol=1e-4, rtol=0)


def test_align_trajectories_matches_jax(ca_system, tmp_path):
    jax_tools.align_trajectories(ca_system.dcd_path, ca_system.pdb_path,
                                 output_folder=str(tmp_path / "jax"))
    port_tools.align_trajectories(ca_system.dcd_path, ca_system.pdb_path,
                                  output_folder=str(tmp_path / "port"), device="cpu")
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    np.testing.assert_allclose(
        read_traj(str(tmp_path / "port" / "ca_example.dcd")),
        read_traj(str(tmp_path / "jax" / "ca_example.dcd")), atol=1e-3, rtol=0)
