"""model.zip between the port and the JAX package, on the CPU: a zip that
either package writes loads in the other and projects the same (1e-5),
for every ported family (PCA, TICA, HTICA, deep-TICA, AE, VAE),
with the same file list; the msgpack parameters against Flax's bytes; the
TorchScript weights against the JAX package's export; serving a zip with
FramesToCV.from_model_zip against the JAX package's (1e-5 on the same
features); the sensitivity outputs (1e-5 on one net; 1e-4 of the largest
weight between two linear runs)."""

import copy
import os
import tempfile
import zipfile

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from deep_cartograph_tpu.cv import cv_calculators_map as jax_calculators
from deep_cartograph_tpu.cv.base import CVCalculator as JaxCVCalculator
from deep_cartograph_tpu.deploy import FramesToCV as JaxFramesToCV
from deep_cartograph_tpu.io.colvars import write_colvars
from deep_cartograph_tpu.models.torch_export import save_torchscript as jax_save_torchscript
from deep_cartograph_torch.cv import CVCalculator, cv_calculators_map
from deep_cartograph_torch.deploy import FramesToCV
from deep_cartograph_torch.io.dcd import read_dcd
from deep_cartograph_torch.models import msgpack
from deep_cartograph_torch.models.weights import params_from_flax, params_to_flax
from tests.fixtures import make_shifted_ca_pdb
from tests.test_cv import base_config
from tests.test_golden import GOLDEN_DIR, _feature_labels, _fixture_system

torch.set_num_threads(2)

ZIP_TOL = 1e-5
CVS = ("pca", "tica", "htica", "deep_tica", "ae", "vae")


def _config():
    cfg = base_config()
    cfg["training"]["general"].update({"num_tries": 2, "max_epochs": 6,
                                       "batch_size": 16})
    return cfg


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Every CV trained by both packages on the golden fixture; returns the
    system, the colvars path, and per CV the two calculators and zips."""
    tmp = str(tmp_path_factory.mktemp("zips"))
    system = _fixture_system(tmp)
    features = np.load(os.path.join(GOLDEN_DIR, "features.npy"))
    path = os.path.join(tmp, "colvars.dat")
    write_colvars(path, np.column_stack([np.arange(60, dtype=np.float32), features]),
                  ["time"] + _feature_labels(), fmt="%.9g")
    runs = {}
    for cv in CVS:
        out = {}
        for pkg, calcs, kwargs in (("port", cv_calculators_map, {"device": "cpu"}),
                                   ("jax", jax_calculators, {})):
            folder = os.path.join(tmp, pkg)
            calc = calcs[cv](configuration=_config(), output_path=folder, **kwargs)
            calc.load_training_data([path], [system.pdb_path],
                                    features_list=_feature_labels())
            result = calc.run()
            proj = result[0] if pkg == "port" else result.to_numpy()
            out[pkg] = (calc, os.path.join(folder, cv, "model.zip"), proj)
        runs[cv] = out
    return system, path, runs, tmp


def _load(pkg, zip_path, folder):
    if pkg == "port":
        return CVCalculator.load(zip_path, folder, device="cpu")
    return JaxCVCalculator.load(zip_path, folder)


def _project(pkg, calc, path, top):
    out = calc.project_colvars([path], [top])
    return out[0] if pkg == "port" else out.to_numpy()


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("cv", CVS)
def test_zip_loads_in_both_packages(trained, tmp_path, cv, writer):
    system, path, runs, _ = trained
    _, zip_path, run_projection = runs[cv][writer]
    projections = {}
    for reader in ("port", "jax"):
        calc = _load(reader, zip_path, str(tmp_path / reader))
        assert calc.cv_name == cv and calc.features_ref_labels == _feature_labels()
        projections[reader] = _project(reader, calc, path, system.pdb_path)
        np.testing.assert_allclose(projections[reader], run_projection, atol=ZIP_TOL)
    np.testing.assert_allclose(projections["port"], projections["jax"], atol=ZIP_TOL)
    assert calc.cv_labels == [f"{calc.cv_labels[0][:-2]} {i + 1}" for i in range(2)]


@pytest.mark.parametrize("cv", CVS)
def test_zip_file_lists_match(trained, cv):
    _, _, runs, _ = trained
    names = {pkg: sorted(zipfile.ZipFile(runs[cv][pkg][1]).namelist())
             for pkg in ("port", "jax")}
    assert names["port"] == names["jax"]
    assert "model/ref_topology.pdb" in names["port"]


def test_msgpack_bytes_match_flax(trained):
    _, _, runs, tmp = trained
    calc = runs["deep_tica"]["port"][0]
    tree = params_to_flax(calc.params)
    ours = msgpack.packb(tree)
    assert ours == flax.serialization.to_bytes(tree)
    restored = flax.serialization.msgpack_restore(ours)
    for key, value in params_from_flax(restored).items():
        np.testing.assert_array_equal(value.numpy(), calc.params[key].numpy())
    jcalc = runs["deep_tica"]["jax"][0]
    jparams = jax.tree.map(np.asarray, jcalc.params)
    back = params_from_flax(msgpack.unpackb(flax.serialization.to_bytes(jparams)))
    for key, value in params_from_flax(jparams).items():
        np.testing.assert_array_equal(back[key].numpy(), value.numpy())
    # the try checkpoints are Flax files too
    ckpt = os.path.join(tmp, "port", "deep_tica", "training", "checkpoints", "try_1")
    with open(os.path.join(ckpt, "model.msgpack"), "rb") as fh:
        tries = flax.serialization.msgpack_restore(fh.read())
    assert set(params_from_flax(tries)) == set(calc.params)
    with open(os.path.join(ckpt, "score.txt")) as fh:
        assert "epoch" in fh.read()
    for name in ("training_metrics.zip", "model_score.txt", "eigenvalues.txt"):
        assert os.path.exists(os.path.join(tmp, "port", "deep_tica", "training", name))


def test_torchscript_weights_match_jax_export(trained, tmp_path):
    _, _, runs, _ = trained
    calc = runs["deep_tica"]["port"][0]
    ours = str(tmp_path / "port.pt")
    theirs = str(tmp_path / "jax.pt")
    calc.save_weights(ours)
    jax_save_torchscript(copy.deepcopy(calc.architecture), params_to_flax(calc.params),
                         theirs)
    x = torch.as_tensor(np.random.default_rng(0).normal(1.0, 0.3, (50, 8)),
                        dtype=torch.float32)
    with torch.no_grad():
        a = torch.jit.load(ours)(x).numpy()
        b = torch.jit.load(theirs)(x).numpy()
    np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(a, calc.project_data(x), atol=1e-6)


@pytest.mark.parametrize("cv", ["ae", "vae"])
def test_autoencoder_torchscript_weights_match_jax_export(trained, tmp_path, cv):
    """The port's AE encoder and VAE mean, traced, against the JAX package's
    export of the same weights (1e-6) and the calculator (1e-5)."""
    _, _, runs, _ = trained
    calc = runs[cv]["port"][0]
    ours = str(tmp_path / "port.pt")
    theirs = str(tmp_path / "jax.pt")
    calc.save_weights(ours)
    jax_save_torchscript(copy.deepcopy(calc.architecture), params_to_flax(calc.params),
                         theirs)
    x = torch.as_tensor(np.random.default_rng(0).normal(1.0, 0.3, (50, 8)),
                        dtype=torch.float32)
    with torch.no_grad():
        a = torch.jit.load(ours)(x).numpy()
        b = torch.jit.load(theirs)(x).numpy()
    assert a.shape == (50, 2)
    np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(a, calc.project_data(x), atol=ZIP_TOL)


def test_torchscript_only_zip_projects(trained, tmp_path):
    """A zip with no msgpack parameters (the reference toolkit's) serves
    through its TorchScript weights."""
    system, path, runs, _ = trained
    _, zip_path, want = runs["deep_tica"]["port"]
    stripped = str(tmp_path / "ts_only.zip")
    with zipfile.ZipFile(zip_path) as src, zipfile.ZipFile(stripped, "w") as dst:
        for item in src.namelist():
            if not item.endswith(("flax_params.msgpack", "architecture.json")):
                dst.writestr(item, src.read(item))
    calc = CVCalculator.load(stripped, str(tmp_path / "load"), device="cpu")
    np.testing.assert_allclose(calc.project_colvars([path], [system.pdb_path])[0], want,
                               atol=ZIP_TOL)


@pytest.mark.parametrize("cv", ["tica", "deep_tica", "ae", "vae"])
@pytest.mark.parametrize("shifted", [False, True])
def test_from_model_zip_matches_jax(trained, tmp_path, cv, shifted):
    """Serving a zip from the DCD, on the training topology and on one
    numbered from 101 (features translated), against the JAX package's
    from_model_zip, for zips written by both packages."""
    system, _, runs, _ = trained
    top = make_shifted_ca_pdb(str(tmp_path), system) if shifted else system.pdb_path
    coords = read_dcd(system.dcd_path)
    for writer in ("port", "jax"):
        zip_path = runs[cv][writer][1]
        got = FramesToCV.from_model_zip(zip_path, top, str(tmp_path / f"p{writer}"),
                                        device="cpu")(coords)
        want = JaxFramesToCV.from_model_zip(zip_path, top, str(tmp_path / f"j{writer}"))(
            coords)
        np.testing.assert_allclose(got, want, atol=ZIP_TOL)
        assert got.shape == (coords.shape[0], 2)


@pytest.mark.parametrize("cv", ["tica", "deep_tica"])
def test_from_model_zip_without_output_path_leaves_no_files(trained, tmp_path,
                                                            monkeypatch, cv):
    """Without output_path the zip is unpacked into a temporary directory
    that is gone once the pipeline is built; the pipeline serves as one
    built from a kept folder."""
    system, _, runs, _ = trained
    zip_path = runs[cv]["port"][1]
    temp_root = tmp_path / "tmp"
    temp_root.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(temp_root))
    coords = read_dcd(system.dcd_path)
    got = FramesToCV.from_model_zip(zip_path, system.pdb_path, device="cpu")(coords)
    assert list(temp_root.iterdir()) == []
    want = FramesToCV.from_model_zip(zip_path, system.pdb_path, str(tmp_path / "kept"),
                                     device="cpu")(coords)
    np.testing.assert_array_equal(got, want)


def _read_sensitivity(folder):
    with open(os.path.join(folder, "sensitivity_analysis.csv")) as fh:
        assert fh.readline() == ",sensitivity\n"
        rows = [line.rstrip("\n").split(",") for line in fh]
    return {name: float(value) for name, value in rows}


@pytest.mark.parametrize("cv", ["pca", "tica", "htica"])
def test_linear_sensitivity_matches_jax(trained, cv):
    """|weights| of the two packages' own runs: float32 eigenvectors from
    two eigensolvers, equal within 1e-4 of the largest weight (the
    projections they give agree within 1e-5, test above)."""
    _, _, runs, tmp = trained
    for k in (1, 2):
        folders = [os.path.join(tmp, pkg, cv, "sensitivity_analysis",
                                f"sensitivity_analysis_{k}") for pkg in ("port", "jax")]
        ours, theirs = (_read_sensitivity(f) for f in folders)
        assert set(ours) == set(theirs) == set(_feature_labels())
        scale = max(theirs.values())
        for name in ours:
            assert abs(ours[name] - theirs[name]) <= 1e-4 * scale, name
        assert os.path.exists(os.path.join(folders[0], "sensitivity_structure.pdb"))


def test_deep_tica_sensitivity_matches_jax(trained, tmp_path):
    """The port's vmap(jacrev) sensitivity against the JAX package's on the
    same trained net (the port's zip loaded in the JAX package)."""
    _, _, runs, tmp = trained
    calc, zip_path, _ = runs["deep_tica"]["port"]
    jcalc = JaxCVCalculator.load(zip_path, str(tmp_path / "jax"))
    jcalc.training_data = calc.training_data.numpy()
    jcalc.sensitivity_output_folder = str(tmp_path / "jax_sens")
    jcalc.ref_topology_path = None
    jcalc.sensitivity_analysis()
    ours = _read_sensitivity(os.path.join(tmp, "port", "deep_tica", "sensitivity_analysis"))
    theirs = _read_sensitivity(str(tmp_path / "jax_sens"))
    assert list(ours) == list(theirs) == _feature_labels()
    for name in ours:
        assert abs(ours[name] - theirs[name]) <= ZIP_TOL * max(1.0, abs(theirs[name]))


@pytest.mark.parametrize("cv", ["ae", "vae"])
def test_autoencoder_sensitivity_matches_jax(trained, tmp_path, cv):
    """As for deep-TICA: the port's sensitivity of the AE encoder and the
    VAE mean against the JAX package's on the same trained net."""
    _, _, runs, tmp = trained
    calc, zip_path, _ = runs[cv]["port"]
    jcalc = JaxCVCalculator.load(zip_path, str(tmp_path / "jax"))
    jcalc.training_data = calc.training_data.numpy()
    jcalc.sensitivity_output_folder = str(tmp_path / "jax_sens")
    jcalc.ref_topology_path = None
    jcalc.sensitivity_analysis()
    ours = _read_sensitivity(os.path.join(tmp, "port", cv, "sensitivity_analysis"))
    theirs = _read_sensitivity(str(tmp_path / "jax_sens"))
    assert list(ours) == list(theirs) == _feature_labels()
    for name in ours:
        assert abs(ours[name] - theirs[name]) <= ZIP_TOL * max(1.0, abs(theirs[name]))


@pytest.mark.parametrize("cv", ["pca", "deep_tica"])
def test_project_colvars_streams_past_the_threshold(trained, tmp_path, monkeypatch, cv):
    """Past DEEP_CARTO_STREAM_BYTES a loaded model projects the file block
    by block, with the same values and per-file labels as in memory."""
    _, path, runs, _ = trained
    calc = CVCalculator.load(runs[cv]["port"][1], str(tmp_path / "load"), device="cpu")
    want, labels = calc.project_colvars([path, path])
    want_rows = calc.projection_data_labels
    monkeypatch.setenv("DEEP_CARTO_STREAM_BYTES", "1")
    monkeypatch.setenv("DEEP_CARTO_STREAM_CHUNK_ROWS", "7")
    streamed = []
    stream = calc._project_colvars_streaming
    monkeypatch.setattr(calc, "_project_colvars_streaming",
                        lambda paths: streamed.append(paths) or stream(paths))
    got, got_labels = calc.project_colvars([path, path])
    assert streamed and got_labels == labels
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(calc.projection_data_labels, want_rows)


def test_validation_data_from_colvars_matches_jax(trained):
    """load_validation_data reads the files, keeps per-file labels and pairs
    frames per file, as the JAX calculator does."""
    _, path, runs, _ = trained
    calc, jcalc = runs["deep_tica"]["port"][0], runs["deep_tica"]["jax"][0]
    calc.load_validation_data([path, path], features_list=_feature_labels())
    jcalc.load_validation_data([path, path], features_list=_feature_labels())
    np.testing.assert_array_equal(calc.validation_data_labels, jcalc.validation_data_labels)
    np.testing.assert_array_equal(calc.validation_data.numpy(), jcalc.validation_data)
    np.testing.assert_array_equal(calc.val_x_t.numpy(), jcalc.val_x_t)
    np.testing.assert_array_equal(calc.val_x_lag.numpy(), jcalc.val_x_lag)


def _bfactors(pdb):
    with open(pdb) as fh:
        return np.asarray([float(line[60:66]) for line in fh if line.startswith("ATOM")])


@pytest.mark.parametrize("cv", ["pca", "tica", "deep_tica"])
def test_sensitivity_structure_matches_jax(trained, cv):
    """The per-atom map (B-factors 0-100 of sensitivity_structure.pdb)."""
    _, _, runs, tmp = trained
    sub = "sensitivity_analysis_1" if cv != "deep_tica" else ""
    pdbs = [os.path.join(tmp, pkg, cv, "sensitivity_analysis", sub,
                         "sensitivity_structure.pdb") for pkg in ("port", "jax")]
    ours, theirs = (_bfactors(p) for p in pdbs)
    assert ours.shape == theirs.shape and ours.max() == 100.0
    if cv == "deep_tica":  # two nets trained apart: the same atoms mapped
        np.testing.assert_array_equal(ours > 0, theirs > 0)
    else:
        np.testing.assert_allclose(ours, theirs, atol=0.011)  # written with 2 decimals


def test_a_collected_calculator_leaves_the_next_load_alone(trained, tmp_path,
                                                           monkeypatch):
    """A calculator loaded into a folder and then dropped inside a reference
    cycle is removed by the garbage collector, whose finalizer deletes its
    unzip folder. The collector may run at any allocation, here while the
    next load into the same folder copies its own unzipped files; the next
    load must still get all of its model's files."""
    import gc
    import shutil

    _, _, runs, _ = trained
    folder = str(tmp_path / "shared")
    stale = CVCalculator.load(runs["pca"]["port"][1], folder, device="cpu")
    stale.cycle = stale
    del stale
    copytree = shutil.copytree

    def collect_then_copy(*args, **kwargs):
        gc.collect()
        return copytree(*args, **kwargs)

    monkeypatch.setattr(shutil, "copytree", collect_then_copy)
    gc.disable()
    try:
        calc = CVCalculator.load(runs["tica"]["port"][1], folder, device="cpu")
    finally:
        gc.enable()
    with zipfile.ZipFile(runs["tica"]["port"][1]) as zf:
        want = sorted(os.path.relpath(m, "model") for m in zf.namelist())
    assert calc.cv_name == "tica"
    assert sorted(os.listdir(os.path.join(folder, "tica", "model"))) == want
