"""The port's figures, on the CPU. With matplotlib, every figure the JAX
package draws for a configuration that asks for figures is drawn at the
same path (the training curves, the sensitivity bars, the FES and the
projection scatter, the cluster plots, the geometry plots, the H-bond
barcode). Without matplotlib (`sys.modules["matplotlib"] = None`), asking
for a figure raises an ImportError that names matplotlib, and the same
steps with the figures off run clean."""

import copy
import logging
import os
import sys

import numpy as np
import pytest
import torch

from deep_cartograph_torch import tools as port_tools
from deep_cartograph_torch.fes.kde import STREAMING_THRESHOLD, plot_fes
from deep_cartograph_torch.geom import hbonds
from deep_cartograph_torch.pipeline import deep_cartograph as port_pipeline
from deep_cartograph_tpu import tools as jax_tools
from deep_cartograph_tpu.geom import hbonds as jax_hbonds
from tests.test_pipeline import pipeline_config
from tests.test_torch_tools import FILTER_CONFIG, features_config

torch.set_num_threads(2)


def pngs(root):
    out = []
    for dirpath, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(dirpath, f), root)
                for f in files if f.endswith(".png")]
    return sorted(out)


def _train_config(figures_on=True):
    return {
        "cvs": ["pca", "deep_tica", "ae", "vae"],
        "common": {
            "dimension": 2,
            "features_normalization": "mean_std",
            "architecture": {"encoder": {"layers": [6], "activation": ["tanh"]}},
            "training": {
                "general": {"num_tries": 1, "batch_size": 16, "max_epochs": 3,
                            "check_val_every_n_epoch": 1},
                "kl_annealing": {"start_epoch": 1, "n_epochs_anneal": 2},
                "plot_loss": figures_on,
            },
        },
        "figures": {"fes": {"compute": figures_on, "num_bins": 20, "save": True},
                    "traj_projection": {"plot": figures_on}},
    }


def _geometry_config():
    return {"analysis": {
        "RMSD": {"r": {"title": "RMSD", "selection": "name CA", "fit_selection": "name CA"}},
        "RMSF": {"f": {"title": "RMSF", "selection": "name CA", "fit_selection": "name CA"}},
    }}


def _run_tools(tools, root, system, extra):
    """Every drawing tool with figures on: (trained CVs, colvars path)."""
    colvars = tools.compute_features(features_config(), system.dcd_path, system.pdb_path,
                                     output_folder=str(root / "cf"), **extra)
    features = tools.filter_features(FILTER_CONFIG, colvars,
                                     output_folder=str(root / "ff"), **extra)
    with open(features) as fh:
        kept = [line.strip() for line in fh if line.strip()]
    trained = tools.train_colvars(_train_config(), colvars, [system.pdb_path],
                                  trajectory_names=["ca_example"], features_list=kept,
                                  output_folder=str(root / "tc"), **extra)
    tools.traj_projection(
        {"figures": {"fes": {"num_bins": 20}}}, colvars, [system.pdb_path], ["again"],
        model_paths=[trained["pca"]["model_path"]],
        model_traj_paths=[trained["pca"]["traj_paths"]],
        output_folder=str(root / "tp"), **extra)
    tools.traj_cluster({"algorithm": "hierarchical", "search_interval": [2, 3]},
                       trained["pca"]["traj_paths"], [system.dcd_path], [system.pdb_path],
                       sup_cv_traj_paths=trained["pca"]["traj_paths"],
                       output_folder=str(root / "cl"), **extra)
    tools.analyze_geometry(_geometry_config(), [system.dcd_path], [system.pdb_path],
                           output_folder=str(root / "ag"), **extra)
    return trained, colvars


@pytest.fixture(scope="module")
def drawn(ca_system, tmp_path_factory):
    root = tmp_path_factory.mktemp("figures")
    _run_tools(jax_tools, root / "jax", ca_system, {})
    _run_tools(port_tools, root / "port", ca_system, {"device": "cpu"})
    return root / "jax", root / "port"


@pytest.mark.parametrize("step", ["tc", "tp", "cl", "ag"])
def test_every_figure_at_the_jax_path(drawn, step):
    jax_root, port_root = drawn
    want = pngs(jax_root / step)
    assert want and pngs(port_root / step) == want


def test_training_and_fes_figures(drawn):
    """The curves of each family and the FES files asked for with save."""
    _, port_root = drawn
    training = {cv: sorted(os.listdir(port_root / "tc" / cv / "training"))
                for cv in ("ae", "vae", "deep_tica")}
    assert "loss.png" in training["ae"] and "learning_rate.png" in training["ae"]
    assert {"vae_kl_loss.png", "vae_reconstruction_loss.png", "vae_beta.png"} <= \
        set(training["vae"])
    assert "eigenvalues.png" in training["deep_tica"]
    fes = port_root / "tc" / "pca" / "traj_data" / "ca_example" / "fes" / "fes_linear_1_2"
    assert sorted(os.listdir(fes)) == ["fes_PC_1_PC_2.npy", "fes_PC_1_PC_2.png",
                                       "grid_PC_1_PC_2_0.npy", "grid_PC_1_PC_2_1.npy"]
    assert np.load(fes / "fes_PC_1_PC_2.npy").shape == (20, 20)


def test_fes_through_the_streaming_branch(tmp_path):
    """A 2-D FES above 5e7 grid x samples (the branch of K2) is computed
    and drawn."""
    data = np.random.default_rng(0).normal(size=(2300, 2)).astype(np.float32)
    assert 150 * 150 * len(data) > STREAMING_THRESHOLD
    plot_fes(data, ["CV 1", "CV 2"], {"num_bins": 150, "save": True}, str(tmp_path),
             device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["fes_CV_1_CV_2.npy", "fes_CV_1_CV_2.png",
                                            "grid_CV_1_CV_2_0.npy", "grid_CV_1_CV_2_1.npy"]


def test_multibond_barcode(tmp_path):
    events = {"a-b": {"frame": np.array([0, 3, 3, 7])},
              "c-d": {"frame": np.array([], int)}}
    hbonds.plot_multibond_barcode(events, 10, dt=0.5, title="t",
                                  file_path=str(tmp_path / "port.png"))
    import pandas as pd

    jax_hbonds.plot_multibond_barcode({k: pd.DataFrame(v) for k, v in events.items()},
                                      10, dt=0.5, title="t",
                                      file_path=str(tmp_path / "jax.png"))
    assert (tmp_path / "port.png").stat().st_size > 0
    assert (tmp_path / "jax.png").stat().st_size > 0
    fig = hbonds.plot_multibond_barcode(events, 10)
    assert [t.get_text() for t in fig.axes[0].get_yticklabels()] == ["a-b", "c-d"]


@pytest.fixture
def no_matplotlib(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)


def test_asking_for_a_figure_without_matplotlib_raises(no_matplotlib, ca_system,
                                                       tmp_path, drawn):
    _, port_root = drawn
    trained_csv = str(port_root / "tc" / "pca" / "traj_data" / "ca_example"
                      / "projected_trajectory.csv")
    colvars = str(port_root / "cf" / "ca_example" / "colvars.dat")
    model = str(port_root / "tc" / "pca" / "model.zip")
    data = np.random.default_rng(0).normal(size=(50, 2))
    for call in (
        lambda: plot_fes(data, ["a", "b"], {"num_bins": 10}, str(tmp_path / "f"),
                         device="cpu"),
        lambda: hbonds.plot_multibond_barcode({"a": {"frame": np.arange(3)}}, 3),
        lambda: port_tools.train_colvars(
            {"cvs": ["pca"], "figures": {"traj_projection": {"plot": False}}},
            [colvars], output_folder=str(tmp_path / "fes"), device="cpu"),
        lambda: port_tools.train_colvars(
            {"cvs": ["pca"], "figures": {"fes": {"compute": False}}},
            [colvars], output_folder=str(tmp_path / "scatter"), device="cpu"),
        lambda: port_tools.train_colvars(
            {"cvs": ["pca"], "figures": {"fes": {"compute": False},
                                         "traj_projection": {"plot": False}}},
            [colvars], output_folder=str(tmp_path / "bars"), device="cpu"),
        lambda: port_tools.train_colvars(
            dict(_train_config(), cvs=["ae"],
                 figures={"fes": {"compute": False}, "traj_projection": {"plot": False}}),
            [colvars], output_folder=str(tmp_path / "loss"), device="cpu"),
        lambda: port_tools.traj_projection(
            {"figures": {"fes": {"compute": False}}}, [colvars], model_paths=[model],
            output_folder=str(tmp_path / "tp"), device="cpu"),
        lambda: port_tools.traj_cluster(
            {"algorithm": "hierarchical", "search_interval": [2, 3]}, [trained_csv],
            output_folder=str(tmp_path / "cl"), device="cpu"),
    ):
        with pytest.raises(ImportError, match="matplotlib"):
            call()


def test_figures_off_run_clean_without_matplotlib(no_matplotlib, ca_system, tmp_path,
                                                  caplog):
    """The pipeline with every flag off; the figures without a flag (the
    geometry plots) are reported as not drawn."""
    config = pipeline_config()
    config["train_colvars"]["cvs"] = ["pca", "ae"]
    config["train_colvars"]["common"]["training"]["general"]["max_epochs"] = 2
    config["train_colvars"]["common"]["training"]["plot_loss"] = False
    config["train_colvars"]["figures"] = {"fes": {"compute": False},
                                          "traj_projection": {"plot": False}}
    config["traj_projection"] = {"figures": {"fes": {"compute": False},
                                             "traj_projection": {"plot": False}}}
    config["traj_cluster"]["figures"] = {"plot": False}
    with caplog.at_level(logging.WARNING):
        port_pipeline(configuration=copy.deepcopy(config),
                      trajectory_data=[ca_system.dcd_path],
                      topology_data=[ca_system.pdb_path],
                      supplementary_traj_data=[ca_system.dcd_path],
                      supplementary_top_data=[ca_system.pdb_path],
                      output_folder=str(tmp_path / "out"), device="cpu")
    out = tmp_path / "out"
    assert pngs(out) == []
    assert os.path.exists(out / "traj_cluster" / "ae" / "sup_ca_example"
                          / "projected_trajectory.csv")
    assert sys.modules["matplotlib"] is None
    not_drawn = [r.getMessage() for r in caplog.records
                 if "matplotlib is not installed" in r.getMessage()]
    assert any("ca_rmsd_RMSD.png" in m for m in not_drawn)
    assert any("ca_rmsf_RMSF.png" in m for m in not_drawn)
