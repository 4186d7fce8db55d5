"""The port's `deep_cartograph()` against the JAX package's, on the CPU: the
7-step pipeline on the CA system (`tests/test_pipeline.py::pipeline_config`,
clustering hierarchical), then every data role at once, a restart, and a
CV that fails to train. The output trees are equal (figures, logs and the
JAX package's Orbax checkpoint mirror aside), every CSV has the JAX
header and row count, and the values agree within one step of %.4f where
both packages compute the same thing."""

import os

import numpy as np
import pytest
import torch
import yaml

from deep_cartograph_torch.config.schemas import train_colvars_config
from deep_cartograph_torch.cv.base import CVCalculator
from deep_cartograph_torch.cv.deep import DeepTICACalculator
from deep_cartograph_torch.cv.linear import TICACalculator
from deep_cartograph_torch.io.colvars import read_colvars
from deep_cartograph_torch.pipeline import deep_cartograph as port_pipeline
from deep_cartograph_torch.tools import train_colvars as port_train_colvars
from deep_cartograph_tpu.pipeline import deep_cartograph as jax_pipeline
from tests.fixtures import make_ca_system, write_ca_pdb
from tests.test_pipeline import pipeline_config
from tests.test_pipeline_full import full_config
from tests.test_torch_tools import (
    ROUNDING,
    STEP,
    InitialParameters,
    assert_same_table,
    assert_same_tree,
    cv_values,
    file_tree,
    read_table,
)

torch.set_num_threads(2)


def _config():
    config = pipeline_config()
    config["traj_cluster"]["algorithm"] = "hierarchical"
    return config


def _stamps(root):
    return {rel: os.stat(os.path.join(root, rel)).st_mtime_ns for rel in file_tree(root)}


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """Both pipelines on the same inputs, then both again with restart:
    (system, jax output, port output, files each restart left alone).

    The packages' colvars files differ where float32 rounding puts a value
    on the other side of a %.4f step (2 of 3,540 values here), and such a
    step moves a CV by a few 1e-4. So the port's step 4 also runs on the
    JAX package's colvars and feature list (into "port_step4"), where the
    CVs are held to the JAX package's within one step."""
    root = tmp_path_factory.mktemp("pipeline")
    system = make_ca_system(str(root / "ca"), 12, 60, seed=7)
    runs = (("jax", jax_pipeline, {}), ("port", port_pipeline, {"device": "cpu"}))
    kept = {}
    with pytest.MonkeyPatch.context() as mp:
        InitialParameters(mp)
        for pkg, fn, extra in runs:
            fn(configuration=_config(), trajectory_data=[system.dcd_path],
               topology_data=[system.pdb_path], output_folder=str(root / pkg), **extra)
        jax_features = (root / "jax" / "filter_features" / "filtered_features.txt")\
            .read_text().split()
        port_train_colvars(
            _config()["train_colvars"],
            [str(root / "jax" / "compute_features" / "ca_example" / "colvars.dat")],
            [system.pdb_path], trajectory_names=["ca_example"],
            features_list=jax_features, output_folder=str(root / "port_step4"),
            device="cpu")
    for pkg, fn, extra in runs:
        before = _stamps(root / pkg)
        fn(configuration=_config(), trajectory_data=[system.dcd_path],
           topology_data=[system.pdb_path], output_folder=str(root / pkg),
           restart=True, **extra)
        after = _stamps(root / pkg)
        assert set(after) == set(before)
        kept[pkg] = sorted(rel for rel in before if after[rel] == before[rel])
    return system, root / "jax", root / "port", kept


def test_pipeline_writes_the_jax_tree(pipelines):
    _, jax_out, port_out, _ = pipelines
    assert_same_tree(jax_out, port_out)
    for rel in file_tree(jax_out):
        if rel.endswith("configuration.yml"):
            with open(jax_out / rel) as fh, open(port_out / rel) as gh:
                assert yaml.safe_load(gh) == yaml.safe_load(fh), rel


def test_pipeline_features_match_jax(pipelines):
    _, jax_out, port_out, _ = pipelines
    colvars = os.path.join("compute_features", "ca_example", "colvars.dat")
    jdata, jnames = read_colvars(str(jax_out / colvars))
    pdata, pnames = read_colvars(str(port_out / colvars))
    assert pnames == jnames
    np.testing.assert_allclose(pdata, jdata, atol=STEP + 1e-6, rtol=0)
    listing = os.path.join("filter_features", "filtered_features.txt")
    assert (port_out / listing).read_text() == (jax_out / listing).read_text()


def _float32_spread(colvars, features, folder):
    """The largest move of the port's TICA projection of the pipeline's
    training data under one ulp of input noise (three draws): at this
    feature count the TICA covariance is ill conditioned (~2e5), so
    float32 rounding alone moves the projection by more than 1e-4."""
    config = train_colvars_config(_config()["train_colvars"])["common"]
    base = TICACalculator(config, folder, device="cpu")
    base.load_training_data([colvars], features_list=features)
    x = base.training_data.numpy().copy()
    want = base.run(2)[0]
    spread = 0.0
    for seed in range(3):
        up = np.random.default_rng(seed).random(x.shape) < 0.5
        noisy = np.where(up, np.nextafter(x, np.inf), np.nextafter(x, -np.inf))
        calc = TICACalculator(config, folder, device="cpu")
        calc._set_training_data(noisy.astype(np.float32), np.zeros(len(x)), features)
        spread = max(spread, float(np.abs(calc.run(2)[0] - want).max()))
    return spread


@pytest.mark.parametrize("cv", ["pca", "tica", "ae"])
def test_pipeline_projections_match_jax(pipelines, cv):
    """Step 4 on the JAX package's colvars: PCA and the AE (from the JAX
    initial parameters) within one step of %.4f, TICA within three times
    its float32 spread; the pipeline's own projections are the model's."""
    system, jax_out, port_out, _ = pipelines
    rel = os.path.join(cv, "traj_data", "ca_example", "projected_trajectory.csv")
    step4 = port_out.parent / "port_step4"
    tol = STEP
    if cv == "tica":
        features = (jax_out / "filter_features" / "filtered_features.txt")\
            .read_text().split()
        colvars = str(jax_out / "compute_features" / "ca_example" / "colvars.dat")
        tol = max(STEP, 3 * _float32_spread(colvars, features, str(step4 / "spread")))
    assert_same_table(jax_out / "train_colvars" / rel, step4 / rel, tol)
    _, values = cv_values(port_out / "train_colvars" / rel)
    assert values.shape == (system.coords.shape[0], 2) and np.isfinite(values).all()
    served = CVCalculator.load(str(port_out / "train_colvars" / cv / "model.zip"),
                               str(port_out.parent / "served" / cv), device="cpu")
    want, _ = served.project_colvars(
        [str(port_out / "compute_features" / "ca_example" / "colvars.dat")],
        [system.pdb_path])
    np.testing.assert_allclose(values, want, atol=ROUNDING, rtol=0)


@pytest.mark.parametrize("cv", ["pca", "tica", "ae"])
def test_pipeline_clusters_match_jax(pipelines, cv):
    _, jax_out, port_out, _ = pipelines
    rel = os.path.join("traj_cluster", cv, "ca_example", "projected_trajectory.csv")
    jh, jrows = read_table(jax_out / rel)
    ph, prows = read_table(port_out / rel)
    assert ph == jh == [*jh[:2], "traj_label", "cluster", "centroid", "frame"]
    assert len(prows) == len(jrows) == 60
    assert [r[5] for r in prows] == [str(i) for i in range(60)]
    cluster = np.array([int(r[3]) for r in prows])
    k = len(np.unique(cluster))
    assert 2 <= k <= 4
    assert sum(r[4] == "True" for r in prows) == k
    assert len(os.listdir(port_out / "traj_cluster" / cv / "centroids")) == k
    if cv == "pca":
        jcluster = np.array([int(r[3]) for r in jrows])
        pairs = set(zip(jcluster.tolist(), cluster.tolist()))
        assert len(pairs) == len({a for a, _ in pairs}) == len({b for _, b in pairs})


def test_restart_skips_what_the_jax_package_skips(pipelines):
    _, _, _, kept = pipelines
    assert kept["port"] == kept["jax"]
    # the steps that skip on their outputs kept them; clustering re-ran
    assert os.path.join("compute_features", "ca_example", "colvars.dat") in kept["port"]
    assert os.path.join("filter_features", "filtered_features.txt") in kept["port"]
    assert os.path.join("train_colvars", "pca", "model.zip") in kept["port"]
    assert not any(rel.startswith("traj_cluster") and rel.endswith(".csv")
                   for rel in kept["port"])


def _all_roles(root):
    main = make_ca_system(str(root / "main"), 12, 60, seed=1)
    val = make_ca_system(str(root / "val"), 12, 30, seed=2)
    sup = make_ca_system(str(root / "sup"), 12, 20, seed=3)
    seed_sys = make_ca_system(str(root / "seed"), 12, 10, seed=4)
    waypoints = root / "waypoints"
    waypoints.mkdir()
    write_ca_pdb(str(waypoints / "wp1.pdb"), main.coords[0])
    write_ca_pdb(str(waypoints / "wp2.pdb"), main.coords[-1])
    return dict(
        trajectory_data=[main.dcd_path], topology_data=[main.pdb_path],
        validation_trajectory_data=[val.dcd_path],
        validation_topology_data=[val.pdb_path],
        seed_trajectory_data=[seed_sys.dcd_path], seed_topology_data=[seed_sys.pdb_path],
        supplementary_traj_data=[sup.dcd_path], supplementary_top_data=[sup.pdb_path],
        waypoints_data=str(waypoints),
    )


def test_pipeline_every_data_role_matches_jax(tmp_path):
    """Validation, supplementary, seed and waypoint data in one run (the
    roles of tests/test_pipeline_full.py), with the linear CVs."""
    inputs = _all_roles(tmp_path)
    config = full_config()
    config["train_colvars"]["cvs"] = ["pca", "tica"]
    config["train_colvars"]["common"]["bias"] = {"add_rmsd_restraint": True}
    jax_pipeline(configuration=config, output_folder=str(tmp_path / "jax"),
                 restart=True, **inputs)
    port_pipeline(configuration=config, output_folder=str(tmp_path / "port"),
                  restart=True, device="cpu", **inputs)
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    assert_same_tree(jax_out, port_out)
    for folder in ("compute_features", "compute_val_features", "compute_ref_features",
                   "compute_waypoint_features"):
        assert os.path.isdir(port_out / folder), folder
    summary = os.path.join("filter_features", "filter_summary.csv")
    assert read_table(port_out / summary)[0] == read_table(jax_out / summary)[0]
    assert "waypoint_difference" in read_table(port_out / summary)[0]
    listing = os.path.join("filter_features", "filtered_features.txt")
    assert (port_out / listing).read_text() == (jax_out / listing).read_text()
    for rel in file_tree(jax_out):
        if rel.endswith(".csv") and "traj_cluster" not in rel:
            jh, jrows = read_table(jax_out / rel)
            ph, prows = read_table(port_out / rel)
            assert ph == jh and len(prows) == len(jrows), rel
    for rel in ("ca_example", "sup_ca_example"):
        path = port_out / "traj_cluster" / "pca" / rel / "projected_trajectory.csv"
        assert "cluster" in read_table(path)[0]
    # the supplementary projection is the PCA model's, through the port's
    # translation of the supplementary topology
    served = CVCalculator.load(str(port_out / "train_colvars" / "pca" / "model.zip"),
                               str(tmp_path / "served"), device="cpu")
    want, _ = served.project_colvars(
        [str(port_out / "compute_ref_features" / "ca_example" / "colvars.dat")],
        inputs["supplementary_top_data"])
    _, got = cv_values(port_out / "traj_projection" / "pca" / "ca_example"
                       / "projected_trajectory.csv")
    np.testing.assert_allclose(got, want, atol=ROUNDING, rtol=0)


def test_pipeline_survives_failed_cv(ca_system, tmp_path, monkeypatch):
    """A CV whose training never validates is dropped with an error; the
    others are still projected and clustered."""
    monkeypatch.setattr(DeepTICACalculator, "_validate_result",
                        lambda self, result: False)
    config = _config()
    config["train_colvars"]["cvs"] = ["pca", "deep_tica"]
    config["train_colvars"]["common"]["training"]["general"]["max_epochs"] = 5
    config["train_colvars"]["figures"] = {"fes": {"compute": False},
                                          "traj_projection": {"plot": False}}
    out = tmp_path / "failed_cv"
    port_pipeline(configuration=config, trajectory_data=[ca_system.dcd_path],
                  topology_data=[ca_system.pdb_path], output_folder=str(out),
                  device="cpu")
    assert os.path.exists(out / "train_colvars" / "pca" / "traj_data" / "ca_example"
                          / "projected_trajectory.csv")
    assert os.path.isdir(out / "traj_cluster" / "pca")
    assert not os.path.isdir(out / "traj_cluster" / "deep_tica")
