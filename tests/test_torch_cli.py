"""The port's command lines and configuration files, on the CPU: `cli.main`
and every `tool_cli.*_main` run through a patched `sys.argv` with a YAML and
with a JSON configuration (the tool or pipeline function the command line
calls is bound to `device="cpu"`, since the command lines take no device
flag), and each `configuration.yml` reads back equal to the JAX package's.
Also the helpers of `utils/common.py` that carry the files: the YAML
emitter, JSON and YAML reading, output paths, and the CSV writers."""

import copy
import functools
import importlib
import io
import json
import logging
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from deep_cartograph_torch import cli, tool_cli
from deep_cartograph_torch.config import schemas
from deep_cartograph_torch.utils import common
from deep_cartograph_tpu.config import schemas as jax_schemas
from deep_cartograph_tpu.utils import common as jax_common
from tests.test_pipeline import pipeline_config
from tests.test_pipeline_full import full_config
from tests.test_torch_tools import FILTER_CONFIG, features_config, file_tree

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def restore_loggers():
    """The command lines configure the package loggers from their INI
    files (own handlers, no propagation); put them back afterwards."""
    loggers = [logging.getLogger(n) for n in ("deep_cartograph_torch", "")]
    saved = [(list(lg.handlers), lg.propagate, lg.level) for lg in loggers]
    yield
    for lg, (handlers, propagate, level) in zip(loggers, saved):
        for handler in lg.handlers:
            if handler not in handlers:
                handler.close()
        lg.handlers[:] = handlers
        lg.propagate, lg.level = propagate, level


def _write_config(path_stem, config, fmt):
    path = f"{path_stem}.{'yml' if fmt == 'yaml' else 'json'}"
    with open(path, "w") as fh:
        if fmt == "yaml":
            yaml.safe_dump(config, fh)
        else:
            json.dump(config, fh)
    return path


def _on_cpu(monkeypatch, module_name, function_name):
    """Bind device="cpu" into the function a command line imports."""
    module = importlib.import_module(module_name)
    monkeypatch.setattr(module, function_name, functools.partial(
        getattr(module, function_name), device="cpu"))


def _read_yaml(path):
    with open(path) as fh:
        return yaml.safe_load(fh)


def _jax_validated(config, schema, tmp_path):
    folder = tmp_path / "jax_validated"
    jax_common.validate_configuration(copy.deepcopy(config), schema, str(folder))
    return _read_yaml(folder / "configuration.yml")


def _small_pipeline_config():
    config = pipeline_config()
    config["train_colvars"]["cvs"] = ["pca"]
    config["train_colvars"]["figures"] = {"fes": {"compute": False},
                                          "traj_projection": {"plot": False}}
    config["traj_cluster"]["figures"] = {"plot": False}
    config["analyze_geometry"]["analysis"].pop("RMSF")
    return config


@pytest.mark.parametrize("fmt", ["yaml", "json"])
def test_main_runs_the_pipeline(ca_system, tmp_path, monkeypatch, fmt):
    config = _small_pipeline_config()
    conf = _write_config(str(tmp_path / "conf"), config, fmt)
    _on_cpu(monkeypatch, "deep_cartograph_torch.pipeline", "deep_cartograph")
    out = tmp_path / "out"
    monkeypatch.setattr(sys, "argv", [
        "deep_carto_torch", "-conf", conf, "-traj_data", ca_system.dcd_path,
        "-top_data", ca_system.pdb_path, "-out", str(out), "-cvs", "pca", "-dim", "2",
    ])
    cli.main()
    assert (out / "deep_cartograph.log").read_text().count("Elapsed time") >= 6
    assert os.path.exists(out / "traj_cluster" / "pca" / "ca_example"
                          / "projected_trajectory.csv")
    assert _read_yaml(out / "configuration.yml") == \
        _jax_validated(config, jax_schemas.DeepCartograph, tmp_path)
    assert logging.getLogger("deep_cartograph_torch").handlers


def test_main_without_a_card_raises(ca_system, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = _write_config(str(tmp_path / "conf"), {}, "json")
    monkeypatch.setattr(sys, "argv", ["deep_carto_torch", "-conf", conf, "-traj_data",
                                      ca_system.dcd_path, "-top_data", ca_system.pdb_path,
                                      "-out", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main()


def test_main_flags_equal_the_jax_ones():
    from deep_cartograph_tpu import cli as jax_cli

    def flags(module):
        argv = sys.argv
        try:
            sys.argv = ["prog", "-h"]
            buffer = io.StringIO()
            stdout, sys.stdout = sys.stdout, buffer
            with pytest.raises(SystemExit):
                module.parse_arguments()
        finally:
            sys.stdout, sys.argv = stdout, argv
        text = buffer.getvalue()
        return sorted({w.strip("[],") for w in text.split() if w.startswith(("-", "[-"))})

    assert flags(cli) == flags(jax_cli)


@pytest.fixture(scope="module")
def cv_inputs(ca_system, tmp_path_factory):
    """Colvars, the kept features and a PCA model of the CA system, made by
    the port's tools, for the tool command lines to read."""
    from deep_cartograph_torch.tools import compute_features, filter_features, train_colvars

    root = tmp_path_factory.mktemp("cli_inputs")
    colvars = compute_features(features_config(), ca_system.dcd_path, ca_system.pdb_path,
                               output_folder=str(root / "cf"), device="cpu")[0]
    features = filter_features(FILTER_CONFIG, [colvars], output_folder=str(root / "ff"),
                               device="cpu")
    trained = train_colvars({"cvs": ["pca"], "figures": {"fes": {"compute": False},
                                                         "traj_projection": {"plot": False}}},
                            [colvars], [ca_system.pdb_path], trajectory_names=["ca_example"],
                            features_list=common.read_features_list(features),
                            output_folder=str(root / "tc"), device="cpu")
    return colvars, features, trained["pca"]


def _tool_cases(ca_system, cv_inputs):
    """(tool, configuration, JAX schema, flags, a file it writes)."""
    colvars, features, pca = cv_inputs
    traj, top = ca_system.dcd_path, ca_system.pdb_path
    figures_off = {"figures": {"fes": {"compute": False},
                               "traj_projection": {"plot": False}}}
    return {
        "compute_features": (features_config(), jax_schemas.ComputeFeaturesSchema,
                             ["-traj_data", traj, "-top_data", top, "-output"],
                             "ca_example/colvars.dat"),
        "filter_features": (FILTER_CONFIG, jax_schemas.FilterFeaturesSchema,
                            ["-colvars", colvars, "-output"], "filtered_features.txt"),
        "train_colvars": (dict(figures_off, cvs=["pca", "tica"]),
                          jax_schemas.TrainColvarsSchema,
                          ["-colvars", colvars, "-topology", top, "-trajectory",
                           "ca_example", "-features", features, "-cvs", "tica", "-out"],
                          "tica/traj_data/ca_example/projected_trajectory.csv"),
        "traj_projection": (figures_off, jax_schemas.TrajProjectionSchema,
                            ["-colvars", colvars, "-top", top, "-names", "again",
                             "-models", pca["model_path"], "-models_traj",
                             pca["traj_paths"][0], "-out"],
                            "pca/again/projected_trajectory.csv"),
        "traj_cluster": ({"algorithm": "hierarchical", "search_interval": [2, 3],
                          "figures": {"plot": False}},
                         jax_schemas.TrajClusterSchema,
                         ["-cv_traj", pca["traj_paths"][0], "-trajectory", traj,
                          "-topology", top, "-out"],
                         "ca_example/projected_trajectory.csv"),
        "traj_augmentation": ({"num_frames": 30, "traj_format": "dcd"},
                              jax_schemas.TrajAugmentationSchema,
                              ["-traj_data", traj, "-top_data", top, "-n", "2", "-output"],
                              "ca_example_augmented_pchip_rep1.dcd"),
        "analyze_geometry": ({"analysis": {"RMSD": {"r": {"selection": "name CA",
                                                          "fit_selection": "name CA"}}}},
                             jax_schemas.AnalyzeGeometrySchema,
                             ["-traj_data", traj, "-top_data", top, "-output"],
                             "r/ca_example_first_frame.csv"),
    }


TOOLS_WITH_CONFIG = ["compute_features", "filter_features", "train_colvars",
                     "traj_projection", "traj_cluster", "traj_augmentation",
                     "analyze_geometry"]


@pytest.mark.parametrize("fmt", ["yaml", "json"])
@pytest.mark.parametrize("tool", TOOLS_WITH_CONFIG)
def test_tool_command_line(ca_system, cv_inputs, tmp_path, monkeypatch, tool, fmt):
    config, schema, flags, written = _tool_cases(ca_system, cv_inputs)[tool]
    if tool != "traj_augmentation":  # the one tool that runs on the host only
        _on_cpu(monkeypatch, f"deep_cartograph_torch.tools.{tool}", tool)
    conf = _write_config(str(tmp_path / "conf"), config, fmt)
    out = tmp_path / "out"
    monkeypatch.setattr(sys, "argv", [tool, "-conf", conf, *flags, str(out)])
    getattr(tool_cli, f"{tool}_main")()
    assert (out / written).is_file(), sorted(file_tree(out))
    assert (out / "deep_cartograph.log").is_file()
    assert _read_yaml(out / "configuration.yml") == \
        _jax_validated(config, schema, tmp_path)


def test_align_trajectories_command_line(ca_system, tmp_path, monkeypatch):
    _on_cpu(monkeypatch, "deep_cartograph_torch.tools.align_trajectories",
            "align_trajectories")
    out = tmp_path / "out"
    monkeypatch.setattr(sys, "argv", ["python", "align_trajectories", "-traj_data",
                                      ca_system.dcd_path, "-top_data", ca_system.pdb_path,
                                      "-output", str(out)])
    tool_cli.main()  # the dispatcher of `python -m deep_cartograph_torch.tool_cli`
    assert (out / "ca_example.dcd").is_file() and (out / "ca_example.pdb").is_file()


def test_tool_flags_equal_the_jax_ones():
    """Every JAX command line has its port, with the same flags."""
    from deep_cartograph_tpu import tool_cli as jax_tool_cli

    names = sorted(n for n in dir(jax_tool_cli) if n.endswith("_main"))
    assert sorted(f"{t}_main" for t in tool_cli.TOOLS) == names
    import inspect

    for name in names:
        jax_src = inspect.getsource(getattr(jax_tool_cli, name))
        port_src = inspect.getsource(getattr(tool_cli, name))
        jax_flags = [l.strip() for l in jax_src.splitlines() if "add_argument" in l]
        port_flags = [l.strip() for l in port_src.splitlines() if "add_argument" in l]
        assert port_flags == jax_flags, name


# ---------------------------------------------------------------------------
# configuration files
# ---------------------------------------------------------------------------

def _validated_configs():
    return {
        "defaults": schemas.deep_cartograph_config({}),
        "pipeline": schemas.deep_cartograph_config(pipeline_config()),
        "all_roles": schemas.deep_cartograph_config(full_config()),
        "awkward": {"yes": "no", "quote": "it's", "colon": "a: b", "hash": "x #y",
                    "lead": " x", "num": "1.5", "null": None, "empty": "",
                    "line": "a\nb", "floats": [1e-06, 1e16, 0.1, -2.5e-12, 300.0],
                    "nested": [{"a": [1, 2], "b": {}}, []], "unicode": "Å",
                    "star": "*all", "bools": [True, False], "ints": [0, -3]},
    }


@pytest.mark.parametrize("name", list(_validated_configs()))
def test_dump_yaml_reads_back(name):
    config = _validated_configs()[name]
    assert yaml.safe_load(common.dump_yaml(config)) == config


@pytest.mark.parametrize("name", ["defaults", "pipeline", "all_roles"])
def test_configuration_yml_equals_the_jax_one(name, tmp_path):
    raw = {"defaults": {}, "pipeline": pipeline_config(), "all_roles": full_config()}[name]
    common.validate_configuration(copy.deepcopy(raw), schemas.deep_cartograph_config,
                                  str(tmp_path / "port"))
    assert _read_yaml(tmp_path / "port" / "configuration.yml") == \
        _jax_validated(raw, jax_schemas.DeepCartograph, tmp_path)


def test_invalid_configuration_exits(tmp_path):
    with pytest.raises(SystemExit):
        common.validate_configuration({"traj_cluster": {"algorithm": "dbscan"}},
                                      schemas.deep_cartograph_config, str(tmp_path))


def test_read_configuration_json_needs_no_yaml(tmp_path, monkeypatch):
    config = pipeline_config()
    path = _write_config(str(tmp_path / "conf"), config, "json")
    yml = _write_config(str(tmp_path / "conf"), config, "yaml")
    assert common.read_configuration(yml) == config
    # JSON is YAML, so the JAX package reads the file too; PyYAML (YAML 1.1)
    # reads a number only with a dot, so JSON's 1e-06 is a string to it
    plain = {"traj_cluster": {"n_init": 3, "cluster_selection_epsilon": 0.5,
                              "max_cluster_size": None, "search_interval": [2, 4]}}
    plain_path = _write_config(str(tmp_path / "plain"), plain, "json")
    assert jax_common.read_configuration(plain_path) == plain
    assert common.read_configuration(plain_path) == plain
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert common.read_configuration(path) == config
    with pytest.raises(ImportError, match="PyYAML"):
        common.read_configuration(yml)


def test_read_configuration_missing_file_exits(tmp_path):
    with pytest.raises(SystemExit):
        common.read_configuration(str(tmp_path / "missing.yml"))


# ---------------------------------------------------------------------------
# paths and data files
# ---------------------------------------------------------------------------

def test_paths_and_pairing_match_jax(ca_system, tmp_path):
    (tmp_path / "empty").mkdir()
    (tmp_path / "only_log").mkdir()
    (tmp_path / "only_log" / "deep_cartograph.log").write_text("")
    (tmp_path / "full").mkdir()
    (tmp_path / "full" / "x").write_text("")
    (tmp_path / "file.txt").write_text("")
    for name in ("empty", "only_log", "full", "file.txt", "new"):
        path = str(tmp_path / name)
        assert common.get_unique_path(path) == jax_common.get_unique_path(path)
    for n in (3, 4, 5, 64, 100):
        assert common.closest_power_of_two(n) == jax_common.closest_power_of_two(n)
    pairs = (ca_system.dcd_path, ca_system.pdb_path)
    assert common.check_data(*pairs) == jax_common.check_data(*pairs)
    assert common.check_data([pairs[0]] * 3, pairs[1]) == \
        jax_common.check_data([pairs[0]] * 3, pairs[1])
    assert common.files_exist(pairs[0]) and not common.files_exist(str(tmp_path / "no"))
    assert common.package_is_installed("numpy") and \
        not common.package_is_installed("no_such_package_here")
    common.remove_dirs(str(tmp_path / "full"))
    assert not os.path.exists(tmp_path / "full")


def test_save_data_and_write_as_csv_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    y = {"a": rng.normal(size=7), "b": rng.normal(size=7).astype(np.float32)}
    x = {"a": np.arange(7) * 0.5, "b": np.arange(7)}
    common.save_data(y, x, "RMSD (A)", "Time (ns)", str(tmp_path / "port"))
    jax_common.save_data(y, x, "RMSD (A)", "Time (ns)", str(tmp_path / "jax"))
    for key in y:
        assert (tmp_path / "port" / f"{key}.csv").read_bytes() == \
            (tmp_path / "jax" / f"{key}.csv").read_bytes()
    columns = {"time": np.arange(5) * 0.002, "d1": rng.normal(size=5),
               "d2": rng.normal(size=5).astype(np.float32)}
    for _ in range(2):  # the second call appends and continues the time axis
        common.write_as_csv(columns, str(tmp_path / "port.dat"))
        jax_common.write_as_csv(pd.DataFrame(columns), str(tmp_path / "jax.dat"))
    assert (tmp_path / "port.dat").read_bytes() == (tmp_path / "jax.dat").read_bytes()


def _csv_columns():
    rng = np.random.default_rng(1)
    special = [1 / 3, 2.0, 1e-08, -0.0, np.inf, np.nan, 1e16, 123456789.0, -5e-324,
               0.1, 1e22, -1.5e-7]
    return {
        "f32": np.array(special + list(rng.normal(size=8)), np.float32),
        "f64": np.array(special + list(rng.normal(size=8) * 1e3), np.float64),
        "i64": np.arange(20) - 7,
        "i32": (np.arange(20) * 3).astype(np.int32),
        "flag": np.arange(20) % 3 == 0,
        "text": ["x", "a,b", 'q"', "s p", "", "n\nl", "PC 1", "é"] + ["z"] * 12,
    }


@pytest.mark.parametrize("float_format", [None, "%.4f", "%.6f"])
def test_write_csv_equals_pandas(tmp_path, float_format):
    columns = _csv_columns()
    common.write_csv(str(tmp_path / "port.csv"), columns, float_format=float_format)
    pd.DataFrame(columns).to_csv(tmp_path / "pandas.csv", index=False,
                                 float_format=float_format)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()


def test_read_csv_types_as_pandas(tmp_path):
    rng = np.random.default_rng(2)
    columns = {"f32": rng.normal(size=20).astype(np.float32),
               "f64": rng.normal(size=20) * 100, "i64": np.arange(20) - 7}
    common.write_csv(str(tmp_path / "t.csv"), columns, float_format="%.4f")
    names, data = common.read_csv(str(tmp_path / "t.csv"))
    frame = pd.read_csv(tmp_path / "t.csv")
    assert names == list(frame.columns)
    np.testing.assert_array_equal(data, frame.to_numpy(np.float64))


def test_profiling_traces_only_when_asked(tmp_path, monkeypatch):
    """DEEP_CARTO_PROFILE_DIR set: a torch.profiler Chrome trace per stage,
    with the annotated regions; unset: nothing is written."""
    from deep_cartograph_torch.utils import profiling

    @profiling.traced("my stage")
    def work():
        with profiling.annotate("inner region"):
            return float(torch.ones(3).sum())

    monkeypatch.delenv(profiling.PROFILE_ENV, raising=False)
    assert work() == 3.0 and list(tmp_path.iterdir()) == []
    monkeypatch.setenv(profiling.PROFILE_ENV, str(tmp_path))
    assert work() == 3.0
    trace = tmp_path / "my_stage" / "trace.json"
    assert "inner region" in trace.read_text()
