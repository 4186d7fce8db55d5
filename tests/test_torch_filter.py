"""Port Filter (features/filter.py) and schemas (config/schemas.py) against
the JAX package's, on the CPU.

Filter: the same surviving names for the entropy, std, dip and waypoint
screens, in memory and streaming, and the same summary table (statistics
equal within 1e-6: float32 sums in another order, rounded to 3 decimals;
dip p-values within 1e-9). Schemas: the defaults equal the pydantic
models' model_dump(), exactly."""

import numpy as np
import pandas as pd
import pytest
from pydantic import ValidationError

from deep_cartograph_tpu.config import schemas as jschemas
from deep_cartograph_tpu.features.filter import Filter as JaxFilter
from deep_cartograph_tpu.io.colvars import clear_memory_cache, write_colvars
from deep_cartograph_torch.config import schemas
from deep_cartograph_torch.features.filter import Filter
from deep_cartograph_torch.io import colvars as col
from deep_cartograph_torch.stats.descriptors import dip_pvalues
from deep_cartograph_tpu.stats.descriptors import dip_pvalues as jax_dip_pvalues
from tests.fixtures import make_shifted_ca_pdb

N_FRAMES = 300


def _names(n_dist=8):
    names = [f"dist-@CA_{i}-@CA_{i + 4}" for i in range(1, n_dist + 1)]
    for i in range(1, 4):
        names += [f"sin-@CA_{i}-@CA_{i + 1}-@CA_{i + 2}-@CA_{i + 3}",
                  f"cos-@CA_{i}-@CA_{i + 1}-@CA_{i + 2}-@CA_{i + 3}"]
    return names


def _features(n, seed):
    """Distances with spreads from 0.01 to 1 nm, half of them bimodal, and
    sin/cos of angles of different spreads."""
    rng = np.random.default_rng(seed)
    cols = []
    for i in range(8):
        spread = 0.01 * 10 ** (i / 3.5)
        x = rng.normal(1.0 + 0.1 * i, spread, n)
        if i % 2:
            x += np.where(rng.random(n) < 0.5, 0.0, 6 * spread)
        cols.append(x)
    for i in range(3):
        ang = rng.normal(0.3 * i, 0.05 + 0.6 * i, n)
        cols += [np.sin(ang), np.cos(ang)]
    return np.stack(cols, 1).astype(np.float32)


def _write(path, data, names):
    write_colvars(path, np.column_stack([np.arange(len(data)), data]).astype(np.float32),
                  ["time"] + names, fmt="%.6f")
    return path


@pytest.fixture
def files(tmp_path):
    names = _names()
    paths = [_write(str(tmp_path / f"c{i}.dat"), _features(N_FRAMES, i), names)
             for i in range(2)]
    waypoints = _write(str(tmp_path / "wp.dat"), _features(6, 7), names)
    clear_memory_cache()
    col.clear_memory_cache()
    return paths, waypoints


SETTINGS = [
    {"std_quantile": 0.5, "diptest_significance_level": None},
    {"entropy_quantile": 0.3, "diptest_significance_level": None},
    {"diptest_significance_level": 0.05},
    {"entropy_quantile": 0.2, "std_quantile": 0.4, "diptest_significance_level": 0.05},
]


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("settings", SETTINGS)
def test_filter_matches_jax(files, tmp_path, monkeypatch, settings, streaming):
    paths, _ = files
    if streaming:  # every input is then past the streaming threshold
        monkeypatch.setenv("DEEP_CARTO_STREAM_BYTES", "1")
    want = JaxFilter(settings, paths, output_dir=str(tmp_path / "jax")).run(csv_summary=True)
    port = Filter(settings, paths, output_dir=str(tmp_path / "port"), device="cpu")
    assert port._should_stream_stats() is streaming
    got = port.run(csv_summary=True)
    assert got == want
    assert 0 < len(got) < len(_names()) or settings == SETTINGS[2]
    jsum = pd.read_csv(tmp_path / "jax" / "filter_summary.csv")
    psum = pd.read_csv(tmp_path / "port" / "filter_summary.csv")
    assert list(psum.columns) == list(jsum.columns)
    assert (psum["name"] == jsum["name"]).all() and (psum["pass"] == jsum["pass"]).all()
    for key in ("entropy", "std"):
        if key in jsum:
            np.testing.assert_allclose(psum[key], jsum[key], atol=1e-6)
    if "hdtp" in jsum:
        np.testing.assert_allclose(psum["hdtp"], jsum["hdtp"], atol=1e-9)
    with open(tmp_path / "port" / "all_features.txt") as fh:
        assert fh.read().split() == _names()


def test_waypoint_screens_match_jax(files, tmp_path):
    paths, waypoints = files
    settings = {"local_distance_threshold": 11.0, "diptest_significance_level": None,
                "std_quantile": 0.2}
    want = JaxFilter(settings, paths, [waypoints],
                     output_dir=str(tmp_path / "jax")).run(csv_summary=True)
    port = Filter(settings, paths, [waypoints], output_dir=str(tmp_path / "port"),
                  device="cpu")
    got = port.run(csv_summary=True)
    assert got == want and len(got) < len(_names())
    jsum = pd.read_csv(tmp_path / "jax" / "filter_summary.csv")
    psum = pd.read_csv(tmp_path / "port" / "filter_summary.csv")
    for key in ("waypoint_difference", "is_local_contact", "pass"):
        assert (psum[key] == jsum[key]).all(), key


def test_filter_translates_topologies_like_jax(files, tmp_path, ca_system):
    """A second file written on a topology numbered from 101: its names are
    translated onto the reference topology before the common features and
    the statistics are taken."""
    paths, _ = files
    shifted = make_shifted_ca_pdb(str(tmp_path), ca_system)
    names = []
    for name in _names():
        kind, *atoms = name.split("-")
        names.append("-".join([kind] + [f"@CA_{int(a.split('_')[1]) + 100}"
                                         for a in atoms]))
    moved = _write(str(tmp_path / "shifted.dat"), _features(N_FRAMES, 5), names)
    clear_memory_cache()
    col.clear_memory_cache()
    tops = [ca_system.pdb_path, shifted]
    settings = {"std_quantile": 0.5, "entropy_quantile": 0.2,
                "diptest_significance_level": None}
    want = JaxFilter(settings, [paths[0], moved], topologies=tops,
                     output_dir=str(tmp_path / "jax")).run()
    port = Filter(settings, [paths[0], moved], topologies=tops,
                  output_dir=str(tmp_path / "port"), device="cpu")
    assert port.common_ref_features == _names()
    assert port.run() == want and 0 < len(want) < len(_names())


def test_dip_pvalues_match_jax():
    x = _features(N_FRAMES, 3)
    np.testing.assert_allclose(dip_pvalues(x), jax_dip_pvalues(x), atol=1e-9)


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------

def test_schema_defaults_equal_pydantic_dump():
    assert schemas.filter_features_config() == jschemas.FilterFeaturesSchema().model_dump()
    assert schemas.train_colvars_config() == jschemas.TrainColvarsSchema().model_dump()


@pytest.mark.parametrize("settings", [
    {"compute_diptest": False},
    {"compute_diptest": True, "diptest_significance_level": None},
    {"compute_entropy": True},
    {"compute_entropy": True, "entropy_quantile": 0.3},
    {"compute_std": False, "std_quantile": 0.5},
    {"compute_std": True},
])
def test_filter_gates_equal_pydantic(settings):
    cfg = {"filter_settings": settings}
    assert schemas.filter_features_config(cfg) == \
        jschemas.FilterFeaturesSchema(**cfg).model_dump()


def test_scalar_broadcast_and_overrides_equal_pydantic():
    cfg = {
        "cvs": ["pca", "deep_tica"],
        "common": {
            "dimension": 3,
            "architecture": {"encoder": {"layers": [16, 8], "dropout": 0.1,
                                         "activation": "tanh", "batchnorm": True}},
            "training": {"kl_annealing": {"type": "sigmoid"},
                         "lr_scheduler": {"name": "ReduceLROnPlateau"}},
            "streaming": "on",
        },
        "deep_tica": {"lag_time": 5, "training": {"general": {"max_epochs": 3}}},
    }
    got = schemas.train_colvars_config(cfg)
    assert got == jschemas.TrainColvarsSchema(**cfg).model_dump()
    assert got["common"]["architecture"]["encoder"]["dropout"] == [0.1, 0.1]
    merged = schemas.cv_configuration(got, "deep_tica")
    assert merged["lag_time"] == 5 and merged["dimension"] == 3
    assert merged["training"]["general"]["max_epochs"] == 3
    assert merged["training"]["general"]["batch_size"] == 32
    assert schemas.cv_configuration(got, "pca") == got["common"]


@pytest.mark.parametrize("cfg", [
    {"cvs": ["pca", "lda"]},
    {"common": {"features_normalization": "zscore"}},
    {"common": {"architecture": {"encoder": {"activation": ["tanh", "swish"]}}}},
    {"common": {"training": {"model_to_save": "first"}}},
    {"common": {"streaming": "maybe"}},
    {"common": {"dimension": "two"}},
])
def test_bad_values_raise_in_both(cfg):
    with pytest.raises(ValidationError):
        jschemas.TrainColvarsSchema(**cfg)
    with pytest.raises(schemas.ConfigError):
        schemas.train_colvars_config(cfg)
