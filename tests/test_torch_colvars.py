"""Port colvars I/O (io/colvars.py) against the JAX package's: files each
package writes read the same in the other, windows, chunks, the NaN screen,
multi-file labels, two-topology translation and the loading-strategy
helpers, on the CPU.

Tolerance: values read are equal to one float32 ulp (rtol 1.2e-7; the two
readers parse a token through different C routines); everything else is
exact."""

import os

import numpy as np
import pytest

from deep_cartograph_tpu.io import colvars as jcol
from deep_cartograph_torch.io import colvars as col
from tests.fixtures import make_shifted_ca_pdb
from tests.test_torch_jax_native import jax_native, jax_native_library  # noqa: F401

ULP = 1.2e-7
NAMES = ["time", "dist-@CA_1-@CA_5", "sin-@CA_1-@CA_2-@CA_3-@CA_4",
         "cos-@CA_1-@CA_2-@CA_3-@CA_4", "dist-@CA_2-@CA_9", "opes.bias"]


def _matrix(n=53, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, len(NAMES))).astype(np.float32) * 3
    m[:, 0] = np.arange(n)
    return m


@pytest.fixture(autouse=True)
def _no_cache():
    col.clear_memory_cache()
    jcol.clear_memory_cache()
    yield
    col.clear_memory_cache()
    jcol.clear_memory_cache()


@pytest.mark.parametrize("fmt", ["%.4f", "%.9g"])
def test_files_read_the_same_in_both_packages(tmp_path, fmt):
    data = _matrix()
    jpath, ppath = str(tmp_path / "jax.dat"), str(tmp_path / "port.dat")
    jcol.write_colvars(jpath, data, NAMES, fmt=fmt)
    col.write_colvars(ppath, data, NAMES, fmt=fmt)
    col.clear_memory_cache()
    jcol.clear_memory_cache()
    for path in (jpath, ppath):
        assert col.read_column_names(path) == jcol.read_column_names(path) == NAMES
        assert col.read_column_names(path, features_only=True) == \
            jcol.read_column_names(path, features_only=True)
        got, names = col.read_features_matrix(path)
        want, jnames = jcol.read_features_matrix(path)
        assert names == jnames == NAMES[1:-1]
        np.testing.assert_allclose(got, want, rtol=ULP, atol=0)
    # both files hold the same numbers
    np.testing.assert_allclose(col.read_features_matrix(ppath)[0],
                               jcol.read_features_matrix(jpath)[0], rtol=ULP, atol=0)
    if fmt == "%.9g":  # float32 round trip
        np.testing.assert_array_equal(col.read_features_matrix(ppath)[0], data[:, 1:-1])


def test_cached_read_equals_file_read(tmp_path):
    path = str(tmp_path / "c.dat")
    col.write_colvars(path, _matrix(), NAMES)
    assert col._cache_get(path) is not None
    cached = col.read_features_matrix(path)[0]
    col.clear_memory_cache()
    np.testing.assert_array_equal(cached, col.read_features_matrix(path)[0])
    # a rewrite of the file invalidates the entry
    col.write_colvars(path, _matrix(seed=1), NAMES)
    with open(path, "a") as fh:
        fh.write("1 2 3 4 5 6\n")
    assert col._cache_get(path) is None


@pytest.mark.parametrize("window", [(0, None, 1), (5, 40, 3), (7, None, 2), (0, 11, 1)])
def test_windows_and_chunks(tmp_path, window):
    path = str(tmp_path / "w.dat")
    jcol.write_colvars(path, _matrix(), NAMES, fmt="%.9g")
    jcol.clear_memory_cache()
    start, stop, stride = window
    sel = NAMES[3:0:-1]  # a selection in another order
    got, _ = col.read_features_matrix(path, sel, start, stop, stride)
    want, _ = jcol.read_features_matrix(path, sel, start, stop, stride)
    np.testing.assert_allclose(got, want, rtol=ULP, atol=0)
    for chunk_rows in (1, 4, 100):
        chunks = list(col.iter_features_chunks(path, chunk_rows, sel, start, stop, stride))
        assert all(c.shape[0] <= chunk_rows for c in chunks)
        np.testing.assert_array_equal(np.concatenate(chunks), got)
        jchunks = list(jcol.iter_features_chunks(path, chunk_rows, sel, start, stop,
                                                 stride))
        assert [c.shape for c in chunks] == [c.shape for c in jchunks]


def test_nan_screen(tmp_path):
    data = _matrix()
    data[20, 4] = np.nan
    path = str(tmp_path / "nan.dat")
    col.write_colvars(path, data, NAMES)
    col.clear_memory_cache()
    with pytest.raises(ValueError, match="Clean your data"):
        col.create_dataframe_from_files([path])
    with pytest.raises(ValueError, match="Clean your data"):
        list(col.iter_features_chunks(path, 8, ["dist-@CA_1-@CA_5"], nan_check=True))
    # without the screen the selected clean column streams
    assert sum(c.shape[0] for c in col.iter_features_chunks(
        path, 8, ["dist-@CA_1-@CA_5"])) == data.shape[0]
    with pytest.raises(ValueError, match="not found"):
        col.read_features_matrix(path, ["dist-@CA_1-@CA_6"])
    with pytest.raises(ValueError, match="negative"):
        list(col.iter_features_chunks(path, 8, start=-3))


def test_multi_file_labels_match_jax(tmp_path):
    paths = []
    for i, n in enumerate((30, 17)):
        paths.append(str(tmp_path / f"f{i}.dat"))
        jcol.write_colvars(paths[-1], _matrix(n, seed=i), NAMES, fmt="%.9g")
    jcol.clear_memory_cache()
    feats = ["dist-@CA_2-@CA_9", "dist-@CA_1-@CA_5"]
    for kwargs in ({}, {"start": 2, "stop": 25, "stride": 2}):
        for features_list in (None, feats):
            matrix, names, labels = col.create_dataframe_from_files(
                paths, features_list=features_list, **kwargs)
            df = jcol.create_dataframe_from_files(paths, features_list=features_list,
                                                  file_label="traj_label", **kwargs)
            want_labels = df.pop("traj_label").to_numpy()
            assert names == list(df.columns)
            np.testing.assert_array_equal(labels, want_labels)
            np.testing.assert_allclose(matrix, df.to_numpy(np.float32), rtol=ULP, atol=0)


def test_two_topology_translation_matches_jax(tmp_path, ca_system):
    """The second file is written on a topology whose residues are numbered
    from 101: its feature names are translated onto the reference's."""
    shifted = make_shifted_ca_pdb(str(tmp_path), ca_system)
    data = _matrix()
    shifted_names = ["time", "dist-@CA_101-@CA_105", "sin-@CA_101-@CA_102-@CA_103-@CA_104",
                     "cos-@CA_101-@CA_102-@CA_103-@CA_104", "dist-@CA_102-@CA_109",
                     "opes.bias"]
    p0, p1 = str(tmp_path / "ref.dat"), str(tmp_path / "shifted.dat")
    jcol.write_colvars(p0, data, NAMES, fmt="%.9g")
    jcol.write_colvars(p1, data[::-1].copy(), shifted_names, fmt="%.9g")
    jcol.clear_memory_cache()
    tops = [ca_system.pdb_path, shifted]
    matrix, names, labels = col.create_dataframe_from_files([p0, p1], tops)
    df = jcol.create_dataframe_from_files([p0, p1], tops, file_label="traj_label")
    assert names == list(df.columns)[:-1] == NAMES[1:-1]
    np.testing.assert_array_equal(labels, df["traj_label"].to_numpy())
    np.testing.assert_allclose(matrix, df.drop(columns="traj_label").to_numpy(np.float32),
                               rtol=ULP, atol=0)
    # read_features goes the other way: reference names onto each file's topology
    got = col.read_features([p0, p1], NAMES[1:-1], tops)
    want = jcol.read_features([p0, p1], NAMES[1:-1], tops).to_numpy(np.float32)
    np.testing.assert_allclose(got, want, rtol=ULP, atol=0)
    assert col.translation_is_identity(tops, None) is \
        jcol.translation_is_identity(tops, None) is False
    assert col.translation_is_identity([shifted, shifted], None) is True


@pytest.mark.parametrize("env_bytes", [None, "1", "0"])
def test_loading_strategy_helpers_match_jax(tmp_path, monkeypatch, env_bytes):
    if env_bytes is not None:
        monkeypatch.setenv("DEEP_CARTO_STREAM_BYTES", env_bytes)
    path = str(tmp_path / "s.dat")
    jcol.write_colvars(path, _matrix(300), NAMES)
    csv = str(tmp_path / "plain.csv")
    with open(csv, "w") as fh:
        fh.write("a,b\n1,2\n")
    for paths in ([path], path, [path, csv]):
        for mode in ("auto", True, "on", False, "off"):
            assert col.should_stream_colvars(paths, mode) == \
                jcol.should_stream_colvars(paths, mode)
    assert col.is_plumed_file(path) and not col.is_plumed_file(csv)
    for window in ((0, None, 1), (10, 100, 3), (400, None, 1)):
        assert col.estimate_matrix_bytes(path, 4, *window) == \
            jcol.estimate_matrix_bytes(path, 4, *window)
    assert col.stream_chunk_rows(path) == jcol.stream_chunk_rows(path)
    assert col.stream_chunk_rows(path, 1000) == jcol.stream_chunk_rows(path, 1000)
    data, names = col.load_table(csv)
    assert names == ["a", "b"] and data.tolist() == [[1.0, 2.0]]


def test_read_colvars_converts_time_to_ns(tmp_path):
    path = str(tmp_path / "t.dat")
    col.write_colvars(path, _matrix(), NAMES)
    data, names = col.read_colvars(path)
    want = jcol.read_colvars(path)
    assert names == list(want.columns)
    np.testing.assert_allclose(data, want.to_numpy(np.float32), rtol=ULP, atol=0)
    assert os.path.getsize(path) > 0
