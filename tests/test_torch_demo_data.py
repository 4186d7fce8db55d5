"""The port's demo datasets (deep_cartograph_torch/utils/demo_data.py) against
the JAX package's, on the CPU: the synthetic systems equal, the
materialized trees byte-equal. Two lines name the package that wrote them
and are the only bytes allowed to differ: the `.generated` marker of each
dataset and the 80-byte title of each DCD ("Created by <package>")."""

import os

import numpy as np
import pytest

from deep_cartograph_torch.io.dcd import read_dcd, read_dcd_header
from deep_cartograph_torch.utils import demo_data as tdemo
from deep_cartograph_tpu.utils import demo_data as jdemo
from tests.test_torch_jax_native import jax_native, jax_native_library  # noqa: F401


def test_systems_equal_the_jax_generators(tmp_path):
    for args in ((12, 60, 7), (24, 1, 8), (5, 3, 1)):
        got, want = tdemo.ca_coords(*args), jdemo.ca_coords(*args)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tdemo.muller_brown_trajectory(500, seed=2),
                                  jdemo.muller_brown_trajectory(500, seed=2))
    coords = tdemo.ca_coords(9, 4)
    tdemo.write_ca_pdb(str(tmp_path / "a.pdb"), coords[0])
    jdemo.write_ca_pdb(str(tmp_path / "b.pdb"), coords[0])
    assert (tmp_path / "a.pdb").read_bytes() == (tmp_path / "b.pdb").read_bytes()
    quad = [0, 1, 2, 3]
    np.testing.assert_array_equal(tdemo._np_dihedral(coords, quad),
                                  jdemo._np_dihedral(coords, quad))
    assert tdemo.CALPHA_SYSTEMS == jdemo.CALPHA_SYSTEMS
    assert tdemo._DATASET_VERSIONS == jdemo._DATASET_VERSIONS
    assert tdemo.DATASETS == jdemo.DATASETS


def _files(root):
    out = {}
    for folder, _, names in os.walk(root):
        for name in names:
            path = os.path.join(folder, name)
            out[os.path.relpath(path, root)] = path
    return out


# The first DCD title line: after the 92-byte control record and the title
# record's length and count words.
TITLE_LO, TITLE_HI = 92 + 8, 92 + 8 + 80


@pytest.mark.parametrize("name", jdemo.DATASETS)
def test_materialized_trees_equal_the_jax_package(tmp_path, name):
    tdemo.materialize(str(tmp_path / "port"), [name])
    jdemo.materialize(str(tmp_path / "jax"), [name])
    got, want = _files(tmp_path / "port" / name), _files(tmp_path / "jax" / name)
    assert sorted(got) == sorted(want)
    for rel in sorted(want):
        a, b = open(got[rel], "rb").read(), open(want[rel], "rb").read()
        if rel == ".generated":
            tag = f"v{jdemo._DATASET_VERSIONS[name]}"
            assert a == f"generated by deep_cartograph_torch.utils.demo_data {tag}\n".encode()
            assert b == f"generated by deep_cartograph_tpu.utils.demo_data {tag}\n".encode()
        elif rel.endswith(".dcd"):
            lo, hi = TITLE_LO, TITLE_HI
            assert a[lo:hi] == b"Created by deep_cartograph_torch".ljust(80)
            assert b[lo:hi] == b"Created by deep_cartograph_tpu".ljust(80)
            assert len(a) == len(b) and a[:lo] + a[hi:] == b[:lo] + b[hi:], rel
            assert read_dcd_header(got[rel])[0] > 0
            np.testing.assert_array_equal(read_dcd(got[rel]), read_dcd(want[rel]))
        else:
            assert a == b, rel


def test_materialize_skips_current_and_rebuilds_stale(tmp_path):
    root = str(tmp_path)
    tdemo.materialize(root, ["muller_brown"])
    data = os.path.join(root, "muller_brown", "px_py.dat")
    os.remove(data)
    tdemo.materialize(root, ["muller_brown"])  # current marker: skipped
    assert not os.path.exists(data)
    tdemo.materialize(root, ["muller_brown"], force=True)
    assert os.path.exists(data)
    os.remove(data)
    with open(os.path.join(root, "muller_brown", ".generated"), "w") as fh:
        fh.write("generated by an older generator v0\n")
    tdemo.materialize(root, ["muller_brown"])  # stale marker: rebuilt
    assert os.path.exists(data)
