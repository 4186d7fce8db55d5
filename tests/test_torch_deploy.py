"""Port FramesToCV against the JAX FramesToCV on CVs trained by the JAX
package and carried across with models/weights.py."""

import jax
import numpy as np
import pytest
import torch

from deep_cartograph_tpu.cv import cv_calculators_map
from deep_cartograph_tpu.deploy import FramesToCV as JaxFramesToCV
from deep_cartograph_tpu.geom.engine import Featurizer as JaxFeaturizer
from deep_cartograph_tpu.io.colvars import write_colvars
from deep_cartograph_tpu.io.topology import Topology as JaxTopology
from deep_cartograph_torch.deploy import FramesToCV
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.models.weights import deep_tica_from_jax, linear_from_jax
from tests.test_cv import base_config

torch.set_num_threads(2)

LABELS = [
    "dist-@CA_1-@CA_5",
    "dist-@CA_2-@CA_9",
    "sin-@CA_1-@CA_2-@CA_3-@CA_4",
    "cos-@CA_1-@CA_2-@CA_3-@CA_4",
]


@pytest.fixture(scope="module")
def colvars(tmp_path_factory, ca_system):
    """The training input of tests/test_deploy.py."""
    root = tmp_path_factory.mktemp("torch_deploy")
    top = JaxTopology.from_pdb(ca_system.pdb_path)
    features = JaxFeaturizer(top, LABELS).featurize_trajectory(ca_system.dcd_path)
    path = str(root / "colvars.dat")
    t = np.arange(features.shape[0], dtype=np.float32)
    write_colvars(path, np.column_stack([t, features]), ["time"] + LABELS, fmt="%.6f")
    return path


def _projection(cv_name, calc):
    if cv_name == "pca":
        return linear_from_jax(
            calc.features_norm_mean, calc.features_norm_range, calc.cv,
            calc.cv_norm_mean, calc.cv_norm_range,
        )
    return deep_tica_from_jax(
        jax.tree.map(np.asarray, calc.params), calc.architecture,
        calc.tica_evecs, calc.post_mean, calc.post_range,
    )


@pytest.mark.parametrize("cv_name", ["pca", "deep_tica"])
def test_frames_to_cv_matches_jax(cv_name, colvars, ca_system, tmp_path):
    calc = cv_calculators_map[cv_name](
        configuration=base_config(), output_path=str(tmp_path)
    )
    calc.load_training_data([colvars], [ca_system.pdb_path], features_list=LABELS)
    assert calc.run() is not None
    want = JaxFramesToCV(calc, JaxTopology.from_pdb(ca_system.pdb_path))(
        ca_system.coords
    )

    pipeline = FramesToCV(
        _projection(cv_name, calc), Topology.from_pdb(ca_system.pdb_path),
        calc.features_ref_labels, device="cpu",
    )
    got = pipeline(ca_system.coords)
    assert got.shape == want.shape == (ca_system.coords.shape[0], 2)
    # the repo's projection contract (tests/test_golden.py)
    np.testing.assert_allclose(got, want, atol=1e-4)
