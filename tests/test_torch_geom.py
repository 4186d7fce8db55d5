"""Port featurization (geom/kernels.py, geom/engine.py) against the JAX
package's PlanEvaluator and the committed feature golden."""

import os

import numpy as np
import pytest
import torch

from deep_cartograph_tpu.features.grammar import compile_plan as jax_compile_plan
from deep_cartograph_tpu.geom.kernels import PlanEvaluator as JaxPlanEvaluator
from deep_cartograph_tpu.io.topology import Topology as JaxTopology
from deep_cartograph_torch.features.grammar import compile_plan
from deep_cartograph_torch.geom.engine import Featurizer
from deep_cartograph_torch.geom.kernels import PlanEvaluator
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.ops import pair_distances as torch_pd
from tests.test_golden import GOLDEN_DIR, _feature_labels

torch.set_num_threads(2)


def test_featurize_matches_golden(ca_system):
    top = Topology.from_pdb(ca_system.pdb_path)
    featurizer = Featurizer(top, _feature_labels(), device="cpu")
    before = torch_pd.STATS.plain_calls
    # frame_chunk 16 leaves a ragged last chunk of 12 frames (60 frames)
    feats = featurizer.featurize_trajectory(ca_system.dcd_path, frame_chunk=16)
    assert torch_pd.STATS.plain_calls == before + 4
    want = np.load(os.path.join(GOLDEN_DIR, "features.npy"))
    assert feats.shape == want.shape
    np.testing.assert_allclose(feats, want, atol=1e-4)


PLANS = {
    "selector": (
        ["dist-@CA_1-@CA_5", "dist-@CA_2-@CA_9", "dist-@CA_3-@CA_12",
         "sin-@CA_1-@CA_2-@CA_3-@CA_4", "cos-@CA_1-@CA_2-@CA_3-@CA_4"],
        "auto", False,
    ),
    "forced_matmul": (
        ["dist-@CA_1-@CA_5", "dist-@CA_4-@CA_11", "tor-@CA_2-@CA_3-@CA_4-@CA_5"],
        "matmul", False,
    ),
    "gather_centers": (
        ["dist-1-center_name_CA", "dist-@CA_3-@CA_7",
         "dist-center_resid_1to4-center_resid_9to12", "dist-center_resid_1to4-@CA_6"],
        "auto", False,
    ),
    "gather_forced": (
        ["dist-@CA_1-@CA_5", "dist-@CA_2-@CA_10"],
        "gather", False,
    ),
    "dihedral_modes": (
        ["tor-@CA_1-@CA_2-@CA_3-@CA_4", "sin-@CA_5-@CA_6-@CA_7-@CA_8",
         "cos-@CA_5-@CA_6-@CA_7-@CA_8", "tor-@CA_9-@CA_10-@CA_11-@CA_12"],
        "auto", False,
    ),
    "coords_fit": (
        ["coord-@CA_3.x", "coord-@CA_3.y", "coord-@CA_7.z", "dist-@CA_1-@CA_5"],
        "auto", True,
    ),
    "out_perm": (
        ["cos-@CA_1-@CA_2-@CA_3-@CA_4", "dist-@CA_2-@CA_9", "coord-@CA_5.y",
         "dist-1-center_name_CA", "sin-@CA_1-@CA_2-@CA_3-@CA_4", "dist-@CA_1-@CA_12"],
        "auto", True,
    ),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_evaluator_matches_jax(name, ca_system):
    labels, strategy, fit = PLANS[name]
    coords = ca_system.coords
    fit_ref = fit_w = None
    if fit:
        rng = np.random.default_rng(3)
        fit_ref = coords[0] + rng.normal(0, 0.5, coords[0].shape).astype(np.float32)
        fit_w = rng.uniform(0.5, 1.5, coords.shape[1]).astype(np.float32)

    jax_plan = jax_compile_plan(labels, JaxTopology.from_pdb(ca_system.pdb_path))
    jax_evaluator = JaxPlanEvaluator(
        jax_plan, fit_reference=fit_ref, fit_weights=fit_w, gather_strategy=strategy
    )
    want = jax_evaluator(coords)
    plan = compile_plan(labels, Topology.from_pdb(ca_system.pdb_path))
    evaluator = PlanEvaluator(
        plan, fit_reference=fit_ref, fit_weights=fit_w, gather_strategy=strategy,
        device="cpu",
    )
    got = evaluator(coords)
    assert got.shape == want.shape == (coords.shape[0], len(labels))
    np.testing.assert_allclose(got, want, atol=1e-5)

    # both packages pick the same distance strategy for the plan
    jax_selector = jax_evaluator._dist_selector is not None
    assert evaluator.strategy == ("selector" if jax_selector else "gather")
    if name == "out_perm":
        assert not evaluator._identity_layout
    if name in ("selector", "dihedral_modes"):
        assert evaluator._identity_layout


def test_plan_evaluator_rejects_unknown_strategy(ca_system):
    plan = compile_plan(["dist-@CA_1-@CA_5"], Topology.from_pdb(ca_system.pdb_path))
    with pytest.raises(ValueError, match="gather_strategy"):
        PlanEvaluator(plan, gather_strategy="einsum", device="cpu")


def test_plan_evaluator_rejects_frames_lacking_atoms(ca_system):
    plan = compile_plan(
        ["dist-@CA_1-@CA_5", "sin-@CA_2-@CA_3-@CA_4-@CA_9"],
        Topology.from_pdb(ca_system.pdb_path),
    )
    evaluator = PlanEvaluator(plan, device="cpu")
    assert evaluator(ca_system.coords[:3, :9]).shape == (3, 2)
    with pytest.raises(IndexError, match="9 atoms"):
        evaluator(ca_system.coords[:3, :8])


def test_featurizer_needs_fit_template_for_coordinates(ca_system):
    top = Topology.from_pdb(ca_system.pdb_path)
    with pytest.raises(ValueError, match="fit template"):
        Featurizer(top, ["coord-@CA_3.x"], device="cpu")
