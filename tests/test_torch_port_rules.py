"""Rules of the PyTorch port: it never loads JAX or the JAX package, and it
never falls back to the CPU when the caller did not ask for it."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import deep_cartograph_torch
from deep_cartograph_torch.deploy import FramesToCV, LinearProjection
from deep_cartograph_torch.fes.kde import compute_fes
from deep_cartograph_torch.geom.engine import Featurizer
from deep_cartograph_torch.geom.kernels import PlanEvaluator
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.utils.device import resolve_device

torch.set_num_threads(2)

PACKAGE_DIR = os.path.dirname(deep_cartograph_torch.__file__)
REPO_ROOT = os.path.dirname(PACKAGE_DIR)

_IMPORT_ALL = """
import importlib, pkgutil, sys
import deep_cartograph_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "deep_cartograph_tpu"))
print(len(names), loaded)
"""


def test_import_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO_ROOT, check=True,
        capture_output=True, text=True, timeout=120,
    ).stdout.split(maxsplit=1)
    n_modules, loaded = int(out[0]), out[1].strip()
    assert n_modules >= 20
    assert loaded == "[]"


def _package_files():
    for root, _, files in os.walk(PACKAGE_DIR):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, name)


def test_no_file_names_the_jax_package():
    pattern = re.compile(r"deep_cartograph_tpu|\bjax\b|\bflax\b")
    offenders = []
    for path in _package_files():
        with open(path) as fh:
            for lineno, line in enumerate(fh, 1):
                if pattern.search(line):
                    offenders.append(f"{os.path.relpath(path, REPO_ROOT)}:{lineno}")
    assert offenders == []


@pytest.fixture
def no_cuda(monkeypatch):
    """Whatever the host has, act as one without a CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, ca_system):
    top = Topology.from_pdb(ca_system.pdb_path)
    labels = ["dist-@CA_1-@CA_5", "sin-@CA_1-@CA_2-@CA_3-@CA_4"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Featurizer(top, labels)
    projection = LinearProjection(
        np.zeros(2), np.ones(2), np.eye(2), np.zeros(2), np.ones(2)
    )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FramesToCV(projection, top, labels)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compute_fes(np.zeros((10, 2), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    # asking for the host is the one way to run there
    assert Featurizer(top, labels, device="cpu").evaluator.device.type == "cpu"
    plan = Featurizer(top, labels, device="cpu").plan
    assert PlanEvaluator(plan, device="cpu").device == torch.device("cpu")
