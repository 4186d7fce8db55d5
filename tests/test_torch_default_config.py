"""The port's default configuration (deep_cartograph_torch/default_config.yml)
against the JAX package's: the same keys and values, validated by the
port's schemas (config/schemas.py::deep_cartograph_config) to the dict that
the JAX package's pydantic `DeepCartograph(**cfg).model_dump()` gives, and
shipped as package data."""

import ast
from pathlib import Path

import yaml

from deep_cartograph_torch.config.schemas import deep_cartograph_config
from deep_cartograph_tpu.config.schemas import DeepCartograph

ROOT = Path(__file__).resolve().parents[1]
PORT_FILE = ROOT / "deep_cartograph_torch" / "default_config.yml"
JAX_FILE = ROOT / "deep_cartograph_tpu" / "default_config.yml"


def _load(path: Path) -> dict:
    return yaml.safe_load(path.read_text())


def test_the_port_file_validates_through_the_port_schemas():
    config = _load(PORT_FILE)
    validated = deep_cartograph_config(config)
    assert set(validated) == set(config)
    assert validated["compute_features"]["engine"] == config["compute_features"]["engine"]
    assert validated["train_colvars"]["cvs"] == ["pca", "ae", "htica", "deep_tica"]


def test_the_port_file_equals_the_jax_file_validated():
    port, jax_file = _load(PORT_FILE), _load(JAX_FILE)
    assert port == jax_file
    assert deep_cartograph_config(port) == DeepCartograph(**jax_file).model_dump()


def test_setup_ships_the_port_file():
    tree = ast.parse((ROOT / "setup.py").read_text())
    call = next(node for node in ast.walk(tree)
                if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "setup")
    package_data = ast.literal_eval(
        next(k.value for k in call.keywords if k.arg == "package_data"))
    assert "default_config.yml" in package_data["deep_cartograph_torch"]
    assert PORT_FILE.is_file()
