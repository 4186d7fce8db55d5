"""No run loads JAX or the JAX package: names compared whole."""

import ast
import subprocess
import sys

import pytest

from carto_bench.harness import HERE, ROOT, forbidden_modules


@pytest.mark.parametrize("name, found", [
    ("deep_cartograph_torch", []),
    ("deep_cartograph_torch.geom.engine", []),
    ("deep_cartograph_tpu", ["deep_cartograph_tpu"]),
    ("deep_cartograph_tpu.ops.pallas_kernels", ["deep_cartograph_tpu"]),
    ("jax", ["jax"]),
    ("jax.numpy", ["jax"]),
    ("jaxlib.xla_client", ["jaxlib"]),
    ("flax.linen", ["flax"]),
    ("deep_cartograph", ["deep_cartograph"]),
    ("deep_cartograph.modules.md", ["deep_cartograph"]),
    ("jaxtyping", []),
])
def test_whole_name_guard(name, found):
    assert forbidden_modules([name]) == found


def test_no_harness_source_imports_a_forbidden_module():
    for path in HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            else:
                continue
            assert not forbidden_modules(names), f"{path.name} imports {names}"


def test_a_run_loads_no_forbidden_module():
    """Every job, metric and what they import, in a fresh process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from carto_bench.harness import HERE, load_module, forbidden_modules\n"
        "import carto_bench.control\n"
        "for p in sorted(HERE.glob('jobs/*.py')) + sorted(HERE.glob('metrics/*.py')):\n"
        "    load_module(p)\n"
        "import deep_cartograph_torch.deploy, deep_cartograph_torch.cv.deep\n"
        "import deep_cartograph_torch.geom.engine, deep_cartograph_torch.io.traj\n"
        "import deep_cartograph_torch.config.schemas, deep_cartograph_torch.models.weights\n"
        "print(forbidden_modules(sys.modules))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
