"""Rules of the PyTorch port: it never loads JAX, the JAX package, nor the
libraries the card machine lacks (pandas, pydantic, yaml, msgpack, flax,
matplotlib, sklearn) when imported; it imports matplotlib only where it
draws a figure and PyYAML only where it reads a configuration that is not
JSON; and it never falls back to the CPU when the caller did not ask for
it."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import deep_cartograph_torch
from deep_cartograph_torch.cv.deep import DeepTICACalculator
from deep_cartograph_torch.cv.tica_math import tica
from deep_cartograph_torch.deploy import FramesToCV, LinearProjection
from deep_cartograph_torch.fes.kde import compute_fes
from deep_cartograph_torch.geom.engine import Featurizer
from deep_cartograph_torch.geom.kernels import PlanEvaluator
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.models.training import Trainer, TrainerConfig
from deep_cartograph_torch.ops.pairwise_distance_matrix import pairwise_distance_matrix
from deep_cartograph_torch.stats import descriptors
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
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "deep_cartograph_tpu", "pandas", "pydantic", "yaml",
    "msgpack", "matplotlib", "sklearn"))
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
            if name.endswith((".py", ".cu", ".cuh", ".cpp")):
                yield os.path.join(root, name)


FORBIDDEN_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|deep_cartograph_tpu|pandas|pydantic|yaml|"
    r"msgpack|matplotlib|sklearn)\b"
)


# The two imports the port may make, each inside one function and nowhere
# at module level: matplotlib where figures are drawn, PyYAML where a
# configuration that is not JSON is read.
ALLOWED_IMPORTS = {
    ("deep_cartograph_torch/figures/plots.py", "pyplot"): re.compile(
        r"^\s+import matplotlib(\.pyplot as plt)?$"),
    ("deep_cartograph_torch/utils/common.py", "read_configuration"): re.compile(
        r"^\s+import yaml$"),
}


def _enclosing_functions(path):
    """Line number -> name of the innermost function defined around it."""
    import ast

    with open(path) as fh:
        tree = ast.parse(fh.read())
    owner = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for line in range(node.lineno, node.end_lineno + 1):
                if line not in owner or owner[line][0] < node.lineno:
                    owner[line] = (node.lineno, node.name)
    return {line: name for line, (_, name) in owner.items()}


def _forbidden_imports(path, rel=None):
    """The forbidden import lines of `path` (`rel`: the repo path it stands
    for, by default its own) that are not an allowed exception."""
    rel = rel or os.path.relpath(path, REPO_ROOT)
    functions = None
    offenders = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            if not FORBIDDEN_IMPORT.search(line):
                continue
            if path.endswith(".py") and functions is None:
                functions = _enclosing_functions(path)
            allowed = ALLOWED_IMPORTS.get((rel, (functions or {}).get(lineno)))
            if allowed is None or not allowed.match(line.rstrip("\n")):
                offenders.append(f"{rel}:{lineno}")
    return offenders


def test_no_file_imports_a_forbidden_library():
    offenders = []
    for path in list(_package_files()) + [os.path.join(REPO_ROOT, "chip_smoke.py")]:
        offenders += _forbidden_imports(path)
    assert offenders == []


def test_the_allowed_imports_are_the_only_ones(tmp_path):
    """The two exceptions hold only inside their own function: the same
    line at module level, or in another function or file, is refused."""
    assert len(ALLOWED_IMPORTS) == 2
    plots = os.path.join(PACKAGE_DIR, "figures", "plots.py")
    common = os.path.join(PACKAGE_DIR, "utils", "common.py")
    assert _forbidden_imports(plots) == [] and _forbidden_imports(common) == []
    for rel, body in (
        ("deep_cartograph_torch/figures/plots.py", "import matplotlib\n"),
        ("deep_cartograph_torch/figures/plots.py",
         "def draw():\n    import matplotlib\n"),
        ("deep_cartograph_torch/utils/common.py",
         "def pyplot():\n    import yaml\n"),
        ("deep_cartograph_torch/fes/kde.py", "def pyplot():\n    import matplotlib\n"),
        ("deep_cartograph_torch/utils/common.py",
         "def read_configuration():\n    import pandas\n"),
    ):
        path = tmp_path / "candidate.py"
        path.write_text(body)
        assert len(_forbidden_imports(str(path), rel)) == 1, (rel, body)


def test_chip_smoke_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; print(sorted(m for m in "
         "sys.modules if m.split('.')[0] in ('jax', 'flax', 'deep_cartograph_tpu')))"],
        cwd=REPO_ROOT, check=True, capture_output=True, text=True, timeout=120,
    ).stdout.strip()
    assert out == "[]"


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


@pytest.fixture
def restore_port_logger():
    """cli.main configures the `deep_cartograph_torch` logger (handlers, no
    propagation); put it back as it was."""
    import logging

    logger = logging.getLogger("deep_cartograph_torch")
    saved = (list(logger.handlers), logger.propagate, logger.level)
    yield
    for handler in logger.handlers:
        if handler not in saved[0]:
            handler.close()
    logger.handlers[:], logger.propagate, logger.level = saved[0], saved[1], saved[2]


def test_entry_points_raise_without_cuda(no_cuda, ca_system, tmp_path, monkeypatch,
                                         restore_port_logger):
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

    # every tool but the host-only traj_augmentation, the pipeline and its
    # command line
    from deep_cartograph_torch import cli, deep_cartograph, tools
    from deep_cartograph_torch.io.colvars import write_colvars

    colvars = str(tmp_path / "colvars.dat")
    write_colvars(colvars, np.random.default_rng(0).normal(2, 0.3, (30, 2)), labels)
    traj, pdb, out = ca_system.dcd_path, ca_system.pdb_path, str(tmp_path / "out")
    for call in (
        lambda: tools.compute_features({}, traj, pdb, output_folder=out),
        lambda: tools.filter_features({}, [colvars], output_folder=out),
        lambda: tools.train_colvars({}, [colvars], output_folder=out),
        lambda: tools.traj_projection({}, [colvars], model_paths=[], output_folder=out),
        lambda: tools.traj_cluster({}, [colvars], output_folder=out),
        lambda: tools.analyze_geometry({}, [traj], [pdb], output_folder=out),
        lambda: tools.align_trajectories(traj, pdb, output_folder=out),
        lambda: deep_cartograph({}, traj, pdb, output_folder=out),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    conf = tmp_path / "conf.json"
    conf.write_text("{}")
    monkeypatch.setattr(sys, "argv", ["deep_carto_torch", "-conf", str(conf),
                                      "-traj_data", traj, "-top_data", pdb,
                                      "-out", str(tmp_path / "cli")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main()
    # the engine block's "cpu" is the configuration's way to featurize there
    engine = {"device": "cpu", "dtype": "float32", "shard_frames": True,
              "frame_chunk": 2048}
    from deep_cartograph_torch.tools.compute_features import engine_device

    assert engine_device(engine).type == "cpu"
    for value in ("auto", "default"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine_device(dict(engine, device=value))
    with pytest.raises(ValueError, match="float32"):
        engine_device(dict(engine, device="cpu", dtype="bfloat16"))


def test_training_slice_entry_points_raise_without_cuda(no_cuda):
    x = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    for call in (
        lambda: descriptors.shannon_entropy(x),
        lambda: descriptors.standard_deviation(x),
        lambda: descriptors.feature_statistics(x),
        lambda: descriptors.min_value_filter(x, 0.1),
        lambda: Trainer(lambda *a: None, TrainerConfig()),
        lambda: DeepTICACalculator({"dimension": 2}),
        lambda: tica(x[:-1], x[1:], 2),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # asking for the host is the one way to run there
    assert DeepTICACalculator({"dimension": 2}, device="cpu").device.type == "cpu"
    assert descriptors.standard_deviation(x, device="cpu").shape == (3,)


def test_cv_surface_entry_points_raise_without_cuda(no_cuda, tmp_path, ca_system):
    """The calculators of every family, CVCalculator.load,
    FramesToCV.from_model_zip, the Filter, StreamingHTICA and the
    TorchScript projector resolve device=None to CUDA."""
    from deep_cartograph_torch.cv import cv_calculators_map
    from deep_cartograph_torch.cv.base import CVCalculator
    from deep_cartograph_torch.cv.htica_stream import StreamingHTICA
    from deep_cartograph_torch.features.filter import Filter
    from deep_cartograph_torch.io.colvars import write_colvars
    from deep_cartograph_torch.models.torch_export import TorchScriptProjector

    colvars = str(tmp_path / "c.dat")
    x = np.random.default_rng(0).normal(2.0, 0.3, size=(30, 3)).astype(np.float32)
    write_colvars(colvars, x, ["dist-@CA_1-@CA_5", "dist-@CA_2-@CA_9",
                               "dist-@CA_3-@CA_11"])
    for name in ("pca", "tica", "htica", "deep_tica", "ae", "vae", "umap"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cv_calculators_map[name]({"dimension": 2}, str(tmp_path))
        calc = cv_calculators_map[name]({"dimension": 1, "num_subspaces": 1,
                                         "subspaces_dimension": 1},
                                        str(tmp_path / "out"), device="cpu")
        assert calc.device.type == "cpu"
    pca = cv_calculators_map["pca"]({"dimension": 1}, str(tmp_path / "out"), device="cpu")
    pca.load_training_data([colvars], [ca_system.pdb_path])
    pca.run()
    model = str(tmp_path / "out" / "pca" / "model.zip")
    for call in (
        lambda: Filter({"std_quantile": 0.5}, [colvars], output_dir=str(tmp_path)),
        lambda: StreamingHTICA(4, 2, 1, 1, 1),
        lambda: TorchScriptProjector(str(tmp_path / "cv_weights.pt")),
        lambda: CVCalculator.load(model, str(tmp_path / "load")),
        lambda: FramesToCV.from_model_zip(model, ca_system.pdb_path, str(tmp_path / "s")),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    served = FramesToCV.from_model_zip(model, ca_system.pdb_path, str(tmp_path / "s"),
                                       device="cpu")
    assert served.device.type == "cpu"


def test_autoencoder_and_plumed_entry_points_raise_without_cuda(no_cuda, tmp_path,
                                                                 ca_system):
    """The AE and VAE calculators (built or loaded), the serving of their
    projections, the TorchScript trace and the waypoint alignment resolve
    device=None to CUDA; write_plumed_files and save_weights trace on the
    calculator's own device."""
    from deep_cartograph_torch.cv import cv_calculators_map
    from deep_cartograph_torch.cv.base import CVCalculator
    from deep_cartograph_torch.geom.structure import create_rmsd_waypoint_reference
    from deep_cartograph_torch.models.torch_export import save_torchscript

    x = np.random.default_rng(0).normal(2.0, 0.3, size=(40, 2)).astype(np.float32)
    labels = ["dist-@CA_1-@CA_5", "dist-@CA_2-@CA_9"]
    config = {"dimension": 1, "architecture": {"encoder": {"layers": [3]}},
              "training": {"general": {"max_epochs": 2, "num_tries": 1, "batch_size": 8}}}
    trained = {}
    for name in ("ae", "vae"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cv_calculators_map[name](config)
        calc = cv_calculators_map[name](config, str(tmp_path / name), device="cpu")
        calc._set_training_data(x, None, labels)
        calc.ref_topology_path = ca_system.pdb_path
        assert calc.train()
        calc.normalize_cv()
        trained[name] = calc
    trained["ae"].create_output_folders()
    trained["ae"].save_model()
    top = Topology.from_pdb(ca_system.pdb_path)
    for call in (
        lambda: CVCalculator.load(str(trained["ae"].output_path / "model.zip"),
                                  str(tmp_path / "l")),
        lambda: FramesToCV(trained["ae"].projection(), top, labels),
        lambda: FramesToCV(trained["vae"].projection(), top, labels),
        lambda: save_torchscript(trained["ae"].projection(), 2, str(tmp_path / "w.pt")),
        lambda: create_rmsd_waypoint_reference(
            [ca_system.pdb_path] * 2, ca_system.pdb_path, str(tmp_path / "ref.pdb")),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # asking for the host is the one way to run there
    assert FramesToCV(trained["ae"].projection(), top, labels, device="cpu").device.type \
        == "cpu"
    (tmp_path / "plumed").mkdir()
    trained["vae"].write_plumed_files(ca_system.pdb_path, str(tmp_path / "plumed"))
    assert sorted(os.listdir(tmp_path / "plumed")) == ["plumed_vae_unbiased.zip"]
    # a calculator on the card traces its weights there
    trained["vae"].device = torch.device("cuda")
    for call in (
        lambda: trained["vae"].write_plumed_files(ca_system.pdb_path, str(tmp_path)),
        lambda: trained["vae"].save_weights(str(tmp_path / "w.pt")),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_clustering_and_multi_trajectory_entry_points_raise_without_cuda(
        no_cuda, ca_system):
    """k-means, the scores, HDBSCAN, the nearest-neighbour search, the
    centroid marking, the scan and multi-trajectory featurization resolve
    device=None to CUDA."""
    from deep_cartograph_torch.cluster import clustering
    from deep_cartograph_torch.geom.engine import featurize_trajectory

    x = np.random.default_rng(0).normal(size=(40, 2)).astype(np.float32)
    labels = np.arange(40) % 3
    top = Topology.from_pdb(ca_system.pdb_path)
    features = ["dist-@CA_1-@CA_5"]
    for call in (
        lambda: clustering.kmeans_clustering(x, 3, 2),
        lambda: clustering.kmeans_clustering(x, 3, 1, initial_centroids=x[:3]),
        lambda: clustering.clustering_scores(x, labels),
        lambda: clustering.hdbscan_clustering(x),
        lambda: clustering.hdbscan_fit(x),
        lambda: clustering.assign_nearest_neighbor(x, x),
        lambda: clustering.find_centroids(x, x[:2]),
        lambda: clustering.optimize_clustering(x, {"algorithm": "kmeans",
                                                   "search_interval": [2, 3]}),
        lambda: Featurizer(top, features).featurize_trajectories([ca_system.dcd_path]),
        lambda: featurize_trajectory(ca_system.dcd_path, ca_system.pdb_path, features),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # asking for the host is the one way to run there
    assert clustering.assign_nearest_neighbor(x, x, device="cpu").tolist() == \
        list(range(40))
    featurizer = Featurizer(top, features, device="cpu")
    assert featurizer.featurize_trajectories([ca_system.dcd_path])[0].shape == (60, 1)


def test_geometry_and_umap_entry_points_raise_without_cuda(no_cuda, tmp_path, ca_system):
    """RMSD, RMSF, dRMSD (and their md surface names), the H-bond analysis
    and mask, the Müller-Brown sampler, the UMAP model and calculator (built
    or loaded) resolve device=None to CUDA."""
    from deep_cartograph_torch import md
    from deep_cartograph_torch.cv import cv_calculators_map
    from deep_cartograph_torch.cv.base import CVCalculator
    from deep_cartograph_torch.cv.umap_cv import UMAPModel
    from deep_cartograph_torch.data.muller_brown import sample_trajectory
    from deep_cartograph_torch.geom import analysis, hbonds
    from deep_cartograph_torch.io.colvars import write_colvars

    traj, top = ca_system.dcd_path, ca_system.pdb_path
    colvars = str(tmp_path / "c.dat")
    x = np.random.default_rng(0).normal(2.0, 0.3, size=(30, 3)).astype(np.float32)
    labels = ["dist-@CA_1-@CA_5", "dist-@CA_2-@CA_9", "dist-@CA_3-@CA_11"]
    write_colvars(colvars, x, labels)
    umap = cv_calculators_map["umap"]({"dimension": 2}, str(tmp_path / "out"), device="cpu")
    umap.load_training_data([colvars], [top])
    umap.run()
    model = str(tmp_path / "out" / "umap" / "model.zip")
    for call in (
        lambda: analysis.RMSD(traj, top, "name CA", "name CA"),
        lambda: analysis.RMSF(traj, top, "name CA", "name CA"),
        lambda: analysis.dRMSD(traj, top, "name CA", 1, top),
        lambda: md.RMSD(traj, top, "name CA", "name CA"),
        lambda: md.RMSF(traj, top, "name CA", "name CA"),
        lambda: md.dRMSD(traj, top, "name CA", 1, top),
        lambda: hbonds.analyze_residue_hbonds(top, traj, "all", "all"),
        lambda: hbonds.hbond_mask(np.zeros((2, 3, 3)), [0], [1], [2], 3.0, 150.0),
        lambda: sample_trajectory(n_frames=2, stride=1),
        lambda: UMAPModel(2),
        lambda: cv_calculators_map["umap"]({"dimension": 2}, str(tmp_path)),
        lambda: CVCalculator.load(model, str(tmp_path / "load")),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # asking for the host is the one way to run there
    assert analysis.RMSD(traj, top, "name CA", "name CA", device="cpu").shape == (60,)
    assert sample_trajectory(n_frames=2, stride=1, device="cpu").shape == (2, 2)
    loaded = CVCalculator.load(model, str(tmp_path / "load"), device="cpu")
    assert loaded.cv.device.type == "cpu"
    assert loaded.project_data(x).shape == (30, 2)


def test_kernel_wrapper_takes_its_plain_version_only_for_cpu_tensors():
    """A tensor that is not on the CPU never reaches the plain version: on a
    CUDA tensor the wrapper launches its kernel, on any other it raises."""
    with pytest.raises(ValueError, match="Unsupported device"):
        pairwise_distance_matrix(torch.zeros((2, 4, 3), device="meta"))


def test_native_io_entry_points_raise_without_cuda(no_cuda, ca_system):
    """The int16 upload and the Featurizer of either transport resolve
    device=None to CUDA; the host-only native readers take no device."""
    from deep_cartograph_torch.io.traj import iter_frame_chunks
    from deep_cartograph_torch.io.upload import upload_coords

    block = ca_system.coords[:4]
    top = Topology.from_pdb(ca_system.pdb_path)
    labels = ["dist-@CA_1-@CA_5", "sin-@CA_1-@CA_2-@CA_3-@CA_4"]
    for call in (
        lambda: upload_coords(block),
        lambda: upload_coords(block, "float32"),
        lambda: Featurizer(top, labels).featurize_trajectory(ca_system.dcd_path,
                                                             upload="int16"),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # asking for the host is the one way to run there
    assert upload_coords(block, device="cpu").device.type == "cpu"
    feats = Featurizer(top, labels, device="cpu").featurize_trajectory(
        ca_system.dcd_path, upload="int16")
    assert feats.shape == (60, 2)
    assert sum(len(c) for c in iter_frame_chunks(ca_system.dcd_path, 16)) == 60


NATIVE_SOURCES = {
    "io/colvars.py": ("_SOURCE", "io/csrc/colvars_io.cpp"),
    "io/dcd.py": ("_SOURCE", "io/csrc/dcdloader.cpp"),
    "io/xtc.py": ("_CODEC_SOURCE", "io/csrc/xdrcodec.cpp"),
    "stats/descriptors.py": ("_DIP_SOURCE", "stats/csrc/diptest.cpp"),
    "geom/transport.py": ("_STAGE_SOURCE", "geom/csrc/stage_atoms.cpp"),
}


def test_native_code_is_the_ports_own_and_a_failed_build_raises(monkeypatch, tmp_path):
    """Every host library is built from the port's own copy of its source,
    and none has a numpy fallback: without a compiler, the colvars writer
    and reader, the DCD prefetch reader and the dip test raise, naming their
    source."""
    import importlib

    from deep_cartograph_torch.geom import transport
    from deep_cartograph_torch.io import colvars, dcd
    from deep_cartograph_torch.ops import build

    for module, (attr, rel) in NATIVE_SOURCES.items():
        mod = importlib.import_module("deep_cartograph_torch." + module[:-3].replace("/", "."))
        assert str(getattr(mod, attr)) == os.path.join(PACKAGE_DIR, rel)
        assert os.path.isfile(os.path.join(PACKAGE_DIR, rel))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    x = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    dcd_path = str(tmp_path / "t.dcd")
    dcd.write_dcd(dcd_path, x.reshape(20, 1, 3))
    colvars_path = str(tmp_path / "c.dat")
    with open(colvars_path, "w") as fh:
        fh.write("#! FIELDS a b c\n1 2 3\n")
    colvars.clear_memory_cache()
    for call, source in (
        (lambda: colvars.write_colvars(str(tmp_path / "w.dat"), x, ["a", "b", "c"]),
         "colvars_io.cpp"),
        (lambda: colvars.read_features_matrix(colvars_path), "colvars_io.cpp"),
        (lambda: next(dcd.iter_dcd_chunks_prefetch(dcd_path, 8)), "dcdloader.cpp"),
        (lambda: descriptors.dip_pvalues(x), "diptest.cpp"),
        (lambda: transport.stage_atoms(x.reshape(20, 1, 3), None, torch.empty(60)),
         "stage_atoms.cpp"),
    ):
        with pytest.raises(RuntimeError, match=f"g\\+\\+ not found; {source}"):
            call()


PARALLEL_MODULES = ("__init__", "mesh", "sharding", "training")


def test_the_parallel_package_imports_no_jax():
    """parallel/* exist, fall under the import rules above (which walk the
    whole package), and load neither JAX nor the JAX package."""
    files = [os.path.join(PACKAGE_DIR, "parallel", f"{m}.py") for m in PARALLEL_MODULES]
    assert all(os.path.isfile(f) for f in files)
    assert set(files) <= set(_package_files())
    assert all(_forbidden_imports(f) == [] for f in files)
    out = subprocess.run(
        [sys.executable, "-c", "import sys; import deep_cartograph_torch.parallel.training, "
         "deep_cartograph_torch.parallel; print(sorted(m for m in sys.modules if "
         "m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'deep_cartograph_tpu')))"],
        cwd=REPO_ROOT, check=True, capture_output=True, text=True, timeout=120,
    ).stdout.strip()
    assert out == "[]"


def test_parallel_entry_points_raise_without_cuda(no_cuda):
    """get_mesh() is every visible card and raises without one; a mesh of
    CUDA devices raises too; only a mesh the caller builds holds the CPU,
    and nothing shards a CPU call without one."""
    from deep_cartograph_torch.parallel import (
        Mesh,
        get_mesh,
        init_distributed,
        mesh_for,
        use_mesh,
    )
    from deep_cartograph_torch.parallel.sharding import (
        sharded_covariances,
        sharded_feature_matrix_stats,
        sharded_kde_logsumexp,
    )

    x = np.zeros((8, 2), np.float32)
    for call in (
        get_mesh,
        lambda: Mesh(("cuda:0",)),
        lambda: Mesh(("cuda",) * 2),
        lambda: sharded_covariances(x, x),
        lambda: sharded_feature_matrix_stats(x),
        lambda: sharded_kde_logsumexp(x, x, 1.0),
        lambda: init_distributed("127.0.0.1:1", 2, 0),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert mesh_for(torch.device("cpu")).devices == (torch.device("cpu"),)
    with use_mesh(Mesh(("cpu", "cpu"))) as mesh:
        assert get_mesh() is mesh and get_mesh().devices == (torch.device("cpu"),) * 2
        assert mesh_for(torch.device("cpu")) is mesh
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_mesh()
    with pytest.raises(ValueError, match="Unsupported mesh device"):
        Mesh(("meta",))
