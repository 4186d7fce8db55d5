"""Configuration schemas of the tools and of the pipeline, as plain
validated dicts.

The port of the JAX package's pydantic schemas (config/schemas.py),
without pydantic: every schema is a nested spec
of fields, each with its default and its check. `validate(config, spec)`
fills the defaults, checks the values (the same `Literal` choices, types
and optional fields) and returns a new dict equal to the pydantic model's
`model_dump()`. As there: the `FilterSettings` `compute_*` gates, the scalar
broadcast of a network's activation / batchnorm / dropout over its layers,
and per-CV override blocks of `train_colvars` (a top-level `pca:` key)
kept as given, to be merged over `common` by `cv_configuration`.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional

from deep_cartograph_torch.utils.common import merge_configurations


class ConfigError(ValueError):
    """A configuration value that the schema rejects."""


Check = Callable[[Any, str], Any]


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def integer(v, where):
    if _is_int(v):
        return v
    if isinstance(v, float) and v.is_integer():
        return int(v)
    raise ConfigError(f"{where}: expected an integer, got {v!r}")


def number(v, where):
    if _is_int(v) or isinstance(v, float):
        return float(v)
    raise ConfigError(f"{where}: expected a number, got {v!r}")


def boolean(v, where):
    if isinstance(v, bool):
        return v
    raise ConfigError(f"{where}: expected a boolean, got {v!r}")


def string(v, where):
    if isinstance(v, str):
        return v
    raise ConfigError(f"{where}: expected a string, got {v!r}")


def mapping(v, where):
    if isinstance(v, dict):
        return copy.deepcopy(v)
    raise ConfigError(f"{where}: expected a mapping, got {v!r}")


def optional(check: Check) -> Check:
    return lambda v, where: None if v is None else check(v, where)


def literal(*choices) -> Check:
    def check(v, where):
        if any(type(v) is type(c) and v == c for c in choices):
            return v
        raise ConfigError(f"{where}: {v!r} is not one of {choices}")
    return check


def list_of(check: Check) -> Check:
    def check_list(v, where):
        if not isinstance(v, (list, tuple)):
            raise ConfigError(f"{where}: expected a list, got {v!r}")
        return [check(x, f"{where}[{i}]") for i, x in enumerate(v)]
    return check_list


def union(*checks: Check) -> Check:
    def check(v, where):
        for c in checks:
            try:
                return c(v, where)
            except ConfigError:
                continue
        raise ConfigError(f"{where}: {v!r} is not accepted")
    return check


class Field:
    def __init__(self, default, check: Check):
        self.default = default
        self.check = check


def nested(spec: Dict) -> Check:
    """A sub-schema as a field check."""
    return lambda v, where: validate(v, spec, where)


def dict_of(spec: Dict) -> Check:
    """A mapping of names to sub-schemas (pydantic's Dict[str, Model])."""
    def check(v, where):
        if not isinstance(v, dict):
            raise ConfigError(f"{where}: expected a mapping, got {v!r}")
        return {string(k, where): validate(x, spec, f"{where}.{k}")
                for k, x in v.items()}
    return check


def validate(config: Optional[Dict], spec: Dict, where: str = "config",
             allow_extra: bool = False) -> Dict:
    """`config` checked against `spec` with the defaults filled in. Unknown
    keys are dropped (pydantic's default) unless `allow_extra`, where they
    are kept as given. A spec may carry a "__before__" hook per field
    (config, validated so far) and an "__after__" hook on the result."""
    config = {} if config is None else config
    if not isinstance(config, dict):
        raise ConfigError(f"{where}: expected a mapping, got {config!r}")
    out: Dict = {}
    for key, field in spec.items():
        if key.startswith("__"):
            continue
        if isinstance(field, dict):
            field = Field(validate({}, field), nested(field))
        if key in config:
            value = config[key]
            before = spec.get("__before__", {}).get(key)
            if before is not None:
                value = before(value, out)
            out[key] = field.check(value, f"{where}.{key}")
        else:
            out[key] = copy.deepcopy(field.default)
    if allow_extra:
        for key, value in config.items():
            if key not in spec:
                out[key] = copy.deepcopy(value)
    after = spec.get("__after__")
    return after(out) if after is not None else out


# ---------------------------------------------------------------------------
# compute_features
# ---------------------------------------------------------------------------

FEATURES = {
    "coordinate_groups": Field({}, dict_of({
        "selection": Field("not name H*", string),
        "stride": Field(1, integer),
    })),
    "distance_groups": Field({}, dict_of({
        "first_selection": Field("not name H*", string),
        "second_selection": Field("not name H*", string),
        "first_stride": Field(1, integer),
        "second_stride": Field(5, integer),
        "skip_neigh_residues": Field(False, boolean),
        "skip_bonded_atoms": Field(True, boolean),
    })),
    "dihedral_groups": Field({}, dict_of({
        "selection": Field("not name H*", string),
        "periodic_encoding": Field(True, boolean),
        "search_mode": Field("real", literal("virtual", "protein_backbone", "real")),
    })),
    "distance_to_center_groups": Field({}, dict_of({
        "selection": Field("not name H*", string),
        "center_selection": Field("not name H*", string),
    })),
}

COMPUTE_FEATURES = {
    "plumed_settings": {
        "timeout": Field(172800, integer),
        "traj_stride": Field(1, integer),
        "features": FEATURES,
    },
    "plumed_environment": {
        "bin_path": Field("plumed", string),
        "kernel_path": Field(None, optional(string)),
        "env_commands": Field([], list_of(string)),
    },
    # The featurization engine: frames per device batch, the compute type,
    # frame sharding over several devices, and where to run ("auto" and
    # "default": the tool's device; "cpu": the host).
    "engine": {
        "frame_chunk": Field(2048, integer),
        "dtype": Field("float32", literal("float32", "bfloat16")),
        "shard_frames": Field(True, boolean),
        "device": Field("auto", literal("auto", "default", "cpu")),
    },
}


# ---------------------------------------------------------------------------
# filter_features
# ---------------------------------------------------------------------------

def _apply_compute_gates(s: Dict) -> Dict:
    """compute_* False disables that screen; True enables it with its
    default threshold unless one is given."""
    for gate, key, default in (("compute_diptest", "diptest_significance_level", 0.05),
                               ("compute_entropy", "entropy_quantile", 0.0),
                               ("compute_std", "std_quantile", 0.0)):
        if s[gate] is False:
            s[key] = None
        elif s[gate] and s[key] is None:
            s[key] = default
    return s


FILTER_SETTINGS = {
    "local_distance_threshold": Field(None, optional(number)),
    "diptest_significance_level": Field(0.05, optional(number)),
    "entropy_quantile": Field(None, optional(number)),
    "std_quantile": Field(None, optional(number)),
    "compute_diptest": Field(None, optional(boolean)),
    "compute_entropy": Field(None, optional(boolean)),
    "compute_std": Field(None, optional(boolean)),
    "__after__": _apply_compute_gates,
}

SAMPLING_SETTINGS = {
    "num_samples": Field(None, optional(integer)),
    "total_num_samples": Field(None, optional(integer)),
    "relaxation_time": Field(1, integer),
}

FILTER_FEATURES = {
    "filter_settings": FILTER_SETTINGS,
    "sampling_settings": SAMPLING_SETTINGS,
}


# ---------------------------------------------------------------------------
# train_colvars
# ---------------------------------------------------------------------------

ACTIVATION = literal("relu", "elu", "tanh", "softplus", "shifted_softplus",
                     "custom_sigmoid", "leaky_relu", "linear")


def _broadcast_scalar(value, validated: Dict):
    """A scalar stands for every hidden layer."""
    if isinstance(value, list):
        return value
    layers = validated.get("layers")
    return [value] * (len(layers) if layers else 3)


NEURAL_NETWORK = {
    "layers": Field([64, 32, 16], list_of(integer)),
    "activation": Field(["leaky_relu", "leaky_relu", "leaky_relu"],
                        list_of(optional(ACTIVATION))),
    "batchnorm": Field([False, False, False], list_of(boolean)),
    "dropout": Field([None, None, None], list_of(optional(number))),
    "last_layer_activation": Field(None, optional(ACTIVATION)),
    "last_layer_batchnorm": Field(False, boolean),
    "last_layer_dropout": Field(None, optional(number)),
    "__before__": {k: _broadcast_scalar for k in ("activation", "batchnorm", "dropout")},
}

GENERAL_SETTINGS = {
    "num_tries": Field(10, integer),
    "seed": Field(42, integer),
    "lengths": Field([0.8, 0.2], list_of(number)),
    "batch_size": Field(32, integer),
    "max_epochs": Field(1000, integer),
    "shuffle": Field(False, boolean),
    "random_split": Field(True, boolean),
    "check_val_every_n_epoch": Field(10, integer),
    "save_check_every_n_epoch": Field(10, integer),
}

KL_ANNEALING = {
    "type": Field("linear", literal("linear", "sigmoid", "cyclical")),
    "start_beta": Field(1e-06, number),
    "max_beta": Field(0.01, number),
    "start_epoch": Field(1000, integer),
    "n_cycles": Field(4, integer),
    "n_epochs_anneal": Field(5000, integer),
}

TRAININGS = {
    "general": GENERAL_SETTINGS,
    "early_stopping": {
        "patience": Field(20, integer),
        "min_delta": Field(1.0e-05, number),
    },
    "optimizer": {
        "name": Field("Adam", string),
        "kwargs": Field({"lr": 1.0e-04, "weight_decay": 0.0}, mapping),
    },
    "lr_scheduler": Field(None, optional(nested({
        "name": Field("OneCycleLR", string),
        "kwargs": Field({}, mapping),
    }))),
    "lr_scheduler_config": Field(
        {"interval": "epoch", "monitor": "valid_loss", "frequency": 1},
        optional(mapping)),
    "kl_annealing": Field(None, optional(nested(KL_ANNEALING))),
    "save_loss": Field(True, boolean),
    "plot_loss": Field(True, boolean),
    "model_to_save": Field("best", literal("best", "last")),
}

BIAS = {
    "method": Field("opes_metad", literal("wt_metadynamics", "opes_metad",
                                          "opes_metad_explore", "opes_expanded")),
    "args": {
        "temperature": Field(300.0, number),
        "sigma": Field(0.05, number),
        "pace": Field(500, integer),
        "grid_min": Field(-1.0, number),
        "grid_max": Field(1.0, number),
        "grid_bin": Field(300, integer),
        "height": Field(1.0, number),
        "bias_factor": Field(10.0, number),
        "barrier": Field(50.0, number),
        "observation_steps": Field(100, integer),
        "compression_threshold": Field(0.1, number),
    },
    "add_rmsd_restraint": Field(False, boolean),
    "align_waypoint_structures": Field(True, boolean),
    "rmsd_restraint_k": Field(5000.0, number),
    "rmsd_restraint_eq": Field(0.4, number),
}

COMMON_CV = {
    "dimension": Field(2, integer),
    "lag_time": Field(1, integer),
    "tica_regularization": Field(1.0e-06, number),
    "features_normalization": Field(
        None, optional(literal("mean_std", "min_max_range1", "min_max_range2"))),
    "input_colvars": {
        "start": Field(0, integer),
        "stop": Field(None, optional(integer)),
        "stride": Field(1, integer),
    },
    "architecture": {"encoder": NEURAL_NETWORK, "decoder": NEURAL_NETWORK},
    "training": TRAININGS,
    "num_subspaces": Field(10, integer),
    "subspaces_dimension": Field(5, integer),
    "n_neighbors": Field(15, integer),
    "min_dist": Field(0.1, number),
    "metric": Field("euclidean", string),
    "bias": BIAS,
    # "auto" streams linear CVs past DEEP_CARTO_STREAM_BYTES; true/"on"
    # forces streaming, false/"off" disables it.
    "streaming": Field("auto", union(boolean, literal("auto", "on", "off"))),
}

FES_FIGURE = {
    "compute": Field(True, boolean),
    "save": Field(True, boolean),
    "temperature": Field(300, integer),
    "bandwidth": Field(0.05, number),
    "num_fes_levels": Field(10, integer),
    "num_bins": Field(150, integer),
    "max_fes": Field(30, number),
}

TRAJ_PROJECTION = {
    "plot": Field(True, boolean),
    "num_bins": Field(100, integer),
    "bandwidth": Field(0.25, number),
    "alpha": Field(0.8, number),
    "cmap": Field("turbo", string),
    "marker_size": Field(5, integer),
}

CV_NAMES = ("pca", "ae", "tica", "htica", "deep_tica", "vae", "umap")

TRAIN_COLVARS = {
    "cvs": Field(list(CV_NAMES), list_of(literal(*CV_NAMES))),
    "common": COMMON_CV,
    "figures": {"fes": FES_FIGURE, "traj_projection": TRAJ_PROJECTION},
}


# ---------------------------------------------------------------------------
# traj_projection, traj_cluster, traj_augmentation, analyze_geometry
# ---------------------------------------------------------------------------

TRAJ_PROJECTION_TOOL = {
    "figures": {"fes": FES_FIGURE, "traj_projection": TRAJ_PROJECTION, "bias": BIAS},
}

TRAJ_CLUSTER = {
    "run": Field(True, boolean),
    "output_structures": Field("centroids", optional(literal("centroids", "all"))),
    "algorithm": Field("hierarchical", literal("kmeans", "hdbscan", "hierarchical")),
    "opt_num_clusters": Field(True, boolean),
    "search_interval": Field([3, 10], list_of(integer)),
    "num_clusters": Field(10, integer),
    "linkage": Field("complete", string),
    "n_init": Field(20, integer),
    "min_cluster_size": Field(5, integer),
    "max_cluster_size": Field(None, optional(integer)),
    "min_samples": Field(3, integer),
    "cluster_selection_epsilon": Field(0, number),
    "cluster_selection_method": Field("eom", literal("eom", "leaf")),
    "figures": {
        "plot": Field(True, boolean),
        "num_bins": Field(100, integer),
        "bandwidth": Field(0.25, number),
        "alpha": Field(0.8, number),
        "cmap": Field("turbo", string),
        "marker_size": Field(5, integer),
    },
}

TRAJ_AUGMENTATION = {
    "num_frames": Field(1000, integer),
    "keep_original_frames": Field(False, boolean),
    "interpolation_method": Field("pchip", optional(literal("akima", "pchip"))),
    "noise_std": Field(None, optional(number)),
    "random_seed": Field(42, integer),
    "atom_selection": Field("all", string),
    "traj_format": Field("xtc", literal("xtc", "dcd", "nc", "pdb")),
    "prepare_trajectory": Field(False, boolean),
}


def _rms_settings(title: str) -> Dict:
    return {
        "title": Field(title, string),
        "selection": Field("protein and name CA", string),
        "fit_selection": Field("protein and name CA", string),
    }


ANALYZE_GEOMETRY = {
    "analysis": {
        "RMSD": Field({}, dict_of(_rms_settings("Protein Backbone RMSD"))),
        "RMSF": Field({}, dict_of(_rms_settings("Protein Backbone RMSF"))),
        "dRMSD": Field({}, dict_of({
            "title": Field("Protein Backbone dRMSD", string),
            "selection": Field("protein and name CA", string),
            "selection_stride": Field(5, integer),
        })),
    },
    "dt_per_frame": Field(1.0, number),
    "run": Field(True, boolean),
}


def compute_features_config(config: Optional[Dict] = None) -> Dict:
    """The validated `compute_features` configuration."""
    return validate(config, COMPUTE_FEATURES, "compute_features")


def traj_projection_config(config: Optional[Dict] = None) -> Dict:
    """The validated `traj_projection` configuration."""
    return validate(config, TRAJ_PROJECTION_TOOL, "traj_projection")


def traj_cluster_config(config: Optional[Dict] = None) -> Dict:
    """The validated `traj_cluster` configuration."""
    return validate(config, TRAJ_CLUSTER, "traj_cluster")


def traj_augmentation_config(config: Optional[Dict] = None) -> Dict:
    """The validated `traj_augmentation` configuration."""
    return validate(config, TRAJ_AUGMENTATION, "traj_augmentation")


def analyze_geometry_config(config: Optional[Dict] = None) -> Dict:
    """The validated `analyze_geometry` configuration."""
    return validate(config, ANALYZE_GEOMETRY, "analyze_geometry")


def deep_cartograph_config(config: Optional[Dict] = None) -> Dict:
    """The validated pipeline configuration: one block per tool."""
    config = {} if config is None else config
    if not isinstance(config, dict):
        raise ConfigError(f"deep_cartograph: expected a mapping, got {config!r}")
    return {
        "analyze_geometry": analyze_geometry_config(config.get("analyze_geometry")),
        "traj_augmentation": traj_augmentation_config(config.get("traj_augmentation")),
        "compute_features": compute_features_config(config.get("compute_features")),
        "filter_features": filter_features_config(config.get("filter_features")),
        "train_colvars": train_colvars_config(config.get("train_colvars")),
        "traj_projection": traj_projection_config(config.get("traj_projection")),
        "traj_cluster": traj_cluster_config(config.get("traj_cluster")),
    }


def filter_features_config(config: Optional[Dict] = None) -> Dict:
    """The validated `filter_features` configuration."""
    return validate(config, FILTER_FEATURES, "filter_features")


def train_colvars_config(config: Optional[Dict] = None) -> Dict:
    """The validated `train_colvars` configuration; per-CV override blocks
    are kept as given."""
    return validate(config, TRAIN_COLVARS, "train_colvars", allow_extra=True)


def cv_configuration(train_config: Dict, cv_name: str) -> Dict:
    """One CV's configuration: its override block merged over `common`."""
    return merge_configurations(train_config["common"], train_config.get(cv_name, {}))
