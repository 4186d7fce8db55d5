"""Configuration schemas of `filter_features` and `train_colvars`, as plain
validated dicts.

The port of the JAX package's pydantic schemas (config/schemas.py) for the
two tools of this slice, without pydantic: every schema is a nested spec
of fields, each with its default and its check. `validate(config, spec)`
fills the defaults, checks the values (the same `Literal` choices, types
and optional fields) and returns a new dict equal to the pydantic model's
`model_dump()`. As there: the `FilterSettings` `compute_*` gates, the scalar
broadcast of a network's activation / batchnorm / dropout over its layers,
and per-CV override blocks of `train_colvars` (a top-level `pca:` key)
kept as given, to be merged over `common` by `cv_configuration`. The other
tools' schemas come with ROADMAP Queue 1 item 6.
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
