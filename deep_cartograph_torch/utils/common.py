"""Host-side file helpers: zips, lists, file discovery, configurations,
CSV output.

The port of the JAX package's utils/common.py, copied so the port imports
nothing of the JAX package, and without the libraries the card machine may
lack:

- `read_configuration` reads a JSON file (JSON is YAML too, so the JAX
  package reads the same file) and imports PyYAML, inside that function
  only, for a file that is not JSON.
- `validate_configuration` writes the provenance `configuration.yml` with
  its own emitter (`dump_yaml`), which `yaml.safe_load` reads back to the
  same dict.
- `write_csv` writes what pandas' `DataFrame.to_csv(index=False)` writes,
  byte for byte, from numpy columns.
"""

from __future__ import annotations

import csv
import importlib.util
import json
import logging
import math
import os
import re
import shutil
import sys
import zipfile
from pathlib import Path, PurePath
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

logger = logging.getLogger(__name__)


def package_is_installed(*package_names: str) -> bool:
    """True if every named package can be imported (nothing is imported)."""
    for package in package_names:
        if importlib.util.find_spec(package) is None:
            logger.debug("Package %s is not installed", package)
            return False
    return True


def files_exist(*file_paths: str, verbose: bool = True) -> bool:
    """True if all paths are existing files."""
    all_exist = True
    for path in file_paths:
        this_exists = os.path.isfile(path)
        all_exist = all_exist and this_exists
        if not this_exists and verbose:
            logger.error("File not found %s", path)
    return all_exist


def zip_files(output_zip_path: str, *paths_to_compress: str) -> None:
    """Zip files and/or directories, keeping a directory's own name as the
    top folder of its entries."""
    if not paths_to_compress:
        logger.warning("No input paths were provided to compress.")
        return
    with zipfile.ZipFile(output_zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for path in paths_to_compress:
            if not os.path.exists(path):
                logger.warning("Skipped: path '%s' does not exist.", path)
                continue
            if os.path.isfile(path):
                zf.write(path, arcname=os.path.basename(path))
            elif os.path.isdir(path):
                for root, _, files in os.walk(path):
                    for f in files:
                        full = os.path.join(root, f)
                        arc = os.path.relpath(full, os.path.dirname(path))
                        zf.write(full, arcname=arc)


def unzip_files(zip_path: str, output_folder: str) -> None:
    """Extract a zip archive into `output_folder`."""
    if not os.path.isfile(zip_path):
        logger.error("ZIP file '%s' does not exist.", zip_path)
        return
    os.makedirs(output_folder, exist_ok=True)
    with zipfile.ZipFile(zip_path, "r") as zf:
        zf.extractall(output_folder)


def remove_files(*file_paths: str) -> None:
    """Delete the files that exist."""
    for p in file_paths:
        if os.path.isfile(p):
            os.remove(p)


def remove_dirs(*dir_paths: str) -> None:
    for p in dir_paths:
        if os.path.isdir(p):
            shutil.rmtree(p)


# ---------------------------------------------------------------------------
# Configuration handling
# ---------------------------------------------------------------------------

def read_configuration(configuration_path: str) -> Dict[str, Any]:
    """A configuration file as a dict. The file is read as JSON first; a
    file that is not JSON is read as YAML, which needs PyYAML."""
    if not files_exist(configuration_path):
        logger.error("Configuration file %s not found", configuration_path)
        sys.exit(1)
    with open(configuration_path) as fh:
        text = fh.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    try:
        import yaml
    except ImportError as exc:
        raise ImportError(
            f"{configuration_path} is not JSON, and reading it as YAML needs "
            "PyYAML, which is not installed. Install PyYAML or write the "
            "configuration as JSON (JSON is valid YAML)."
        ) from exc
    return yaml.safe_load(text)


# A string that YAML reads back as the same string when written unquoted.
_PLAIN_YAML = re.compile(r"^[A-Za-z_/][A-Za-z0-9_ ./()*+-]*$")
_YAML_WORDS = {"yes", "no", "true", "false", "on", "off", "null", "~"}


def _yaml_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        value = float(value)
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        # YAML 1.1 reads a float only with a dot and a signed exponent
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        if (_PLAIN_YAML.match(value) and not value.endswith(" ")
                and value.lower() not in _YAML_WORDS):
            return value
        if value.isprintable():
            return "'" + value.replace("'", "''") + "'"
        return json.dumps(value)
    raise TypeError(f"Cannot write {type(value).__name__} {value!r} as YAML")


def _yaml_lines(value: Any, indent: int) -> List[str]:
    pad = " " * indent
    lines: List[str] = []
    if isinstance(value, Mapping):
        for key in sorted(value):
            item = value[key]
            head = f"{pad}{_yaml_scalar(key)}:"
            if isinstance(item, Mapping) and item:
                lines.append(head)
                lines.extend(_yaml_lines(item, indent + 2))
            elif isinstance(item, (list, tuple)) and item:
                lines.append(head)
                lines.extend(_yaml_lines(item, indent))
            else:
                lines.append(f"{head} {_yaml_inline(item)}")
    else:
        for item in value:
            if isinstance(item, (Mapping, list, tuple)) and item:
                nested = _yaml_lines(item, indent + 2)
                lines.append(f"{pad}- {nested[0].lstrip()}")
                lines.extend(nested[1:])
            else:
                lines.append(f"{pad}- {_yaml_inline(item)}")
    return lines


def _yaml_inline(value: Any) -> str:
    if isinstance(value, Mapping):
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[]"
    return _yaml_scalar(value)


def dump_yaml(data: Dict[str, Any]) -> str:
    """Block-style YAML of a validated configuration (dicts, lists, str,
    int, float, bool, None), keys sorted as `yaml.dump` sorts them;
    `yaml.safe_load` reads it back to the same dict."""
    return "\n".join(_yaml_lines(data, 0)) + "\n"


def validate_configuration(
    configuration: Dict[str, Any],
    schema: Callable[[Optional[Dict]], Dict],
    output_folder: Optional[str],
) -> Dict[str, Any]:
    """Validate a configuration with a schema function of
    `config/schemas.py` and write the provenance record to
    `output_folder/configuration.yml`."""
    from deep_cartograph_torch.config.schemas import ConfigError

    try:
        validated = schema(configuration)
    except ConfigError as exc:
        logger.error("Configuration is not valid: %s", exc)
        sys.exit(1)
    if output_folder is not None:
        os.makedirs(output_folder, exist_ok=True)
        with open(os.path.join(output_folder, "configuration.yml"), "w") as fh:
            fh.write(dump_yaml(validated))
    return validated


def merge_configurations(common_config: Dict, specific_config: Optional[Dict]) -> Dict:
    """Recursive merge; the specific values override the common ones."""
    merged = dict(common_config)
    if specific_config:
        for key, value in specific_config.items():
            if key in merged and isinstance(merged[key], dict) and isinstance(value, dict):
                merged[key] = merge_configurations(merged[key], value)
            else:
                merged[key] = value
    return merged


def read_features_list(features_path: Optional[str]) -> Optional[List[str]]:
    """A newline-separated feature list."""
    if features_path is None:
        return None
    with open(features_path) as fh:
        return [line.strip() for line in fh if line.strip()]


def save_list(items: List[str], path: str) -> None:
    """Write one item per line."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        for item in items:
            fh.write(f"{item}\n")


def read_list(path: str) -> List[str]:
    with open(path) as fh:
        return fh.readlines()


def find_files(paths: Union[List[str], str]) -> List[str]:
    """Expand file and folder paths to files: a folder's files sorted, the
    caller's argument order kept, hidden files dropped."""
    if isinstance(paths, str):
        paths = [paths]
    file_paths: List[str] = []
    for path in paths:
        if not os.path.exists(path):
            logger.error("Path not found: %s", path)
            sys.exit(1)
        if os.path.isdir(path):
            file_paths.extend(
                sorted(
                    os.path.join(path, f)
                    for f in os.listdir(path)
                    if os.path.isfile(os.path.join(path, f))
                )
            )
        elif os.path.isfile(path):
            file_paths.append(path)
        else:
            logger.error("Path should be a file or a folder: %s", paths)
            sys.exit(1)
    return [f for f in file_paths if not Path(f).name.startswith(".")]


def check_data(
    trajectory_data: Optional[Union[List[str], str]],
    topology_data: Optional[Union[List[str], str]],
) -> Tuple[List[str], List[str]]:
    """Pair trajectories with topologies: one topology serves every
    trajectory; several must match the trajectories by file stem."""
    traj_files = find_files(trajectory_data) if trajectory_data is not None else []
    top_files = find_files(topology_data) if topology_data is not None else []

    if len(top_files) > 1:
        for traj_f, top_f in zip(traj_files, top_files):
            if Path(traj_f).stem != Path(top_f).stem:
                logger.error(
                    "Trajectory file has no corresponding topology with the same name: %s",
                    Path(traj_f).stem,
                )
                sys.exit(1)
    if len(top_files) == 1 and len(traj_files) > 1:
        top_files = top_files * len(traj_files)
    if len(traj_files) != len(top_files):
        logger.error(
            "Number of topology files differs from trajectory files (%d vs %d).",
            len(top_files),
            len(traj_files),
        )
        sys.exit(1)
    return traj_files, top_files


def get_unique_path(path: str) -> str:
    """Append a numeric suffix until the path does not exist. An existing
    directory that holds nothing but the log file is returned as it is:
    the CLI makes the output folder for its log before the pipeline runs."""
    pure = PurePath(path)
    if not os.path.exists(path):
        return path
    if os.path.isdir(path):
        try:
            entries = [e for e in os.listdir(path) if e != "deep_cartograph.log"]
        except OSError:
            entries = ["?"]
        if not entries:
            return path
    parent = pure.parent
    if os.path.isfile(path):
        stem, suffix = pure.stem, pure.suffix
        i = 1
        while os.path.exists(path):
            path = os.path.join(parent, f"{stem}_{i}{suffix}")
            i += 1
        return path
    name = pure.name
    i = 1
    while os.path.exists(path):
        path = os.path.join(parent, f"{name}_{i}")
        i += 1
    return path


def closest_power_of_two(n: int) -> int:
    """Largest power of two strictly below n."""
    p = 2 ** math.floor(math.log2(n))
    if p == n:
        p //= 2
    return p


def save_data(
    y_data: Dict[str, np.ndarray],
    x_data: Dict[str, np.ndarray],
    y_label: str,
    x_label: str,
    folder_path: str,
) -> None:
    """One CSV of paired x, y columns per key."""
    os.makedirs(folder_path, exist_ok=True)
    for key, y in y_data.items():
        x = x_data.get(key)
        if x is None:
            raise ValueError(f"No x values provided for {key}")
        np.savetxt(
            os.path.join(folder_path, f"{key}.csv"),
            np.column_stack((np.asarray(x), np.asarray(y))),
            delimiter=",",
            header=f"{x_label},{y_label}",
            comments="",
        )


# ---------------------------------------------------------------------------
# CSV output (pandas' `to_csv` layout)
# ---------------------------------------------------------------------------

Columns = Mapping[str, Union[np.ndarray, Sequence]]


def _format_column(values, float_format: Optional[str]) -> List[str]:
    """A column's cells as pandas writes them: floats in the shortest form
    that reads back to the column's dtype (or `float_format`), NaN empty,
    bools as True/False."""
    arr = np.asarray(values)
    if arr.dtype.kind == "f":
        if float_format is not None:
            return ["" if v != v else float_format % v for v in arr.tolist()]
        scalar = arr.dtype.type
        return ["" if v != v else str(scalar(v)) for v in arr.tolist()]
    if arr.dtype.kind == "b":
        return ["True" if v else "False" for v in arr.tolist()]
    return [str(v) for v in arr.tolist()]


def write_csv(
    path: str,
    columns: Columns,
    float_format: Optional[str] = None,
    sep: str = ",",
    header: bool = True,
    mode: str = "w",
) -> None:
    """Write named columns (a dict in column order) as
    `DataFrame.to_csv(path, index=False, ...)` writes them."""
    names = list(columns)
    cells = [_format_column(columns[n], float_format) for n in names]
    n_rows = len(cells[0]) if cells else 0
    if any(len(c) != n_rows for c in cells):
        raise ValueError("CSV columns differ in length")
    with open(path, mode, newline="") as fh:
        writer = csv.writer(fh, delimiter=sep, lineterminator="\n",
                            quoting=csv.QUOTE_MINIMAL)
        if header:
            writer.writerow(names)
        writer.writerows(zip(*cells))


def read_csv(path: str) -> Tuple[List[str], np.ndarray]:
    """A numeric CSV with a header row: (column names, float64 matrix), as
    pandas' `read_csv` types such a file."""
    with open(path, newline="") as fh:
        names = next(csv.reader(fh))
    data = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64, ndmin=2)
    if data.size == 0:
        data = data.reshape(0, len(names))
    return names, data


def write_as_csv(columns: Columns, path: str) -> None:
    """Append columns (with a `time` column in ns) to a PLUMED-format file,
    time in ps, continuing the time axis of an existing file past its
    last row and dropping the repeated first sample."""
    columns = {k: np.asarray(v) for k, v in columns.items()}
    columns["time"] = columns["time"] * 1000
    if not os.path.isfile(path):
        with open(path, "w") as fh:
            fh.write("#! FIELDS " + " ".join(columns) + "\n")
    else:
        with open(path) as fh:
            last_line = fh.readlines()[-1]
        last_time = float(last_line.split()[0])
        columns = {k: v[1:] for k, v in columns.items()}
        columns["time"] = columns["time"] + last_time
    write_csv(path, columns, float_format="%.6f", sep=" ", header=False, mode="a")
