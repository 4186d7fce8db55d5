"""Host-side file helpers: zips, lists, file discovery, configuration merge.

The part of the JAX package's utils/common.py that the CV calculators, the
filter and the colvars reader use, copied so the port imports nothing of
the JAX package. No YAML: configurations reach the port as dicts
(`config/schemas.py` validates them).
"""

from __future__ import annotations

import logging
import os
import sys
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Union

logger = logging.getLogger(__name__)


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
