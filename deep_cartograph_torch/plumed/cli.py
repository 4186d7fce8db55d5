"""Optional PLUMED driver invocation (validation only).

The port computes features itself on the card; this module runs a real
`plumed driver` where one is installed, so that exported PLUMED inputs can
be checked against it (the reference's compute path,
deep_cartograph/modules/plumed/cli.py:19-163, serves here as a check).

`run_plumed` runs the command in `working_dir` with PLUMED_KERNEL set in
the child's environment only: the calling process keeps its working
directory and its environment.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)

# Trajectory-format flags of the molfile readers of `plumed driver`
# (cf. reference modules/plumed/utils.py:16-60).
TRAJ_FLAGS = {
    ".dcd": "--mf_dcd",
    ".xtc": "--mf_xtc",
    ".trr": "--mf_trr",
    ".pdb": "--mf_pdb",
    ".gro": "--mf_gro",
    ".xyz": "--ixyz",
    ".crd": "--mf_crd",
}


def get_traj_flag(traj_path: str) -> str:
    suffix = Path(traj_path).suffix.lower()
    if suffix not in TRAJ_FLAGS:
        raise ValueError(f"Unsupported trajectory format for PLUMED driver: {suffix}")
    return TRAJ_FLAGS[suffix]


def sanitize_cryst1_record(traj_path: str, output_path: Optional[str]) -> str:
    """Strip dummy CRYST1 records (a cell edge of at most 1 Angstrom) that
    break the PDB reader of `plumed driver` (cf. reference
    modules/plumed/utils.py:62-114). Returns the path to read: the sanitized
    copy, or `traj_path` unchanged."""
    with open(traj_path) as fh:
        lines = fh.readlines()

    def dummy(line: str) -> bool:
        return line.startswith("CRYST1") and float(line[6:15]) <= 1.0

    if not any(dummy(line) for line in lines):
        return traj_path
    out_dir = output_path or str(Path(traj_path).parent)
    fixed = os.path.join(out_dir, Path(traj_path).stem + "_sanitized.pdb")
    with open(fixed, "w") as fh:
        fh.writelines(line for line in lines if not dummy(line))
    return fixed


def plumed_available(plumed_settings: Optional[Dict] = None) -> bool:
    binary = (plumed_settings or {}).get("bin_path", "plumed")
    return shutil.which(binary) is not None


def get_driver_command(
    plumed_input: str,
    traj_path: Optional[str] = None,
    num_atoms: Optional[int] = None,
    output_path: Optional[str] = None,
) -> str:
    """Build a `plumed driver` shell command (cf. reference cli.py:19-83)."""
    parts = ["driver", "--plumed", os.path.abspath(plumed_input)]
    if traj_path:
        parts.append(get_traj_flag(traj_path))
        if Path(traj_path).suffix == ".pdb":
            traj_path = sanitize_cryst1_record(traj_path, output_path)
        parts.append(os.path.abspath(traj_path))
    else:
        parts.append("--noatoms")
    if num_atoms:
        parts.extend(["--natoms", str(num_atoms)])
    return " ".join(parts)


def run_plumed(
    plumed_command: str,
    working_dir: Optional[str] = None,
    plumed_settings: Optional[Dict] = None,
    plumed_timeout: int = 604800,
) -> Tuple[Optional[str], Optional[str]]:
    """Run PLUMED through the shell with its environment commands and a
    timeout (cf. reference cli.py:85-163). Returns (stdout, stderr), or
    (None, "TimeoutExpired") on a timeout; raises RuntimeError when the
    command fails."""
    plumed_settings = plumed_settings or {}
    binary = plumed_settings.get("bin_path", "plumed")
    commands = []
    if plumed_settings.get("env_commands"):
        commands.append(" && ".join(plumed_settings["env_commands"]))
    env = None
    if plumed_settings.get("kernel_path"):
        env = dict(os.environ, PLUMED_KERNEL=plumed_settings["kernel_path"])
    commands.append(f"{binary} {plumed_command}")
    command_str = " && ".join(commands)
    logger.info("Executing PLUMED command: %s", command_str)
    try:
        completed = subprocess.run(
            command_str,
            shell=True,
            cwd=working_dir or None,
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            timeout=plumed_timeout,
            text=True,
        )
    except subprocess.TimeoutExpired:
        logger.error("PLUMED execution timed out!")
        return None, "TimeoutExpired"
    if completed.returncode != 0:
        logger.error("PLUMED execution failed!\n%s", completed.stderr)
        raise RuntimeError(f"PLUMED execution failed: {completed.stderr[-500:]}")
    return completed.stdout, completed.stderr
