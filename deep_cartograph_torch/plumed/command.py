"""PLUMED action text generation.

One function per PLUMED action, emitting the exact textual form the reference
produces (deep_cartograph/modules/plumed/command.py:19-1179) so exported
inputs remain drop-in compatible with PLUMED-driven MD engines. Pure string
assembly — no PLUMED dependency. A copy of the JAX package's module, text
for text (the port imports nothing of that package).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

DEFAULT_FMT = "%14.10f"


def _atoms_str(atoms: Union[Sequence, str]) -> str:
    if isinstance(atoms, str):
        return atoms
    return ",".join(str(a) for a in atoms)


def molinfo(topology: str, moltype: Optional[str] = None) -> str:
    cmd = f"MOLINFO STRUCTURE={topology}"
    if moltype is not None:
        cmd += f" MOLTYPE={moltype}"
    return cmd + "\n"


def wholemolecules(indices: List[int]) -> str:
    return f"WHOLEMOLECULES ENTITY0={indices[0]}-{indices[-1]} \n"


def fit_to_template(template_path: str) -> str:
    return f"FIT_TO_TEMPLATE STRIDE=1 REFERENCE={template_path} TYPE=OPTIMAL\n"


def position(command_label: str, atom: str) -> str:
    return f"{command_label}: POSITION ATOM={atom} NOPBC\n"


def distance(command_label: str, atoms: Union[Sequence, str]) -> str:
    return f"{command_label}: DISTANCE ATOMS={_atoms_str(atoms)} NOPBC\n"


def custom(
    command_label: str,
    expression: str,
    arguments: List[str],
    periodic: bool = False,
) -> str:
    cmd = f"{command_label}: CUSTOM ARG={','.join(arguments)} FUNC={expression}"
    cmd += " PERIODIC=YES" if periodic else " PERIODIC=NO"
    return cmd + "\n"


def torsion(command_label: str, atoms: Union[Sequence, str]) -> str:
    return f"{command_label}: TORSION ATOMS={_atoms_str(atoms)}\n"


def alphabeta(command_label: str, atoms: Union[Sequence, str], reference: float) -> str:
    return (
        f"{command_label}: ALPHABETA ATOMS1={_atoms_str(atoms)}"
        f" REFERENCE={reference}\n"
    )


def sin_old(command_label: str, atoms: Union[Sequence, str]) -> str:
    """Legacy ALPHABETA-proxy sine encoding 0.5*(1+cos(phi-pi/2))
    (cf. reference command.py:229-251)."""
    import math

    return alphabeta(command_label, atoms, reference=-round(math.pi / 2, 4))


def cos_old(command_label: str, atoms: Union[Sequence, str]) -> str:
    """Legacy ALPHABETA-proxy cosine encoding 0.5*(1+cos(phi))
    (cf. reference command.py:253-275)."""
    return alphabeta(command_label, atoms, reference=0)


def read(command_label: str, file_path: str, values: str, ignore_time: bool) -> str:
    cmd = f"{command_label}: READ FILE={file_path} VALUES={values}"
    if ignore_time:
        cmd += " IGNORE_TIME"
    return cmd + "\n"


def combine(
    command_label: str,
    arguments: List[str],
    coefficients=None,
    parameters=None,
    powers=None,
    periodic: bool = False,
) -> str:
    cmd = f"{command_label}: COMBINE ARG={','.join(arguments)}"
    if coefficients is not None:
        cmd += " COEFFICIENTS=" + ",".join(f"{c:.17g}" for c in coefficients)
    if parameters is not None:
        cmd += " PARAMETERS=" + ",".join(f"{p:.17g}" for p in parameters)
    if powers is not None:
        cmd += " POWERS=" + ",".join(f"{p:.10g}" for p in powers)
    cmd += " PERIODIC=YES" if periodic else " PERIODIC=NO"
    return cmd + "\n"


def rmsd(command_label: str, reference: str, type: str = "OPTIMAL") -> str:
    return f"{command_label}: RMSD REFERENCE={reference} TYPE={type} \n"


def upper_walls(
    command_label: str,
    arguments: List[str],
    at_eqs: Optional[List[float]] = None,
    kappas: Optional[List[float]] = None,
    exponents: Optional[List[int]] = None,
    epsilons: Optional[List[float]] = None,
    offsets: Optional[List[float]] = None,
) -> str:
    cmd = f"{command_label}: UPPER_WALLS ARG={','.join(arguments)}"
    for kw, vals in (
        ("AT", at_eqs),
        ("KAPPA", kappas),
        ("EXP", exponents),
        ("EPS", epsilons),
        ("OFFSET", offsets),
    ):
        if vals is not None:
            cmd += f" {kw}=" + ",".join(f"{v:.10g}" for v in vals)
    return cmd + "\n"


def print_(arguments: List[str], file_path: str, stride: int = 1, fmt: str = "%.4f") -> str:
    return (
        f"PRINT ARG={','.join(arguments)} FILE={file_path} STRIDE={stride} FMT={fmt}\n"
    )


# keep the reference's name (it shadows the builtin there too)
print = print_  # noqa: A001


def histogram(
    command_label: str,
    arguments: List[str],
    grid_mins: List[float],
    grid_maxs: List[float],
    stride: int,
    kernel: str,
    normalization: str,
    grid_bins: List[int] = (500,),
    bandwidths: List[float] = (0.01,),
    weights_label: Optional[str] = None,
    clear_freq: Optional[int] = None,
) -> str:
    cmd = f"{command_label}: HISTOGRAM ARG={','.join(arguments)} STRIDE={stride}"
    if weights_label is not None:
        cmd += f" LOGWEIGHTS={weights_label}"
    cmd += " GRID_MIN=" + ",".join(f"{g:.10g}" for g in grid_mins)
    cmd += " GRID_MAX=" + ",".join(f"{g:.10g}" for g in grid_maxs)
    cmd += " GRID_BIN=" + ",".join(f"{g:.10g}" for g in grid_bins)
    cmd += f" KERNEL={kernel}"
    if kernel == "GAUSSIAN":
        cmd += " BANDWIDTH=" + ",".join(f"{b:.10g}" for b in bandwidths)
    cmd += f" NORMALIZATION={normalization}"
    if clear_freq is not None:
        cmd += f" CLEAR={clear_freq}"
    return cmd + "\n"


def dumpgrid(arguments: List[str], file_path: str, stride: Optional[int] = None) -> str:
    cmd = f"DUMPGRID GRID={','.join(arguments)} FILE={file_path} FMT={DEFAULT_FMT}"
    if stride is not None:
        cmd += f" STRIDE={stride}"
    return cmd + "\n"


def convert_to_fes(
    command_label: str, arguments: List[str], temp: float, mintozero: bool = True
) -> str:
    cmd = f"{command_label}: CONVERT_TO_FES GRID={','.join(arguments)} TEMP={temp}"
    if mintozero:
        cmd += " MINTOZERO"
    return cmd + "\n"


def reweight_bias(command_label: str, arguments: List[str], temp: float) -> str:
    return f"{command_label}: REWEIGHT_BIAS ARG={','.join(arguments)} TEMP={temp}\n"


def external(command_label: str, arguments: List[str], file: str) -> str:
    return f"{command_label}: EXTERNAL ARG={','.join(arguments)} FILE={file}\n"


def opes_metad(
    command_label: str,
    arguments: List[str],
    temperature: float,
    pace: int,
    sigmas: List[float],
    barrier: float,
    compression_threshold: float,
) -> str:
    return (
        "OPES_METAD ...\n"
        f" LABEL={command_label}\n"
        f" ARG={','.join(arguments)}\n"
        f" TEMP={temperature:.10g}\n"
        f" PACE={pace}\n"
        f" SIGMA={','.join(f'{s:.10g}' for s in sigmas)}\n"
        f" BARRIER={barrier:.10g}\n"
        f" COMPRESSION_THRESHOLD={compression_threshold:.10g}\n"
        "... OPES_METAD\n"
    )


def opes_metad_explore(
    command_label: str,
    arguments: List[str],
    temperature: float,
    pace: int,
    sigmas: List[float],
    barrier: float,
    compression_threshold: float,
) -> str:
    return (
        "OPES_METAD_EXPLORE ...\n"
        f" LABEL={command_label}\n"
        f" ARG={','.join(arguments)}\n"
        f" TEMP={temperature:.10g}\n"
        f" PACE={pace}\n"
        f" SIGMA={','.join(f'{s:.10g}' for s in sigmas)}\n"
        f" BARRIER={barrier:.10g}\n"
        f" COMPRESSION_THRESHOLD={compression_threshold:.10g}\n"
        "... OPES_METAD_EXPLORE\n"
    )


def opes_expanded(
    command_label: str, arguments: List[str], pace: int, observation_steps: int
) -> str:
    return (
        "OPES_EXPANDED ...\n"
        f" LABEL={command_label}\n"
        f" ARG={','.join(arguments)}\n"
        f" PACE={pace}\n"
        f" OBSERVATION_STEPS={observation_steps}\n"
        "... OPES_EXPANDED\n"
    )


def ecv_umbrellas_line(
    command_label: str,
    arguments: List[str],
    temperature: float,
    cv_mins: List[float],
    cv_maxs: List[float],
    sigmas: List[float],
    barrier: float,
) -> str:
    """ECV_UMBRELLAS_LINE: a line of umbrella expansion CVs along the
    (normalized) CV range, the expansion OPES_EXPANDED samples over.
    The reference never wired this (its add_opes_expanded raises
    NotImplementedError, cf. assembler.py:610-616); this completes the
    OPES_EXPANDED export using its command.py:951-988 OPES_EXPANDED text."""
    return (
        "ECV_UMBRELLAS_LINE ...\n"
        f" LABEL={command_label}\n"
        f" ARG={','.join(arguments)}\n"
        f" TEMP={temperature:.10g}\n"
        f" CV_MIN={','.join(f'{v:.10g}' for v in cv_mins)}\n"
        f" CV_MAX={','.join(f'{v:.10g}' for v in cv_maxs)}\n"
        f" SIGMA={','.join(f'{s:.10g}' for s in sigmas)}\n"
        f" BARRIER={barrier:.10g}\n"
        "... ECV_UMBRELLAS_LINE\n"
    )


def metad(
    command_label: str,
    arguments: List[str],
    sigmas: List[float],
    height: float,
    bias_factor: float,
    temperature: float,
    pace: int,
    grid_mins: List[float],
    grid_maxs: List[float],
    grid_bins: List[int],
) -> str:
    return (
        "METAD ...\n"
        f"LABEL={command_label}\n"
        f"ARG={','.join(arguments)}\n"
        f"SIGMA={','.join(f'{s:.6g}' for s in sigmas)}\n"
        f"HEIGHT={height:.10g}\n"
        f"BIASFACTOR={bias_factor:.10g}\n"
        f"TEMP={temperature:.10g}\n"
        f"PACE={pace}\n"
        f"GRID_MIN={','.join(f'{g:.10g}' for g in grid_mins)}\n"
        f"GRID_MAX={','.join(f'{g:.10g}' for g in grid_maxs)}\n"
        f"GRID_BIN={','.join(f'{g:.10g}' for g in grid_bins)}\n"
        "CALC_RCT\n"
        "... METAD\n"
    )


def com(command_label: str, atoms: Union[Sequence, str]) -> str:
    return f"{command_label}: COM ATOMS={_atoms_str(atoms)}\n"


def center(command_label: str, atoms: Union[Sequence, str]) -> str:
    return f"{command_label}: CENTER ATOMS={_atoms_str(atoms)}\n"


def pytorch_model(command_label: str, arguments: List[str], model_path: str) -> str:
    return (
        f"{command_label}: PYTORCH_MODEL FILE={model_path} ARG={','.join(arguments)}\n"
    )
