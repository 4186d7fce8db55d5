"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) into its own shared library, loaded with ctypes. Nothing is
built at import: a kernel is built at its first launch, or all of them
together by `build_all()` (one `nvcc` process per source, run in parallel).

Libraries go to `ops/_build/` next to this file, named by a hash of the
source and the flags, so an edited source is rebuilt and concurrent
processes never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
SOURCES = ("pair_distances", "kde_logsumexp")

_loaded: Dict[str, ctypes.CDLL] = {}


@dataclass
class KernelStats:
    """Per-kernel call counters: `launches` counts CUDA kernel launches,
    `plain_calls` counts calls that took the plain PyTorch version (CPU
    tensors). Callers reset them to 0 around a region they measure."""

    name: str
    launches: int = 0
    plain_calls: int = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels of "
            "deep_cartograph_torch are compiled at first use."
        )
    return found


def _library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = _library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, Path(tmp), out


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that is not built yet, all `nvcc`
    processes at once; raises with the compiler output if one fails."""
    pending = []
    paths: Dict[str, Path] = {}
    for name in names:
        out = _library_path(name)
        paths[name] = out
        if not out.exists():
            pending.append((name, *_start_build(name)))
    errors = []
    for name, proc, tmp, out in pending:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, built on first use.
    Every library exports `const char* dc_error_string(int)`."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        lib.dc_error_string.argtypes = [ctypes.c_int]
        lib.dc_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check_status(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if status != 0:
        message = lib.dc_error_string(status).decode()
        raise RuntimeError(f"{what} failed: CUDA error {status} ({message})")


def current_stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
