"""Build and load the port's native libraries: CUDA kernels and host C++.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) into its own shared library, loaded with ctypes. Nothing is
built at import: a kernel is built at its first launch, or all of them
together by `build_all()` (one `nvcc` process per source, run in parallel).
Host C++ sources (the XTC codec `io/csrc/xdrcodec.cpp`, the colvars text
parser and formatter `io/csrc/colvars_io.cpp`, the prefetching DCD reader
`io/csrc/dcdloader.cpp`, the batch dip test `stats/csrc/diptest.cpp`, the
gather of the staged copy up, and the row copy and page mapping of the copy
back, `geom/csrc/stage_atoms.cpp`) are
compiled by `g++` with OpenMP at first use through `load_host_library`,
each into a library of its own; a failed build raises.

Libraries go to `ops/_build/` next to this file, named by a hash of the
source and the flags. Each build writes a temporary file that `os.replace`
moves into place, so an edited source is rebuilt and concurrent processes
(test workers) never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp", "-pthread")
SOURCES = ("pair_distances", "kde_logsumexp", "pairwise_distance_matrix")

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()   # the mesh's worker threads load libraries too


@dataclass
class KernelStats:
    """Per-kernel call counters: `launches` counts CUDA kernel launches,
    `plain_calls` counts calls that took the plain PyTorch version (CPU
    tensors). Callers reset them to 0 around a region they measure. The
    counts are taken under a lock: the mesh's worker threads launch at
    once."""

    name: str
    launches: int = 0
    plain_calls: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def count_launch(self) -> None:
        """Count one launch. A call recorded into a CUDA graph under capture
        launches nothing and is not counted; the graph's replays launch the
        kernel without passing through its wrapper, so no counter sees them."""
        import torch

        if not torch.cuda.is_current_stream_capturing():
            with self._lock:
                self.launches += 1

    def count_plain(self) -> None:
        """Count one call of the plain version."""
        with self._lock:
            self.plain_calls += 1


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


def _library_path(src: Path, flags: Iterable[str]) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}_{digest[:16]}.so"


def _start_build(compiler: str, flags: tuple, src: Path):
    out = _library_path(src, flags)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *flags, "-o", tmp, str(src)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, Path(tmp), out


def _finish_build(proc: subprocess.Popen, tmp: Path, out: Path):
    """None once the library is in place, else the compiler's output."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return log
    os.replace(tmp, out)
    return None


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that is not built yet, all `nvcc`
    processes at once; raises with the compiler output if one fails."""
    pending = []
    paths: Dict[str, Path] = {}
    for name in names:
        src = CSRC / f"{name}.cu"
        out = _library_path(src, NVCC_FLAGS)
        paths[name] = out
        if not out.exists():
            pending.append((name, _start_build(_nvcc(), NVCC_FLAGS, src)))
    errors = []
    for name, build in pending:
        log = _finish_build(*build)
        if log is not None:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def build_host_all(sources: Iterable[Path]) -> None:
    """Compile every host C++ source in `sources` that is not built yet, all
    `g++` processes at once; raises with the compiler output if one fails."""
    pending = [src for src in sources if not _library_path(src, HOST_FLAGS).exists()]
    if not pending:
        return
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError(f"g++ not found; {pending[0].name} is compiled at first use.")
    builds = [(src, _start_build(compiler, HOST_FLAGS, src)) for src in pending]
    errors = [f"g++ failed for {src.name}:\n{log}" for src, build in builds
              if (log := _finish_build(*build)) is not None]
    if errors:
        raise RuntimeError("\n".join(errors))


def load_host_library(src: Path) -> ctypes.CDLL:
    """The ctypes handle of host C++ source `src`, compiled by `g++` on first
    use; raises with the compiler output if the build fails."""
    key = str(src)
    with _load_lock:
        lib = _loaded.get(key)
        if lib is None:
            build_host_all([src])
            lib = ctypes.CDLL(str(_library_path(src, HOST_FLAGS)))
            _loaded[key] = lib
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, built on first use.
    Every library exports `const char* dc_error_string(int)`."""
    with _load_lock:
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
