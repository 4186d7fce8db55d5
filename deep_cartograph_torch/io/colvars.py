"""PLUMED COLVARS text-file I/O (numpy).

The port of the JAX package's io/colvars.py: the same header convention
("#! FIELDS ..."), the same ps -> ns time conversion on read, the same
labels/time/bias/walker column screen, the same cross-topology feature
translation, windows (start/stop/stride), streaming chunks and NaN screen.
Where the JAX package returns a pandas DataFrame, the port returns a
float32 matrix with its column names (and, for multi-file reads, the file
label of every row): the port imports no pandas.

The text goes through the OpenMP parser and formatter of
`io/csrc/colvars_io.cpp`, compiled by g++ at first use
(`ops/build.py::load_host_library`); a failed build raises. The formatter
writes a `%.Nf` format; any other format string goes through the Python
writer. `parse_body_plain` (numpy's `loadtxt`) and `write_colvars_plain`
(Python's `%` per row) are the plain versions the native routines are held
to. They differ in one token: glibc prints a NaN whose sign bit is set as
`-nan`, Python as `nan`.
"""

from __future__ import annotations

import ctypes
import io
import logging
import os
import re
import sys
from collections import OrderedDict
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from deep_cartograph_torch.ops.build import load_host_library

logger = logging.getLogger(__name__)

_SOURCE = Path(__file__).resolve().parent / "csrc" / "colvars_io.cpp"
_F32P = ctypes.POINTER(ctypes.c_float)


def _lib() -> ctypes.CDLL:
    """The colvars text library, built on first use."""
    lib = load_host_library(_SOURCE)
    lib.colvars_parse.restype = ctypes.c_long
    lib.colvars_parse.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                                  _F32P, ctypes.c_long]
    lib.colvars_format_rt.restype = ctypes.c_long
    lib.colvars_format_rt.argtypes = [_F32P, ctypes.c_long, ctypes.c_long, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_long, _F32P]
    return lib


# Drops the non-feature columns (labels, time, bias, walker).
NON_FEATURE_REGEX = "^(?!.*labels)^(?!.*time)^(?!.*bias)^(?!.*walker)"

Paths = Union[List[str], str]


def _as_list(paths: Optional[Paths]) -> Optional[List[str]]:
    return [paths] if isinstance(paths, str) else paths


# ---------------------------------------------------------------------------
# Same-run memory cache: a pipeline writes colvars text and its next steps
# read it back. write_colvars caches the matrix as a reader will parse it
# (the formatter's round-trip floats: each emitted token parsed by the
# parser's own routine), so a cached read equals a file read. Entries are
# checked against the file's (mtime_ns, size, inode, last 64 bytes) and
# evicted least recently used past the byte cap.
# DEEP_CARTO_COLVARS_CACHE_BYTES (read at each call; default 2 GiB) sets the
# cap; 0 disables the cache.
# ---------------------------------------------------------------------------
_MEM_CACHE: "OrderedDict[str, tuple]" = OrderedDict()


def _cache_cap_bytes() -> int:
    return int(os.environ.get("DEEP_CARTO_COLVARS_CACHE_BYTES", 2 * 2**30))


def _file_key(path: str) -> tuple:
    stat = os.stat(path)
    with open(path, "rb") as fh:
        if stat.st_size > 64:
            fh.seek(-64, os.SEEK_END)
        tail = fh.read(64)
    return stat.st_mtime_ns, stat.st_size, stat.st_ino, tail


def _cache_put(path: str, names: List[str], matrix: np.ndarray) -> None:
    cap = _cache_cap_bytes()
    if cap <= 0:
        return
    key = os.path.abspath(path)
    try:
        stamp = _file_key(key)
    except OSError:
        return
    matrix = np.ascontiguousarray(matrix, np.float32)
    if matrix.nbytes > cap:
        return
    _MEM_CACHE[key] = (stamp, list(names), matrix)
    _MEM_CACHE.move_to_end(key)
    total = sum(v[2].nbytes for v in _MEM_CACHE.values())
    while total > cap and len(_MEM_CACHE) > 1:
        _, evicted = _MEM_CACHE.popitem(last=False)
        total -= evicted[2].nbytes


def _cache_get(path: str):
    key = os.path.abspath(path)
    hit = _MEM_CACHE.get(key)
    if hit is None:
        return None
    try:
        stamp = _file_key(key)
    except OSError:
        _MEM_CACHE.pop(key, None)
        return None
    if stamp != hit[0]:
        _MEM_CACHE.pop(key, None)
        return None
    _MEM_CACHE.move_to_end(key)
    return hit[1], hit[2]


def clear_memory_cache() -> None:
    _MEM_CACHE.clear()


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def read_column_names(colvars_path: str, features_only: bool = False) -> List[str]:
    """Column names from the '#! FIELDS' header."""
    hit = _cache_get(colvars_path)
    if hit is not None:
        names = list(hit[0])
    else:
        with open(colvars_path) as fh:
            names = fh.readline().split()[2:]
    if features_only:
        names = [n for n in names if re.search(NON_FEATURE_REGEX, n)]
    return names


def _parse_body(body: bytes, n_cols: int) -> np.ndarray:
    """Parse a line-aligned byte slab of a colvars body to (rows, n_cols)
    float32 with the native parser; '#' and blank lines are skipped. Raises
    on a row with fewer than n_cols numbers (or a token that is not one);
    numbers past the n_cols-th of a row are not read."""
    max_rows = body.count(b"\n") + 1
    out = np.empty((max_rows, n_cols), np.float32)
    rows = _lib().colvars_parse(body, len(body), n_cols, out.ctypes.data_as(_F32P),
                                max_rows)
    if rows < 0:
        raise ValueError(f"a row of the colvars body does not hold {n_cols} numbers")
    return out[:rows]


def parse_body_plain(body: bytes, n_cols: int) -> np.ndarray:
    """The plain version of `_parse_body` (numpy's loadtxt, which rounds
    each token through float64)."""
    if not body.strip():
        return np.empty((0, n_cols), np.float32)
    out = np.loadtxt(io.BytesIO(body), comments="#", dtype=np.float32, ndmin=2)
    if out.shape[1] != n_cols:
        raise ValueError(f"{out.shape[1]} columns in the body, {n_cols} in the header")
    return out


def _load_matrix(colvars_path: str) -> np.ndarray:
    """The whole numeric body of a colvars file as float32 (from the memory
    cache when this process wrote the file)."""
    hit = _cache_get(colvars_path)
    if hit is not None:
        return hit[1].copy()
    n_cols = len(read_column_names(colvars_path))
    if n_cols == 0:
        return np.loadtxt(colvars_path, comments="#", dtype=np.float32, ndmin=2)
    with open(colvars_path, "rb") as fh:
        return _parse_body(fh.read(), n_cols)


def read_colvars(colvars_path: str) -> Tuple[np.ndarray, List[str]]:
    """Whole-file read, (matrix, names), with the time column from ps to
    ns."""
    names = read_column_names(colvars_path)
    data = _load_matrix(colvars_path)
    if "time" in names:
        col = names.index("time")
        data[:, col] = data[:, col] * 1000 / 1000000
    return data, names


def _resolve_feature_columns(
    all_names: List[str], feature_names: Optional[Sequence[str]], colvars_path: str
) -> Tuple[List[int], List[str]]:
    """Column indices and names of a feature selection: the requested names
    in their order, or every non-label/time/bias/walker column."""
    if feature_names is None:
        keep = [i for i, n in enumerate(all_names) if re.search(NON_FEATURE_REGEX, n)]
        return keep, [all_names[i] for i in keep]
    index = {n: i for i, n in enumerate(all_names)}
    missing = [n for n in feature_names if n not in index]
    if missing:
        raise ValueError(f"Features {missing} not found in colvars file {colvars_path}")
    return [index[n] for n in feature_names], list(feature_names)


def read_features_matrix(
    colvars_path: str,
    feature_names: Optional[Sequence[str]] = None,
    start: int = 0,
    stop: Optional[int] = None,
    stride: int = 1,
) -> Tuple[np.ndarray, List[str]]:
    """((frames, features) float32, names): one parse, all features."""
    all_names = read_column_names(colvars_path)
    data = _load_matrix(colvars_path)[start:stop:stride]
    keep, names = _resolve_feature_columns(all_names, feature_names, colvars_path)
    return np.ascontiguousarray(data[:, keep]), names


def iter_features_chunks(
    colvars_path: str,
    chunk_rows: Optional[int] = None,
    feature_names: Optional[Sequence[str]] = None,
    start: int = 0,
    stop: Optional[int] = None,
    stride: int = 1,
    nan_check: bool = False,
):
    """Stream a colvars file's feature matrix as (<= chunk_rows, F) float32
    blocks without holding the whole matrix.

    The file is read in line-aligned byte slabs of about chunk_rows rows,
    each parsed like `read_features_matrix` and cut to the selected
    columns, so values equal the in-memory reader's. start/stop/stride
    apply to the global row index; negative start/stop are rejected (the
    row count is not known up front). `chunk_rows=None` sizes chunks from
    the file's full width (`stream_chunk_rows`). `nan_check` raises "Clean
    your data!" on a NaN anywhere in the full-width rows read.
    """
    if chunk_rows is None:
        chunk_rows = stream_chunk_rows(colvars_path)
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    if start < 0 or (stop is not None and stop < 0):
        raise ValueError(
            "negative start/stop are not supported by the streaming reader "
            f"(got start={start}, stop={stop}); use read_features_matrix for "
            "from-the-end indexing"
        )
    all_names = read_column_names(colvars_path)
    n_cols = len(all_names)
    if n_cols == 0:
        return
    keep, _ = _resolve_feature_columns(all_names, feature_names, colvars_path)
    keep_arr = np.asarray(keep, dtype=np.intp)

    hit = _cache_get(colvars_path)
    if hit is not None:
        if nan_check and np.isnan(hit[1]).any():
            raise ValueError(f"Clean your data! NaNs found in {colvars_path}")
        mat = hit[1][start:stop:stride]
        for s in range(0, mat.shape[0], chunk_rows):
            yield np.ascontiguousarray(mat[s : s + chunk_rows][:, keep_arr])
        return

    # ~18 bytes per formatted column bounds PLUMED's usual formats.
    slab_bytes = max(chunk_rows * n_cols * 18, 1 << 20)
    row_idx = 0  # global data-row index (comment lines excluded)
    pending: List[np.ndarray] = []
    pending_rows = 0

    def select(block: np.ndarray):
        nonlocal row_idx
        if nan_check and np.isnan(block).any():
            raise ValueError(f"Clean your data! NaNs found in {colvars_path}")
        lo = row_idx
        row_idx += block.shape[0]
        first = max(start, lo)
        if stride > 1 and first > start:
            first = start + ((first - start + stride - 1) // stride) * stride
        hi = row_idx if stop is None else min(stop, row_idx)
        if first >= hi:
            return None
        return block[np.arange(first, hi, stride) - lo][:, keep_arr]

    def add(block: np.ndarray) -> None:
        nonlocal pending_rows
        sel = select(block)
        if sel is not None and sel.shape[0]:
            pending.append(sel)
            pending_rows += sel.shape[0]

    def flush(final: bool):
        nonlocal pending, pending_rows
        while pending_rows >= chunk_rows or (final and pending_rows > 0):
            merged = np.concatenate(pending) if len(pending) > 1 else pending[0]
            yield np.ascontiguousarray(merged[:chunk_rows])
            rest = merged[chunk_rows:]
            pending = [rest] if rest.shape[0] else []
            pending_rows = rest.shape[0]

    with open(colvars_path, "rb") as fh:
        carry = b""
        while True:
            slab = fh.read(slab_bytes)
            if not slab:
                break
            slab = carry + slab
            cut = slab.rfind(b"\n")
            if cut < 0:
                carry = slab
                continue
            carry = slab[cut + 1 :]
            add(_parse_body(slab[: cut + 1], n_cols))
            yield from flush(final=False)
        if carry.strip():
            add(_parse_body(carry, n_cols))
    yield from flush(final=True)


def read_features(
    colvars_paths: Paths,
    ref_feature_names: List[str],
    topology_paths: Optional[List[str]] = None,
    reference_topology: Optional[str] = None,
    stratified_samples: Optional[List[int]] = None,
) -> np.ndarray:
    """(frames, features) float32 of `ref_feature_names` across files, each
    file's names translated from the reference topology to its own."""
    from deep_cartograph_torch.features.translator import Translator

    colvars_paths = _as_list(colvars_paths)
    if topology_paths:
        if not reference_topology:
            reference_topology = topology_paths[0]
        if len(colvars_paths) != len(topology_paths):
            logger.error("Number of topology files does not match colvars files.")
            sys.exit(1)

    blocks: List[np.ndarray] = []
    for ci, colvars_path in enumerate(colvars_paths):
        if not os.path.exists(colvars_path):
            logger.error("Colvars file not found: %s", colvars_path)
            sys.exit(1)
        if topology_paths:
            selected = Translator(
                reference_topology, topology_paths[ci], ref_feature_names
            ).run()
        else:
            selected = list(ref_feature_names)
        for fi, name in enumerate(selected):
            if name is None:
                logger.error("Feature %s not found in the reference topology.",
                             ref_feature_names[fi])
                sys.exit(1)
        mat, _ = read_features_matrix(colvars_path, selected)
        if stratified_samples is not None:
            # stratified samples count data rows from 1 (the header is row 0)
            mat = mat[[s - 1 for s in stratified_samples if 1 <= s <= mat.shape[0]]]
        blocks.append(mat)
    return np.concatenate(blocks, axis=0)


# ---------------------------------------------------------------------------
# Loading strategy: in memory or streamed
# ---------------------------------------------------------------------------

def check(colvars_path: str) -> None:
    """Exit (code 1) unless the colvars file exists, has rows and holds no
    NaN; a file this process wrote is checked from the memory cache."""
    if not os.path.exists(colvars_path):
        logger.error("COLVARS file not found: %s", colvars_path)
        sys.exit(1)
    data = _load_matrix(colvars_path)
    if data.size == 0:
        logger.error("COLVARS file is empty: %s", colvars_path)
        sys.exit(1)
    if np.isnan(data).any():
        logger.error("COLVARS file contains NaN values: %s", colvars_path)
        sys.exit(1)


def estimate_matrix_bytes(
    colvars_paths: Paths,
    n_features: int,
    start: int = 0,
    stop: Optional[int] = None,
    stride: int = 1,
) -> int:
    """Rough float32 matrix size from the file sizes and a head sample
    (rows ~ bytes / mean data-line length), within a reading window. It
    only picks a loading strategy."""
    stride = max(stride, 1)
    total_rows = 0
    for p in _as_list(colvars_paths):
        size = os.path.getsize(p)
        with open(p, "rb") as fh:
            head = fh.read(65536)
        lines = [ln for ln in head.split(b"\n") if ln and not ln.startswith(b"#")]
        bpr = (sum(len(ln) + 1 for ln in lines) / len(lines)
               if lines else max(n_features, 1) * 12)
        rows = int(size / max(bpr, 1))
        rows = len(range(start, rows if stop is None else min(stop, rows), stride)) \
            if rows > start else 0
        total_rows += rows
    return total_rows * n_features * 4


def stream_chunk_rows(colvars_path: str, budget_bytes: int = 256 * 2**20) -> int:
    """Rows per streamed block such that one full-width parsed slab stays
    within ~budget_bytes (the slab parses every column before the
    selection). DEEP_CARTO_STREAM_CHUNK_ROWS overrides."""
    env = int(os.environ.get("DEEP_CARTO_STREAM_CHUNK_ROWS", 0))
    if env > 0:
        return env
    n_cols = max(len(read_column_names(colvars_path)), 1)
    return max(budget_bytes // (4 * n_cols), 256)


def is_plumed_file(file_path: str) -> bool:
    """True if the file starts with '#! FIELDS'."""
    with open(file_path) as fh:
        first = fh.readline().split()
    return len(first) >= 2 and first[0] == "#!" and first[1] == "FIELDS"


def should_stream_colvars(colvars_paths: Paths, mode="auto") -> bool:
    """Streams only PLUMED files. "auto" streams when the estimated
    full-width float32 matrix exceeds DEEP_CARTO_STREAM_BYTES (default 4
    GiB; 0 disables auto); True/"on" forces it where eligible; False/"off"
    disables it."""
    colvars_paths = _as_list(colvars_paths)
    if mode in (False, "off", "false"):
        return False
    eligible = bool(colvars_paths) and all(is_plumed_file(p) for p in colvars_paths)
    if mode in (True, "on"):
        return eligible
    if not eligible:
        return False
    threshold = int(os.environ.get("DEEP_CARTO_STREAM_BYTES", 4 * 2**30))
    if threshold <= 0:
        return False
    total = sum(estimate_matrix_bytes([p], max(len(read_column_names(p)), 1))
                for p in colvars_paths)
    return total > threshold


def translation_is_identity(
    topology_paths: Optional[List[str]], reference_topology: Optional[str]
) -> bool:
    """True when translating features between topologies is a no-op: no
    topologies, or every topology is the reference (by default the first).
    The streaming readers select columns by untranslated name, so they are
    valid exactly then."""
    if not topology_paths:
        return True
    ref = reference_topology or topology_paths[0]
    try:
        r = os.path.realpath(ref)
        return all(os.path.realpath(p) == r for p in topology_paths)
    except OSError:
        return False


def _read_table(path: str) -> Tuple[np.ndarray, List[str]]:
    """A PLUMED file, or a comma-separated file with a header row."""
    if is_plumed_file(path):
        return read_colvars(path)
    with open(path) as fh:
        names = [n.strip() for n in fh.readline().split(",")]
    data = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float32, ndmin=2)
    return data, names


def load_table(
    file_paths: Paths, start: int = 0, stop: Optional[int] = None, stride: int = 1
) -> Tuple[np.ndarray, List[str]]:
    """PLUMED or CSV files, each cut to [start:stop:stride], stacked; the
    first file's names."""
    mats, names = [], None
    for path in _as_list(file_paths):
        data, cols = _read_table(path)
        names = names or cols
        mats.append(data[start:stop:stride])
    return np.concatenate(mats, axis=0), names


def create_dataframe_from_files(
    colvars_paths: Paths,
    topology_paths: Optional[Paths] = None,
    reference_topology: Optional[str] = None,
    features_list: Optional[Sequence[str]] = None,
    start: int = 0,
    stop: Optional[int] = None,
    stride: int = 1,
) -> Tuple[np.ndarray, List[str], np.ndarray]:
    """Several colvars files as one (matrix float32, feature names, file
    label of each row): the feature columns of each file, translated onto
    the reference topology, selected and ordered by `features_list`."""
    from deep_cartograph_torch.features.translator import Translator

    colvars_paths = _as_list(colvars_paths)
    topology_paths = _as_list(topology_paths)
    if topology_paths:
        if len(colvars_paths) != len(topology_paths):
            raise TypeError(
                "topology_paths should be a list of the same length as colvars_paths."
            )
        if not reference_topology:
            reference_topology = topology_paths[0]

    mats: List[np.ndarray] = []
    all_names: List[List[str]] = []
    for fi, path in enumerate(colvars_paths):
        data, cols = load_table(path, start, stop, stride)
        if np.isnan(data).any():
            raise ValueError(f"Clean your data! NaNs found in {path}")
        keep = [i for i, n in enumerate(cols) if re.search(NON_FEATURE_REGEX, n)]
        names = [cols[i] for i in keep]
        if topology_paths:
            translated = Translator(topology_paths[fi], reference_topology, names).run()
            kept = [i for i, t in enumerate(translated) if t is not None]
            dropped = len(translated) - len(kept)
            if dropped:
                logger.warning(
                    "%d features could not be translated from %s to %s and "
                    "will be dropped.", dropped, topology_paths[fi], reference_topology,
                )
            keep = [keep[i] for i in kept]
            names = [translated[i] for i in kept]
        if features_list:
            index = {n: i for i, n in enumerate(names)}
            missing = set(features_list) - set(index)
            if missing:
                raise ValueError(f"Features {missing} not found in {path}.")
            keep = [keep[index[n]] for n in features_list]
            names = list(features_list)
        mats.append(np.ascontiguousarray(data[:, keep]))
        all_names.append(names)

    if not features_list:
        for i, names in enumerate(all_names[1:], 1):
            if names != all_names[0]:
                logger.error("Column names in %s do not match those in %s.",
                             colvars_paths[i], colvars_paths[0])
                sys.exit(1)
    matrix = np.concatenate(mats, axis=0)
    if matrix.size == 0:
        logger.error("The resulting dataframe is empty.")
        sys.exit(1)
    labels = np.repeat(np.arange(len(mats)), [m.shape[0] for m in mats])
    return matrix, all_names[0], labels


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

WRITE_CHUNK_ROWS = 4096
_FIXED = re.compile(r"%\.(\d+)f")


def write_colvars(
    path: str, data: np.ndarray, column_names: List[str], fmt: str = "%.4f"
) -> None:
    """Write a PLUMED colvars file: '#! FIELDS ...' header, then one row per
    line, each value formatted with `fmt` and separated by a space (what
    numpy's savetxt writes). A `%.Nf` format goes through the native
    formatter, which also returns each value as a reader will parse it: with
    the memory cache on, those values are cached. Another format goes
    through `write_colvars_plain`."""
    data = np.ascontiguousarray(data, np.float32)
    match = _FIXED.fullmatch(fmt)
    if match is None:
        write_colvars_plain(path, data, column_names, fmt)
        return
    decimals = int(match.group(1))
    rows, cols = data.shape
    # Bytes per token from the data's magnitude: sign, integer digits, '.',
    # decimals and a separator; a NaN or inf maximum takes the generous budget.
    max_abs = max(abs(float(np.min(data, initial=0.0))),
                  abs(float(np.max(data, initial=0.0))))
    if not np.isfinite(max_abs):
        int_digits = 40
    elif max_abs >= 1.0:
        int_digits = int(np.floor(np.log10(max_abs))) + 2
    else:
        int_digits = 2
    capacity = rows * cols * max(decimals + int_digits + 4, decimals + 16) + 1024
    out = np.empty(capacity, np.uint8)
    cache = 0 < _cache_cap_bytes() and data.nbytes <= _cache_cap_bytes()
    roundtrip = np.empty((rows, cols), np.float32) if cache else None
    n = _lib().colvars_format_rt(
        data.ctypes.data_as(_F32P), rows, cols, decimals, out.ctypes.data, capacity,
        None if roundtrip is None else roundtrip.ctypes.data_as(_F32P),
    )
    if n < 0:
        raise RuntimeError(f"the colvars formatter overran its {capacity}-byte buffer")
    with open(path, "wb") as fh:
        fh.write(("#! FIELDS " + " ".join(column_names) + "\n").encode())
        fh.write(memoryview(out)[:n])
    if roundtrip is not None:
        _cache_put(path, column_names, roundtrip)


def write_colvars_plain(
    path: str, data: np.ndarray, column_names: List[str], fmt: str = "%.4f"
) -> None:
    """The plain version of `write_colvars`: Python's `%` row by row. With
    the memory cache on, each formatted chunk is parsed back and cached."""
    data = np.ascontiguousarray(data, np.float32)
    row_fmt = " ".join([fmt] * data.shape[1]) + "\n"
    cache = 0 < _cache_cap_bytes() and data.nbytes <= _cache_cap_bytes()
    parsed: List[np.ndarray] = []
    with open(path, "wb") as fh:
        fh.write(("#! FIELDS " + " ".join(column_names) + "\n").encode())
        for s in range(0, data.shape[0], WRITE_CHUNK_ROWS):
            text = "".join(row_fmt % tuple(r)
                           for r in data[s : s + WRITE_CHUNK_ROWS].tolist()).encode()
            fh.write(text)
            if cache:
                parsed.append(_parse_body(text, data.shape[1]))
    if cache:
        _cache_put(path, column_names, np.concatenate(parsed)
                   if parsed else np.empty((0, data.shape[1]), np.float32))
