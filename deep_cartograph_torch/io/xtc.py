"""XTC trajectory codec (GROMACS compressed format, magic 1995).

Frame framing (XDR big-endian) is handled here; the bit-packed coordinate
compression (xdr3dfcoord) runs in the port's C++ codec (`io/csrc/xdrcodec.cpp`),
compiled by g++ at first use (`ops/build.py::load_host_library`) and loaded
with ctypes. XTC stores nm; this module converts to and from Angstroms like
the rest of the IO layer.
"""

from __future__ import annotations

import ctypes
import queue
import struct
import threading
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

from deep_cartograph_torch.ops.build import load_host_library
from deep_cartograph_torch.utils.profiling import annotate

_MAGIC = 1995
_NM_TO_ANGSTROM = 10.0
_DEFAULT_PRECISION = 1000.0
_CODEC_SOURCE = Path(__file__).resolve().parent / "csrc" / "xdrcodec.cpp"

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)


class XTCError(ValueError):
    pass


def _lib() -> ctypes.CDLL:
    """The codec library, built on first use (raises with g++'s output if the
    build fails: there is no pure-Python decoder to fall back on)."""
    lib = load_host_library(_CODEC_SOURCE)
    lib.xtc_compress_coords.restype = ctypes.c_int
    lib.xtc_compress_coords.argtypes = [_F32P, ctypes.c_int, ctypes.c_float, _U8P,
                                        ctypes.c_int]
    lib.xtc_decompress_coords.restype = ctypes.c_int
    lib.xtc_decompress_coords.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _F32P]
    lib.xtc_decompress_frames_batch.restype = ctypes.c_int
    lib.xtc_decompress_frames_batch.argtypes = [
        _U8P, ctypes.c_long, ctypes.POINTER(ctypes.c_long), ctypes.c_int,
        ctypes.c_int, _F32P,
    ]
    return lib


def write_xtc(
    path: str,
    coords: np.ndarray,
    timestep_ps: float = 1.0,
    precision: float = _DEFAULT_PRECISION,
) -> None:
    """Write (n_frames, n_atoms, 3) Angstrom coordinates as XTC."""
    lib = _lib()
    coords_nm = np.ascontiguousarray(coords, dtype=np.float32) / _NM_TO_ANGSTROM
    n_frames, n_atoms, _ = coords_nm.shape
    out_buf = np.empty(n_atoms * 12 + 4096, np.uint8)

    with open(path, "wb") as fh:
        for f in range(n_frames):
            header = struct.pack(
                ">iiif", _MAGIC, n_atoms, f, f * timestep_ps
            ) + struct.pack(">9f", *([0.0] * 9))
            fh.write(header)
            fh.write(struct.pack(">i", n_atoms))  # lsize
            frame = coords_nm[f]
            if n_atoms <= 9:
                fh.write(frame.astype(">f4").tobytes())
                continue
            n = lib.xtc_compress_coords(
                frame.ctypes.data_as(_F32P), n_atoms, ctypes.c_float(precision),
                out_buf.ctypes.data_as(_U8P), len(out_buf),
            )
            if n < 0:
                raise XTCError(f"XTC compression failed (code {n})")
            fh.write(out_buf[:n].tobytes())


def _index_frames(
    data: bytes,
    start: int,
    stop: Optional[int],
    stride: int,
    path: str,
) -> List[tuple]:
    """Walk the frame table WITHOUT decompression (header fields give every
    payload size); return [(coord_off, lsize)] for the selected frames."""
    selected: List[tuple] = []
    off = 0
    index = 0
    while off + 56 <= len(data):
        magic, _natoms = struct.unpack_from(">ii", data, off)
        if magic != _MAGIC:
            raise XTCError(f"Bad XTC magic {magic} at offset {off}")
        lsize_off = off + 16 + 36
        (lsize,) = struct.unpack_from(">i", data, lsize_off)
        coord_off = lsize_off + 4
        if lsize < 0:
            # A negative lsize would walk `off` backwards: a loop, not an error.
            raise XTCError(
                f"Corrupt XTC frame header (lsize={lsize}) at offset "
                f"{off} in {path}"
            )
        if lsize <= 9:
            consumed = lsize * 12
        else:
            # precision + minint*3 + maxint*3 + smallidx = 8 ints, then nbytes
            if coord_off + 36 > len(data):
                raise XTCError(
                    f"Truncated XTC frame header at offset {off} in {path}"
                )
            (nbytes,) = struct.unpack_from(">i", data, coord_off + 32)
            if nbytes < 0:
                raise XTCError(
                    f"Corrupt XTC frame header (nbytes={nbytes}) at "
                    f"offset {off} in {path}"
                )
            consumed = 36 + ((nbytes + 3) // 4) * 4
        if coord_off + consumed > len(data):
            raise XTCError(
                f"Truncated XTC frame payload at offset {off} in {path}"
            )
        if (
            index >= start
            and (stop is None or index < stop)
            and (index - start) % stride == 0
        ):
            selected.append((coord_off, lsize))
        off = coord_off + consumed
        index += 1
        if stop is not None and index >= stop:
            break
    return selected


def _batch_decode(lib, data: bytes, buf: np.ndarray, selected: List[tuple],
                  natoms: int) -> np.ndarray:
    """OpenMP batch decode of the selected (uniform-natoms) frames."""
    offsets = np.asarray([o for o, _ in selected], np.int64)
    out = np.empty((len(selected), natoms, 3), np.float32)
    rc = lib.xtc_decompress_frames_batch(
        buf.ctypes.data_as(_U8P),
        ctypes.c_long(len(data)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        len(selected),
        natoms,
        out.ctypes.data_as(_F32P),
    )
    if rc < 0:
        raise XTCError(f"XTC batch decompression failed (code {rc})")
    return out * np.float32(_NM_TO_ANGSTROM)


def _decode_frames_serial(lib, data: bytes, buf: np.ndarray,
                          selected: List[tuple]) -> np.ndarray:
    """Per-frame decode of the selected frames: tiny uncompressed frames
    (<= 9 atoms) and files whose frames differ in atom count."""
    frames: List[np.ndarray] = []
    for coord_off, lsize in selected:
        if lsize <= 9:
            frame = np.frombuffer(
                data, dtype=">f4", count=lsize * 3, offset=coord_off
            ).reshape(lsize, 3)
            frames.append((frame * _NM_TO_ANGSTROM).astype(np.float32))
        else:
            out = np.empty((lsize, 3), np.float32)
            consumed = lib.xtc_decompress_coords(
                buf[coord_off:].ctypes.data_as(_U8P),
                len(data) - coord_off,
                lsize,
                out.ctypes.data_as(_F32P),
            )
            if consumed < 0:
                raise XTCError(f"XTC decompression failed (code {consumed})")
            frames.append(out * _NM_TO_ANGSTROM)
    return np.stack(frames)


def _batchable(selected: List[tuple]) -> Optional[int]:
    """The common atom count when every selected frame is compressed with the
    same one (the batch decoder's case), else None."""
    lsizes = {lsize for _, lsize in selected}
    natoms = next(iter(lsizes))
    return natoms if len(lsizes) == 1 and natoms > 9 else None


def iter_xtc_chunks_prefetch(
    path: str,
    chunk: int,
    stride: int = 1,
    prefetch_depth: int = 2,
) -> Iterator[np.ndarray]:
    """Yield (<=chunk, n_atoms, 3) float32 Angstrom arrays with chunk decode
    running on a background thread (the OpenMP batch decoder releases the
    GIL), so host decompression overlaps the caller's device work. Memory
    stays bounded at the compressed file + prefetch_depth decoded chunks.
    Abandoning the generator stops and joins the worker."""
    lib = _lib()
    with open(path, "rb") as fh:
        data = fh.read()
    buf = np.frombuffer(data, np.uint8)
    selected = _index_frames(data, 0, None, stride, path)
    if not selected:
        raise XTCError(f"No frames read from {path}")
    natoms = _batchable(selected)
    if natoms is None:
        # tiny or irregular frames: decode the bytes already read serially,
        # then slice into chunks
        with annotate("io.next_chunk"):
            coords = _decode_frames_serial(lib, data, buf, selected)
        for s in range(0, coords.shape[0], chunk):
            yield coords[s : s + chunk]
        return

    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch_depth))
    stop = threading.Event()

    def worker():
        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for s in range(0, len(selected), chunk):
                if not put(_batch_decode(lib, data, buf, selected[s : s + chunk],
                                         natoms)):
                    return
            put(None)
        except BaseException as exc:  # surface decode errors to the consumer
            put(exc)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            with annotate("io.next_chunk"):   # the wait for the decoder
                item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # Abandoned mid-iteration (timeout, break, error downstream): unblock
        # and retire the worker so neither the thread nor the file buffer
        # outlives the generator.
        stop.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5.0)


def read_xtc(
    path: str,
    start: int = 0,
    stop: Optional[int] = None,
    stride: int = 1,
) -> np.ndarray:
    """Read coordinates as (n_frames, n_atoms, 3) float32 Angstroms.

    Two passes: the frame table is walked WITHOUT decompression (header
    fields give every payload size), then all selected frames decode in
    parallel through the OpenMP batch decoder (frames are independent bit
    streams); tiny uncompressed or irregular frames decode one by one."""
    lib = _lib()
    with open(path, "rb") as fh:
        data = fh.read()
    buf = np.frombuffer(data, np.uint8)

    selected = _index_frames(data, start, stop, stride, path)
    if not selected:
        raise XTCError(f"No frames read from {path}")
    natoms = _batchable(selected)
    if natoms is not None:
        return _batch_decode(lib, data, buf, selected, natoms)
    return _decode_frames_serial(lib, data, buf, selected)


def count_xtc_frames(path: str) -> int:
    """Frame count by walking the frame headers (payload sizes from the
    byte-count field; no decompression)."""
    with open(path, "rb") as fh:
        data = fh.read()
    off = 0
    count = 0
    while off + 56 <= len(data):
        magic, _natoms = struct.unpack_from(">ii", data, off)
        if magic != _MAGIC:
            break
        lsize_off = off + 16 + 36
        (lsize,) = struct.unpack_from(">i", data, lsize_off)
        coord_off = lsize_off + 4
        if lsize < 0:
            raise XTCError(
                f"Corrupt XTC frame header (lsize={lsize}) at offset "
                f"{off} in {path}"
            )
        if lsize <= 9:
            off = coord_off + lsize * 12
        else:
            # precision + minint*3 + maxint*3 + smallidx = 8 ints, then nbytes
            (nbytes,) = struct.unpack_from(">i", data, coord_off + 32)
            if nbytes < 0:
                raise XTCError(
                    f"Corrupt XTC frame header (nbytes={nbytes}) at "
                    f"offset {off} in {path}"
                )
            off = coord_off + 36 + (nbytes + 3) // 4 * 4
        count += 1
    return count
