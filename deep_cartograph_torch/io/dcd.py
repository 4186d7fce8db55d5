"""DCD trajectory codec (CHARMM/NAMD binary format), pure numpy.

A copy of the JAX package's io/dcd.py (header, reader, writer), so the
port imports nothing of the JAX package. The format is Fortran
record-delimited: every record is framed by int32 byte counts.

Layout:
  record 1: 'CORD' + 20 int32 control words (icntrl)
            icntrl[0]=nframes, icntrl[1]=first step, icntrl[2]=save freq,
            icntrl[10]=unit-cell flag, icntrl[19]=CHARMM version
  record 2: ntitle + ntitle*80 title bytes
  record 3: natoms (int32)
  per frame: [6 float64 unit cell] (if flagged) + X,Y,Z records of
             natoms float32 each.

Reading and writing are vectorized over frames: the frame payloads are a
fixed-stride byte array, viewed once per axis (no per-frame Python loop).
"""

from __future__ import annotations

import logging
import os
import struct
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


class DCDError(ValueError):
    pass


def _read_exact(fh, n: int) -> bytes:
    data = fh.read(n)
    if len(data) != n:
        raise DCDError("Unexpected end of DCD file")
    return data


def _detect_endianness(fh) -> str:
    head = fh.read(4)
    fh.seek(0)
    (le,) = struct.unpack("<i", head)
    (be,) = struct.unpack(">i", head)
    if le == 84:
        return "<"
    if be == 84:
        return ">"
    raise DCDError(f"Not a DCD file (first record marker {le}/{be}, expected 84)")


def read_dcd_header(path: str) -> Tuple[int, int, bool, str, int]:
    """Return (n_atoms, n_frames, has_cell, endianness, header_size_bytes)."""
    with open(path, "rb") as fh:
        endian = _detect_endianness(fh)
        i4 = endian + "i"

        def rec():
            (n,) = struct.unpack(i4, _read_exact(fh, 4))
            payload = _read_exact(fh, n)
            (n2,) = struct.unpack(i4, _read_exact(fh, 4))
            if n2 != n:
                raise DCDError("Corrupt DCD record framing")
            return payload

        header = rec()
        if header[:4] != b"CORD":
            raise DCDError("Missing CORD magic in DCD header")
        icntrl = struct.unpack(endian + "20i", header[4:84])
        n_frames_hdr = icntrl[0]
        has_cell = icntrl[10] != 0
        rec()  # titles
        natoms_payload = rec()
        (n_atoms,) = struct.unpack(i4, natoms_payload)
        header_size = fh.tell()

        # Derive the true frame count from the file size — header counts are
        # frequently stale in appended/truncated files.
        frame_bytes = 3 * (4 + 4 * n_atoms + 4)
        if has_cell:
            frame_bytes += 4 + 48 + 4
        body = os.path.getsize(path) - header_size
        n_frames = body // frame_bytes
        if n_frames_hdr > 0 and body % frame_bytes:
            n_frames = min(n_frames, n_frames_hdr)
        if body % frame_bytes:
            # Partial trailing frame: killed run / interrupted copy. The
            # complete frames are still readable — say so instead of
            # silently dropping the tail.
            logger.warning(
                "%s ends mid-frame (%d stray bytes); reading the %d "
                "complete frames.",
                path,
                body % frame_bytes,
                n_frames,
            )
        return n_atoms, int(n_frames), has_cell, endian, header_size


def read_dcd(
    path: str,
    start: int = 0,
    stop: Optional[int] = None,
    stride: int = 1,
) -> np.ndarray:
    """Read coordinates as (n_frames, n_atoms, 3) float32 (Angstroms)."""
    n_atoms, n_frames, has_cell, endian, header_size = read_dcd_header(path)
    stop = n_frames if stop is None else min(stop, n_frames)
    frame_ids = np.arange(start, stop, stride)
    f32 = np.dtype(endian + "f4")

    cell_bytes = (4 + 48 + 4) if has_cell else 0
    coord_rec = 4 + 4 * n_atoms + 4
    frame_bytes = cell_bytes + 3 * coord_rec

    out = np.empty((len(frame_ids), n_atoms, 3), dtype=np.float32)
    if len(frame_ids) == 0:
        return out
    # Read only the byte range spanning the requested frames.
    first = int(frame_ids[0])
    last = int(frame_ids[-1]) + 1
    with open(path, "rb") as fh:
        fh.seek(header_size + first * frame_bytes)
        body = fh.read((last - first) * frame_bytes)
    if len(body) != (last - first) * frame_bytes:
        raise DCDError("Unexpected end of DCD file")
    frames = np.frombuffer(body, np.uint8).reshape(last - first, frame_bytes)
    frames = frames[frame_ids - first]
    for axis in range(3):
        off = cell_bytes + axis * coord_rec + 4
        out[:, :, axis] = frames[:, off : off + 4 * n_atoms].view(f32)
    return out


def write_dcd(path: str, coords: np.ndarray, timestep_ps: float = 1.0) -> None:
    """Write (n_frames, n_atoms, 3) float32 coordinates as a CHARMM DCD."""
    coords = np.asarray(coords, dtype=np.float32)
    if coords.ndim != 3 or coords.shape[2] != 3:
        raise DCDError("coords must have shape (n_frames, n_atoms, 3)")
    n_frames, n_atoms, _ = coords.shape

    def rec(payload: bytes) -> bytes:
        return struct.pack("<i", len(payload)) + payload + struct.pack("<i", len(payload))

    icntrl = [0] * 20
    icntrl[0] = n_frames     # number of frames
    icntrl[1] = 1            # first step
    icntrl[2] = 1            # save frequency
    icntrl[3] = n_frames     # number of steps
    icntrl[19] = 24          # CHARMM version stamp
    header = b"CORD" + struct.pack("<20i", *icntrl)
    # AKMA time units in icntrl[9] are skipped (zero) — readers tolerate this.

    title = b"Created by deep_cartograph_torch".ljust(80)[:80]
    titles = struct.pack("<i", 1) + title

    # Every frame is three records [n][x_1..x_n][n]: int32 byte-count
    # markers around little-endian f32 payloads, assembled as int32 words.
    body = np.empty((n_frames, 3, n_atoms + 2), dtype="<i4")
    body[:, :, 0] = 4 * n_atoms
    body[:, :, -1] = 4 * n_atoms
    body[:, :, 1:-1] = np.ascontiguousarray(
        coords.transpose(0, 2, 1), dtype="<f4"
    ).view("<i4")
    with open(path, "wb") as fh:
        fh.write(rec(header))
        fh.write(rec(titles))
        fh.write(rec(struct.pack("<i", n_atoms)))
        fh.write(body.tobytes())
