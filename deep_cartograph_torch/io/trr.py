"""TRR trajectory codec (GROMACS, XDR big-endian, uncompressed), pure numpy.

TRR stores coordinates in nm; this module converts to/from Angstroms so every
in-memory coordinate array in the framework is in Angstroms (PDB convention).
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

_MAGIC = 1993
_NM_TO_ANGSTROM = 10.0


class TRRError(ValueError):
    pass


def _xdr_string(data: bytes, off: int):
    if off + 4 > len(data):
        raise TRRError(f"Truncated TRR string field at offset {off}")
    (n,) = struct.unpack_from(">i", data, off)
    off += 4
    # XDR strings in trn files are written as length (incl. NUL) + padded bytes
    padded = (n + 3) // 4 * 4
    s = data[off : off + n]
    return s, off + padded


def _read_frame_header(data: bytes, off: int):
    if off + 4 > len(data):
        raise TRRError(f"Truncated TRR frame header at offset {off}")
    (magic,) = struct.unpack_from(">i", data, off)
    if magic != _MAGIC:
        raise TRRError(f"Bad TRR magic {magic} at offset {off}")
    off += 4
    # GROMACS trn layout: slen int (strlen+1 of "GMX_trn_file"), then the
    # XDR string itself ([byte length][payload padded to 4]). Files from
    # this repository's early TRR writer omit the slen int (the next int is
    # the string's byte length, 12, instead of strlen+1, 13): detect that
    # legacy layout and skip straight to the string.
    if off + 4 > len(data):
        raise TRRError(f"Truncated TRR version field at offset {off}")
    (first_int,) = struct.unpack_from(">i", data, off)
    if first_int != 12 or data[off + 4 : off + 16] != b"GMX_trn_file":
        off += 4  # slen (modern GROMACS layout)
    _, off = _xdr_string(data, off)
    if off + 13 * 4 > len(data):
        raise TRRError(f"Truncated TRR frame header at offset {off}")
    ints = struct.unpack_from(">13i", data, off)
    off += 13 * 4
    (
        ir_size, e_size, box_size, vir_size, pres_size, top_size, sym_size,
        x_size, v_size, f_size, natoms, step, nre,
    ) = ints
    # Corrupt negative payload sizes would walk the offset BACKWARDS in
    # the frame loops (a non-terminating scan), not just misread.
    if natoms < 0 or any(
        s < 0
        for s in (ir_size, e_size, box_size, vir_size, pres_size,
                  top_size, sym_size, x_size, v_size, f_size)
    ):
        raise TRRError(
            f"Corrupt TRR frame header (negative payload size) at "
            f"offset {off}"
        )
    # Floating point width inferred from box/x payload sizes.
    if box_size:
        double = box_size == 9 * 8
    elif x_size:
        double = x_size == natoms * 3 * 8
    else:
        double = False
    fsize = 8 if double else 4
    off += 2 * fsize  # t, lambda
    header = {
        "box_size": box_size,
        "vir_size": vir_size,
        "pres_size": pres_size,
        "x_size": x_size,
        "v_size": v_size,
        "f_size": f_size,
        "natoms": natoms,
        "step": step,
        "double": double,
        "ir_size": ir_size,
        "e_size": e_size,
        "top_size": top_size,
        "sym_size": sym_size,
    }
    return header, off


def count_trr_frames(path: str) -> int:
    """Coordinate-frame count by walking the frame headers (payload sizes
    from the header fields; no coordinate decoding)."""
    with open(path, "rb") as fh:
        data = fh.read()
    off = 0
    count = 0
    while off < len(data):
        header, off = _read_frame_header(data, off)
        off += (
            header["ir_size"] + header["e_size"] + header["box_size"]
            + header["vir_size"] + header["pres_size"] + header["x_size"]
            + header["v_size"] + header["f_size"]
        )
        if header["x_size"]:
            count += 1
    return count


def read_trr(
    path: str,
    start: int = 0,
    stop: Optional[int] = None,
    stride: int = 1,
) -> np.ndarray:
    """Read coordinates as (n_frames, n_atoms, 3) float32 Angstroms."""
    with open(path, "rb") as fh:
        data = fh.read()
    frames: List[np.ndarray] = []
    off = 0
    idx = 0
    while off < len(data):
        header, off = _read_frame_header(data, off)
        off += header["ir_size"] + header["e_size"]
        dt = ">f8" if header["double"] else ">f4"
        off += header["box_size"] + header["vir_size"] + header["pres_size"]
        natoms = header["natoms"]
        if header["x_size"]:
            take = (stop is None or idx < stop) and idx >= start and (idx - start) % stride == 0
            if off + header["x_size"] > len(data):
                raise TRRError(
                    f"Truncated TRR coordinate payload at offset {off} in {path}"
                )
            if take:
                x = np.frombuffer(data, dtype=dt, count=natoms * 3, offset=off)
                frames.append(
                    (x.reshape(natoms, 3) * _NM_TO_ANGSTROM).astype(np.float32)
                )
            off += header["x_size"]
            idx += 1
        off += header["v_size"] + header["f_size"]
        if stop is not None and idx >= stop:
            break
    if not frames:
        raise TRRError(f"No coordinate frames found in {path}")
    return np.stack(frames)


def write_trr(path: str, coords: np.ndarray, timestep_ps: float = 1.0) -> None:
    """Write (n_frames, n_atoms, 3) Angstrom coordinates as single-precision TRR."""
    coords = np.asarray(coords, dtype=np.float32) / _NM_TO_ANGSTROM
    n_frames, n_atoms, _ = coords.shape
    version = b"GMX_trn_file"
    with open(path, "wb") as fh:
        for f in range(n_frames):
            x_bytes = coords[f].astype(">f4").tobytes()
            fh.write(struct.pack(">i", _MAGIC))
            # GROMACS trn version section: slen (strlen+1) int, then the
            # XDR string ([byte length][payload padded to 4]) — the layout
            # GROMACS/MDAnalysis/VMD parse; 12 bytes needs no padding.
            fh.write(struct.pack(">i", len(version) + 1))
            fh.write(struct.pack(">i", len(version)))
            fh.write(version)
            fh.write(
                struct.pack(
                    ">13i",
                    0, 0, 0, 0, 0, 0, 0,  # ir,e,box,vir,pres,top,sym sizes
                    len(x_bytes), 0, 0,   # x,v,f sizes
                    n_atoms, f, 0,        # natoms, step, nre
                )
            )
            fh.write(struct.pack(">2f", f * timestep_ps, 0.0))  # t, lambda
            fh.write(x_bytes)
