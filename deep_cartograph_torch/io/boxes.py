"""Per-frame unit-cell (box) reading for all supported trajectory formats.

The reference delegates box handling to MDAnalysis (`u.dimensions`,
cf. deep_cartograph/modules/md/md.py:1004-1011); here each codec's header is
walked directly. Returned boxes are orthorhombic edge lengths (n_frames, 3)
in Angstroms; non-orthorhombic cells fall back to their diagonal with a
warning (minimum-image below is exact only for orthorhombic cells). Returns
None when the file carries no box information.
"""

from __future__ import annotations

import logging
import struct
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_NM_TO_ANGSTROM = 10.0


def _warn_skewed(fmt: str) -> None:
    logger.warning(
        "%s box is non-orthorhombic; using the diagonal only (minimum-image "
        "unwrap/center is exact for orthorhombic cells).",
        fmt,
    )


def _read_dcd_boxes(path: str) -> Optional[np.ndarray]:
    from deep_cartograph_torch.io.dcd import read_dcd_header

    n_atoms, n_frames, has_cell, endian, header_size = read_dcd_header(path)
    if not has_cell:
        return None
    with open(path, "rb") as fh:
        raw = fh.read()
    body = raw[header_size:]
    cell_bytes = 4 + 48 + 4
    coord_rec = 4 + 4 * n_atoms + 4
    frame_bytes = cell_bytes + 3 * coord_rec
    f8 = np.dtype(endian + "f8")
    out = np.empty((n_frames, 3), np.float32)
    skewed = False
    for f in range(n_frames):
        # CHARMM XTLABC layout: [A, gamma, B, beta, alpha, C] where the
        # angle slots hold either degrees or cosines depending on writer.
        cell = np.frombuffer(body, dtype=f8, count=6, offset=f * frame_bytes + 4)
        out[f] = (cell[0], cell[2], cell[5])
        ang = np.asarray([cell[1], cell[3], cell[4]])
        # orthorhombic iff cosines ~0 or angles ~90 deg
        if not (np.all(np.abs(ang) < 1e-6) or np.allclose(ang, 90.0, atol=1e-3)):
            skewed = True
    if skewed:
        _warn_skewed("DCD")
    if np.all(out == 0):
        return None
    return out


def _read_xtc_boxes(path: str) -> Optional[np.ndarray]:
    from deep_cartograph_torch.io.xtc import _MAGIC

    with open(path, "rb") as fh:
        data = fh.read()
    boxes = []
    off = 0
    skewed = False
    while off + 56 <= len(data):
        magic, _ = struct.unpack_from(">ii", data, off)
        if magic != _MAGIC:
            break
        m = np.asarray(struct.unpack_from(">9f", data, off + 16)).reshape(3, 3)
        boxes.append(np.diag(m))
        if np.abs(m - np.diag(np.diag(m))).max() > 1e-6:
            skewed = True
        # advance exactly like count_xtc_frames (incl. its corrupt-header
        # guards: negative sizes would walk the offset backwards forever)
        lsize_off = off + 16 + 36
        (lsize,) = struct.unpack_from(">i", data, lsize_off)
        coord_off = lsize_off + 4
        if lsize < 0:
            break
        if lsize <= 9:
            off = coord_off + lsize * 12
        else:
            (nbytes,) = struct.unpack_from(">i", data, coord_off + 32)
            if nbytes < 0:
                break
            off = coord_off + 36 + (nbytes + 3) // 4 * 4
    if not boxes:
        return None
    if skewed:
        _warn_skewed("XTC")
    out = (np.stack(boxes) * _NM_TO_ANGSTROM).astype(np.float32)
    if np.all(out == 0):
        return None
    return out


def _read_trr_boxes(path: str) -> Optional[np.ndarray]:
    from deep_cartograph_torch.io.trr import _read_frame_header

    with open(path, "rb") as fh:
        data = fh.read()
    boxes = []
    off = 0
    skewed = False
    while off < len(data):
        header, off = _read_frame_header(data, off)
        off += header["ir_size"] + header["e_size"]
        if header["box_size"]:
            dt = ">f8" if header["double"] else ">f4"
            m = np.frombuffer(data, dtype=dt, count=9, offset=off).reshape(3, 3)
            boxes.append(np.diag(m))
            if np.abs(m - np.diag(np.diag(m))).max() > 1e-6:
                skewed = True
        off += header["box_size"] + header["vir_size"] + header["pres_size"]
        off += header["x_size"] + header["v_size"] + header["f_size"]
    if not boxes:
        return None
    if skewed:
        _warn_skewed("TRR")
    out = (np.stack(boxes) * _NM_TO_ANGSTROM).astype(np.float32)
    if np.all(out == 0):
        return None
    return out


def _read_gro_boxes(path: str) -> Optional[np.ndarray]:
    boxes = []
    with open(path) as fh:
        lines = fh.readlines()
    i = 0
    while i < len(lines) - 1:
        try:
            n_atoms = int(lines[i + 1])
        except ValueError:
            break
        box_line = lines[i + 2 + n_atoms].split()
        if len(box_line) >= 3:
            boxes.append([float(v) for v in box_line[:3]])
            if len(box_line) > 3 and any(abs(float(v)) > 1e-9 for v in box_line[3:]):
                _warn_skewed("GRO")
        i += n_atoms + 3
    if not boxes:
        return None
    out = (np.asarray(boxes, np.float32) * _NM_TO_ANGSTROM).astype(np.float32)
    if np.all(out == 0):
        return None
    return out


def _read_pdb_boxes(path: str) -> Optional[np.ndarray]:
    box = None
    n_models = 0
    with open(path) as fh:
        for line in fh:
            if line.startswith("CRYST1"):
                a, b, c = float(line[6:15]), float(line[15:24]), float(line[24:33])
                ang = (float(line[33:40]), float(line[40:47]), float(line[47:54]))
                if not np.allclose(ang, 90.0, atol=1e-3):
                    _warn_skewed("PDB")
                box = (a, b, c)
            elif line.startswith("MODEL"):
                n_models += 1
    if box is None or all(v in (0.0, 1.0) for v in box):
        # CRYST1 1 1 1 is the PDB convention for "no cell"
        return None
    return np.tile(np.asarray(box, np.float32), (max(n_models, 1), 1))


def _read_nc_boxes(path: str) -> Optional[np.ndarray]:
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as nc:
        if "cell_lengths" not in nc.variables:
            return None
        out = np.array(nc.variables["cell_lengths"][:], np.float32)
        if "cell_angles" in nc.variables:
            ang = np.array(nc.variables["cell_angles"][:])
            if not np.allclose(ang, 90.0, atol=1e-3):
                _warn_skewed("NetCDF")
    if np.all(out == 0):
        return None
    return out


def read_box(path: str) -> Optional[np.ndarray]:
    """Per-frame orthorhombic box lengths (n_frames, 3) in Angstroms, or
    None when the format/file carries no unit cell."""
    suffix = Path(path).suffix.lower()
    readers = {
        ".dcd": _read_dcd_boxes,
        ".xtc": _read_xtc_boxes,
        ".trr": _read_trr_boxes,
        ".gro": _read_gro_boxes,
        ".pdb": _read_pdb_boxes,
        ".nc": _read_nc_boxes,
    }
    reader = readers.get(suffix)
    if reader is None:
        return None
    return reader(path)
