"""Amber mdcrd (.crd) trajectory reading/writing (fixed-format text, 10F8.3).

Completes the reference's supported-format list (SURVEY §2.4 traj-format
flags: dcd/xtc/trr/pdb/gro/xyz/crd).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def read_crd(
    path: str, n_atoms: int, has_box: Optional[bool] = None
) -> np.ndarray:
    """Read an Amber mdcrd file as (n_frames, n_atoms, 3) Angstroms.

    mdcrd needs the atom count from the topology (the file carries none).
    has_box=None auto-detects periodic-box records (3 extra values per
    frame, the common case for PBC runs): a boxed file's total value count
    divides by n_atoms*3+3; when both layouts divide, the line structure
    decides (box records are short 3-value lines where coordinate rows
    are full 10-value rows).
    """
    with open(path) as fh:
        lines = fh.readlines()
    values: list = []
    line_lengths: list = []
    for line in lines[1:]:  # first line is the title
        n_before = len(values)
        for i in range(0, len(line.rstrip("\n")), 8):
            chunk = line[i : i + 8].strip()
            if chunk:
                values.append(float(chunk))
        if len(values) > n_before:
            line_lengths.append(len(values) - n_before)
    if has_box is None:
        plain = n_atoms * 3
        boxed = plain + 3
        div_plain = len(values) % plain == 0
        div_boxed = len(values) % boxed == 0
        if div_boxed and not div_plain:
            has_box = True
        elif div_plain and not div_boxed:
            has_box = False
        else:
            # Ambiguous counts: the box record is a lone 3-value line on
            # its OWN line right after each frame's coordinate rows
            # (ceil(plain/10) of them). Inspect that line.
            coord_rows = (plain + 9) // 10
            # A 3-value line right after the coordinate rows only signals a
            # box when the NEXT frame's first row could not itself be 3
            # values. The next plain frame opens with min(plain, 10) values,
            # so the ONLY truly ambiguous case is plain == 3 (one atom);
            # fall back to no box there. Boxed 2-3 atom systems (plain 6/9)
            # stay detectable: their 3-value line cannot be coordinates.
            has_box = (
                plain != 3
                and len(line_lengths) > coord_rows
                and line_lengths[coord_rows] == 3
            )
    per_frame = n_atoms * 3 + (3 if has_box else 0)
    n_frames = len(values) // per_frame
    if n_frames == 0:
        raise ValueError(f"No complete frames parsed from {path}")
    arr = np.asarray(values[: n_frames * per_frame], np.float32).reshape(
        n_frames, per_frame
    )
    return arr[:, : n_atoms * 3].reshape(n_frames, n_atoms, 3)


def write_crd(path: str, coords: np.ndarray, title: str = "mdcrd") -> None:
    coords = np.asarray(coords, np.float32)
    n_frames = coords.shape[0]
    with open(path, "w") as fh:
        fh.write(title + "\n")
        for f in range(n_frames):
            flat = coords[f].reshape(-1)
            for i in range(0, len(flat), 10):
                row = flat[i : i + 10]
                fh.write("".join(f"{v:8.3f}" for v in row) + "\n")
