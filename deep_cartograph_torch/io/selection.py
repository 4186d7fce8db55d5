"""MDAnalysis-compatible atom-selection mini-language.

Implements the subset of the MDAnalysis selection grammar used throughout the
reference configs and code (e.g. "name CA", "protein and name CA",
"resid 625:634 and name CA", "not backbone and not name H*", "all"), so the
port accepts the same selection strings without MDAnalysis. A copy of
the JAX package's io/selection.py: the port imports nothing of that
package.

Grammar (recursive descent):
    or_expr   := and_expr ("or" and_expr)*
    and_expr  := not_expr ("and" not_expr)*
    not_expr  := "not" not_expr | primary
    primary   := "(" or_expr ")" | clause
    clause    := "all" | "none" | "protein" | "backbone" | "sidechain"
               | "name" value+ | "resname" value+ | "resid"/"resnum" range+
               | "index"/"bynum" range+ | "segid" value+ | "chainID" value+
               | "element"/"type" value+

Values support glob wildcards ('H*'); resid/index accept ranges "a:b" or
"a-b" (inclusive) and bare integers.
"""

from __future__ import annotations

import fnmatch
import re
from typing import TYPE_CHECKING, List

import numpy as np

if TYPE_CHECKING:
    from deep_cartograph_torch.io.topology import Topology

_KEYWORDS = {
    "and", "or", "not", "(", ")",
    "all", "none", "protein", "backbone", "sidechain",
    "name", "resname", "resid", "resnum", "residue",
    "index", "bynum", "segid", "chainid", "element", "type",
}

_CLAUSE_HEADS = {
    "name", "resname", "resid", "resnum", "residue",
    "index", "bynum", "segid", "chainid", "element", "type",
}

_TOKEN_RE = re.compile(r"\(|\)|[^\s()]+")


def _tokenize(selection: str) -> List[str]:
    return _TOKEN_RE.findall(selection)


class _Parser:
    def __init__(self, tokens: List[str], top: "Topology"):
        self.tokens = tokens
        self.pos = 0
        self.top = top

    # -- token helpers ---------------------------------------------------
    def peek(self) -> str | None:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> str:
        tok = self.peek()
        if tok is None:
            raise ValueError("Unexpected end of selection string")
        self.pos += 1
        return tok

    # -- grammar ---------------------------------------------------------
    def parse(self) -> np.ndarray:
        mask = self.or_expr()
        if self.peek() is not None:
            raise ValueError(f"Unexpected token in selection: {self.peek()!r}")
        return mask

    def or_expr(self) -> np.ndarray:
        mask = self.and_expr()
        while self.peek() is not None and self.peek().lower() == "or":
            self.next()
            mask = mask | self.and_expr()
        return mask

    def and_expr(self) -> np.ndarray:
        mask = self.not_expr()
        while self.peek() is not None and self.peek().lower() == "and":
            self.next()
            mask = mask & self.not_expr()
        return mask

    def not_expr(self) -> np.ndarray:
        if self.peek() is not None and self.peek().lower() == "not":
            self.next()
            return ~self.not_expr()
        return self.primary()

    def primary(self) -> np.ndarray:
        tok = self.peek()
        if tok is None:
            raise ValueError("Unexpected end of selection string")
        if tok == "(":
            self.next()
            mask = self.or_expr()
            if self.next() != ")":
                raise ValueError("Missing closing parenthesis in selection")
            return mask
        return self.clause()

    # -- clauses ----------------------------------------------------------
    def _collect_values(self) -> List[str]:
        values: List[str] = []
        while True:
            tok = self.peek()
            if tok is None or tok.lower() in ("and", "or", "not") or tok in ("(", ")"):
                break
            if tok.lower() in _CLAUSE_HEADS and values:
                break
            values.append(self.next())
        if not values:
            raise ValueError("Selection keyword requires at least one value")
        return values

    def clause(self) -> np.ndarray:
        top = self.top
        n = top.n_atoms
        tok = self.next().lower()

        if tok == "all":
            return np.ones(n, dtype=bool)
        if tok == "none":
            return np.zeros(n, dtype=bool)
        if tok == "protein":
            from deep_cartograph_torch.io.topology import PROTEIN_RESNAMES

            return np.asarray(
                [str(r) in PROTEIN_RESNAMES for r in top.resnames], dtype=bool
            )
        if tok == "backbone":
            from deep_cartograph_torch.io.topology import (
                BACKBONE_NAMES,
                PROTEIN_RESNAMES,
            )

            is_protein = np.asarray(
                [str(r) in PROTEIN_RESNAMES for r in top.resnames], dtype=bool
            )
            is_bb = np.asarray(
                [str(a) in BACKBONE_NAMES for a in top.names], dtype=bool
            )
            return is_protein & is_bb
        if tok == "sidechain":
            from deep_cartograph_torch.io.topology import (
                BACKBONE_NAMES,
                PROTEIN_RESNAMES,
            )

            is_protein = np.asarray(
                [str(r) in PROTEIN_RESNAMES for r in top.resnames], dtype=bool
            )
            is_bb = np.asarray(
                [str(a) in BACKBONE_NAMES for a in top.names], dtype=bool
            )
            return is_protein & ~is_bb

        if tok == "name":
            return self._match_strings(top.names, self._collect_values())
        if tok == "resname":
            return self._match_strings(top.resnames, self._collect_values())
        if tok in ("resid", "resnum", "residue"):
            return self._match_ints(top.resids, self._collect_values())
        if tok in ("index", "bynum"):
            # MDAnalysis `bynum` is 1-based, `index` is 0-based.
            values = self._collect_values()
            offset = 1 if tok == "bynum" else 0
            idx = np.arange(n) + offset
            return self._match_ints(idx, values)
        if tok == "segid":
            return self._match_strings(top.segids, self._collect_values())
        if tok == "chainid":
            return self._match_strings(top.chain_ids, self._collect_values())
        if tok in ("element", "type"):
            # Element symbols match case-insensitively ("Cl" == "CL" ==
            # "cl") — PDB columns and guessed elements vary in case.
            values = [v.upper() for v in self._collect_values()]
            upper = np.asarray([str(e).upper() for e in top.elements])
            return self._match_strings(upper, values)

        raise ValueError(f"Unsupported selection keyword: {tok!r}")

    @staticmethod
    def _match_strings(column: np.ndarray, values: List[str]) -> np.ndarray:
        col = [str(v) for v in column]
        mask = np.zeros(len(col), dtype=bool)
        for val in values:
            if any(ch in val for ch in "*?["):
                mask |= np.asarray(
                    [fnmatch.fnmatchcase(c, val) for c in col], dtype=bool
                )
            else:
                mask |= np.asarray([c == val for c in col], dtype=bool)
        return mask

    @staticmethod
    def _match_ints(column: np.ndarray, values: List[str]) -> np.ndarray:
        col = np.asarray(column, dtype=np.int64)
        mask = np.zeros(len(col), dtype=bool)
        for val in values:
            m = re.fullmatch(r"(-?\d+)[:\-](-?\d+)", val)
            if m:
                lo, hi = int(m.group(1)), int(m.group(2))
                mask |= (col >= lo) & (col <= hi)
            else:
                mask |= col == int(val)
        return mask


def evaluate_selection(selection: str, topology: "Topology") -> np.ndarray:
    """Evaluate a selection string against a Topology; returns a bool mask."""
    tokens = _tokenize(selection)
    if not tokens:
        raise ValueError("Empty selection string")
    return _Parser(tokens, topology).parse()
