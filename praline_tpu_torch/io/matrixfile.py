"""Substitution-matrix file parsing + packaged-matrix access.

Reads the standard NCBI/EMBOSS text format (``#`` comments, a header row of
column symbols, then one row per symbol) and projects it onto one of our
alphabets; symbols present in the file but absent from the alphabet (``*``)
are ignored.  Replaces the reference's matrix loader + packaged data files
(SURVEY.md C20, L0).
"""

from __future__ import annotations

import importlib.resources
from pathlib import Path

import numpy as np

from ..types import ALPHABET_AA, ALPHABET_DNA, Alphabet, ScoreMatrix

_DATA_PACKAGE = "praline_tpu_torch.data.matrices"

# Packaged matrix name -> (resource file, alphabet).
BUILTIN_MATRICES: dict[str, tuple[str, Alphabet]] = {
    "blosum45": ("blosum45.txt", ALPHABET_AA),
    "blosum50": ("blosum50.txt", ALPHABET_AA),
    "blosum62": ("blosum62.txt", ALPHABET_AA),
    "blosum80": ("blosum80.txt", ALPHABET_AA),
    "pam30": ("pam30.txt", ALPHABET_AA),
    "pam70": ("pam70.txt", ALPHABET_AA),
    "pam120": ("pam120.txt", ALPHABET_AA),
    "pam250": ("pam250.txt", ALPHABET_AA),
    "dna_simple": ("dna_simple.txt", ALPHABET_DNA),
}


def parse_score_matrix(text: str, alphabet: Alphabet, *, name: str = "custom") -> ScoreMatrix:
    """Parse NCBI-format matrix text into a :class:`ScoreMatrix`."""
    lines = [ln for ln in text.splitlines() if ln.strip() and not ln.lstrip().startswith("#")]
    if not lines:
        raise ValueError("empty score matrix file")
    col_syms = lines[0].split()
    table: dict[tuple[str, str], int] = {}
    for ln in lines[1:]:
        parts = ln.split()
        row_sym, values = parts[0], parts[1:]
        if len(values) != len(col_syms):
            raise ValueError(f"row {row_sym!r} has {len(values)} values, expected {len(col_syms)}")
        for c_sym, v in zip(col_syms, values):
            table[(row_sym.upper(), c_sym.upper())] = int(v)

    A = alphabet.size
    scores = np.zeros((A, A), dtype=np.int32)
    for i, a in enumerate(alphabet.symbols):
        for j, b in enumerate(alphabet.symbols):
            try:
                scores[i, j] = table[(a, b)]
            except KeyError:
                raise ValueError(
                    f"matrix is missing pair ({a!r}, {b!r}) required by alphabet "
                    f"{alphabet.name!r}"
                ) from None
    return ScoreMatrix(name, scores, alphabet)


def load_score_matrix(path: str | Path, alphabet: Alphabet) -> ScoreMatrix:
    """Load a matrix from a user-supplied file."""
    p = Path(path)
    return parse_score_matrix(p.read_text(), alphabet, name=p.stem)


def builtin_score_matrix(name: str) -> ScoreMatrix:
    """Load one of the packaged matrices by name (e.g. ``"blosum62"``)."""
    key = name.lower()
    if key not in BUILTIN_MATRICES:
        raise KeyError(f"unknown builtin matrix {name!r}; have {sorted(BUILTIN_MATRICES)}")
    resource, alphabet = BUILTIN_MATRICES[key]
    text = importlib.resources.files(_DATA_PACKAGE).joinpath(resource).read_text()
    return parse_score_matrix(text, alphabet, name=key)


def resolve_score_matrix(name_or_path: str, alphabet: Alphabet | None = None) -> ScoreMatrix:
    """Builtin name first, else treat as a filesystem path."""
    if name_or_path.lower() in BUILTIN_MATRICES:
        m = builtin_score_matrix(name_or_path)
        if alphabet is not None and m.alphabet is not alphabet:
            raise ValueError(
                f"builtin matrix {name_or_path!r} is for alphabet {m.alphabet.name!r}, "
                f"not {alphabet.name!r}"
            )
        return m
    if alphabet is None:
        raise ValueError("alphabet required when loading a matrix from a path")
    return load_score_matrix(name_or_path, alphabet)
