"""CLUSTAL-style alignment emission (SURVEY.md C19; §8.6 secondary format).

Canonical choices (pinned here for byte-stable goldens): header line
``CLUSTAL multiple sequence alignment (praline-tpu)``, blank line, 60-column
blocks separated by blank lines, names left-justified to the longest name
(minimum 10) plus two spaces, and a conservation line marking fully conserved
residue columns with ``*`` (the ``:``/``.`` similarity tiers are not emitted).
"""

from __future__ import annotations

from pathlib import Path
from typing import TextIO

import numpy as np

from ..types import GAP, Alignment

HEADER = "CLUSTAL multiple sequence alignment (praline-tpu)"
BLOCK = 60


def format_alignment_clustal(alignment: Alignment) -> str:
    alphabet = alignment.alphabet
    names = [m.name.split()[0] if m.name else f"seq{i}" for i, m in enumerate(alignment.members)]
    width = max(10, max((len(n) for n in names), default=10))
    rows = [alphabet.detokenize(alignment.rows[k]) for k in range(alignment.num_members)]
    C = alignment.num_columns

    tok = alignment.rows
    conserved = np.logical_and(
        (tok == tok[0:1]).all(axis=0), tok[0] != GAP
    ) if alignment.num_members else np.zeros(C, bool)

    out = [HEADER, ""]
    for start in range(0, C, BLOCK):
        stop = min(start + BLOCK, C)
        for name, row in zip(names, rows):
            out.append(f"{name:<{width}}  {row[start:stop]}")
        marks = "".join("*" if conserved[c] else " " for c in range(start, stop))
        out.append(f"{'':<{width}}  {marks}".rstrip())
        out.append("")
    return "\n".join(out).rstrip("\n") + "\n"


def write_alignment_clustal(alignment: Alignment, path: str | Path | TextIO) -> None:
    text = format_alignment_clustal(alignment)
    if hasattr(path, "write"):
        path.write(text)
    else:
        Path(path).write_text(text)


def parse_alignment_clustal(text: str, alphabet) -> "object":
    """Parse a CLUSTAL-format alignment (header line, blocks of
    ``name  chunk`` rows, optional conservation lines) back into an
    :class:`~praline_tpu.types.Alignment`."""
    from .fasta import alignment_from_gapped_texts

    lines = text.splitlines()
    if not lines or not lines[0].upper().startswith("CLUSTAL"):
        raise ValueError("not a CLUSTAL file (missing header)")
    chunks: dict[str, list[str]] = {}
    order: list[str] = []
    allowed = (
        set(alphabet.symbols)
        | {x.lower() for x in alphabet.symbols}
        | set("-.")
        | set(alphabet.aliases)
        | {a.lower() for a in alphabet.aliases}
    )
    for raw in lines[1:]:
        if not raw.strip():
            continue
        parts = raw.split()
        # conservation lines contain only *:. and spaces; data rows start
        # with a name that is not purely conservation markers
        if set(parts[0]) <= set("*:."):
            continue
        if len(parts) < 2:
            continue
        # a data row is ``name  chunk [chunk ...]`` with an optional trailing
        # cumulative residue-count column (clustalw -SEQNOS style); raise on
        # anything else rather than silently truncating the row
        name, fields = parts[0], parts[1:]
        if len(fields) > 1 and fields[-1].isdigit():
            fields = fields[:-1]
        seq = "".join(fields)
        bad = set(seq) - allowed
        if bad:
            raise ValueError(
                f"unrecognized residue characters {''.join(sorted(bad))!r} "
                f"in CLUSTAL row {name!r}"
            )
        if name not in chunks:
            chunks[name] = []
            order.append(name)
        chunks[name].append(seq)
    if not order:
        raise ValueError("no sequence rows found in CLUSTAL file")
    records = [(name, "".join(chunks[name])) for name in order]
    return alignment_from_gapped_texts(records, alphabet)


def load_alignment_clustal(path, alphabet):
    from pathlib import Path

    text = path.read() if hasattr(path, "read") else Path(path).read_text()
    return parse_alignment_clustal(text, alphabet)
