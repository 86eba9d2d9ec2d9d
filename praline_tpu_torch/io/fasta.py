"""FASTA reading and byte-stable emission (SURVEY.md C19, §8.6).

Emission format is part of the parity contract: ``>`` + original id line,
sequence wrapped at ``wrap`` (default 60) characters, gap char ``-``, record
order = input order, ``\\n`` line endings, trailing newline after the last
record.  Golden e2e tests assert byte equality of this emission.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Iterator, TextIO

import numpy as np

from ..types import GAP, Alignment, Alphabet, Sequence


def iter_fasta(text: str) -> Iterator[tuple[str, str]]:
    """Yield ``(header, sequence_text)`` records from FASTA text."""
    header: str | None = None
    chunks: list[str] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith(">"):
            if header is not None:
                yield header, "".join(chunks)
            header = line[1:].strip()
            chunks = []
        else:
            if header is None:
                raise ValueError("FASTA data before first '>' header")
            chunks.append(line)
    if header is not None:
        yield header, "".join(chunks)


def load_sequence_fasta(
    path: str | Path | TextIO,
    alphabet: Alphabet,
    *,
    strict: bool = False,
) -> list[Sequence]:
    """Read ungapped sequences; unknown residues map to the alphabet's
    unknown symbol unless ``strict``."""
    text = path.read() if hasattr(path, "read") else Path(path).read_text()
    seqs = []
    for header, body in iter_fasta(text):
        body = body.replace("-", "").replace(".", "")  # tolerate pre-gapped input
        seqs.append(Sequence(header, alphabet.tokenize(body, strict=strict), alphabet))
    if not seqs:
        raise ValueError("no FASTA records found")
    return seqs


def _wrap(text: str, width: int) -> Iterable[str]:
    for i in range(0, len(text), width):
        yield text[i : i + width]


def format_alignment_fasta(alignment: Alignment, *, wrap: int = 60) -> str:
    """Canonical FASTA emission of an alignment (§8.6)."""
    alphabet = alignment.alphabet
    out: list[str] = []
    for k, member in enumerate(alignment.members):
        out.append(f">{member.name}")
        row = alphabet.detokenize(alignment.rows[k])
        out.extend(_wrap(row, wrap))
    return "\n".join(out) + "\n"


def format_sequences_fasta(seqs: Iterable[Sequence], *, wrap: int = 60) -> str:
    out: list[str] = []
    for s in seqs:
        out.append(f">{s.name}")
        out.extend(_wrap(s.text(), wrap))
    return "\n".join(out) + "\n"


def write_alignment_fasta(
    alignment: Alignment, path: str | Path | TextIO, *, wrap: int = 60
) -> None:
    text = format_alignment_fasta(alignment, wrap=wrap)
    if hasattr(path, "write"):
        path.write(text)
    else:
        Path(path).write_text(text)


def alignment_from_gapped_texts(
    records: list[tuple[str, str]], alphabet: Alphabet
) -> Alignment:
    """Build an :class:`Alignment` from (name, gapped text) records."""
    rows = []
    members = []
    for name, text in records:
        toks = alphabet.tokenize(text, strict=False, allow_gaps=True)
        rows.append(toks)
        members.append(Sequence(name, toks[toks != GAP], alphabet))
    mat = np.stack(rows).astype(np.int32)
    return Alignment(tuple(members), mat)


def load_alignment_fasta(path: str | Path | TextIO, alphabet: Alphabet) -> Alignment:
    text = path.read() if hasattr(path, "read") else Path(path).read_text()
    return alignment_from_gapped_texts(list(iter_fasta(text)), alphabet)
