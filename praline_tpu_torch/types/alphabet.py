"""Alphabets: symbol <-> token-index mapping.

TPU-first design: an :class:`Alphabet` is a frozen value object whose only
runtime artifact is a 256-entry ``uint8 -> int32`` lookup table, so tokenizing
a sequence is a single vectorized numpy gather and every downstream container
is an integer array from the start (SURVEY.md C1; reference semantics
reconstructed — see SURVEY.md §0: reference mount is empty, parity is defined
against the pinned oracle).

Tokens are ``int32`` indices into ``alphabet.symbols``.  The gap is NOT an
alphabet symbol; gapped containers use :data:`GAP` (== -1) as the gap token so
profiles/score matrices never need a gap row.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

# Token used for a gap position in aligned (gapped) token matrices.
GAP: int = -1

# Characters accepted as gaps when tokenizing already-aligned input.
GAP_CHARS = ("-", ".")


@dataclasses.dataclass(frozen=True)
class Alphabet:
    """Immutable symbol set with ambiguity handling.

    ``symbols``   index -> canonical single-character symbol.
    ``aliases``   extra input characters mapped onto a canonical symbol
                  (e.g. ``U -> C`` selenocysteine -> cysteine).
    ``unknown``   canonical symbol that any unrecognized character maps to
                  when tokenizing with ``strict=False``.
    """

    name: str
    symbols: tuple[str, ...]
    aliases: dict[str, str] = dataclasses.field(default_factory=dict)
    unknown: str | None = None

    def __post_init__(self) -> None:
        if len(set(self.symbols)) != len(self.symbols):
            raise ValueError(f"duplicate symbols in alphabet {self.name!r}")
        for src, dst in self.aliases.items():
            if dst not in self.symbols:
                raise ValueError(f"alias target {dst!r} not in alphabet {self.name!r}")
        if self.unknown is not None and self.unknown not in self.symbols:
            raise ValueError(f"unknown symbol {self.unknown!r} not in alphabet")

    @property
    def size(self) -> int:
        return len(self.symbols)

    def __len__(self) -> int:
        return len(self.symbols)

    def index(self, symbol: str) -> int:
        try:
            return self.symbols.index(symbol)
        except ValueError:
            sym = self.aliases.get(symbol)
            if sym is not None:
                return self.symbols.index(sym)
            raise KeyError(f"symbol {symbol!r} not in alphabet {self.name!r}") from None

    @cached_property
    def _lut(self) -> np.ndarray:
        """256-entry char-code -> token table; -2 marks invalid, -1 marks gap."""
        lut = np.full(256, -2, dtype=np.int32)
        for i, s in enumerate(self.symbols):
            lut[ord(s)] = i
            lut[ord(s.lower())] = i
        for src, dst in self.aliases.items():
            idx = self.symbols.index(dst)
            lut[ord(src)] = idx
            lut[ord(src.lower())] = idx
        for g in GAP_CHARS:
            lut[ord(g)] = GAP
        return lut

    def tokenize(self, text: str, *, strict: bool = True, allow_gaps: bool = False) -> np.ndarray:
        """Map a string to an ``int32[L]`` token array.

        ``strict=False`` maps unrecognized characters to ``self.unknown``.
        ``allow_gaps=False`` rejects gap characters (ungapped sequence input);
        with ``allow_gaps=True`` they become :data:`GAP`.
        """
        raw = np.frombuffer(text.encode("ascii", errors="replace"), dtype=np.uint8)
        toks = self._lut[raw]
        bad = toks == -2
        if bad.any():
            if strict or self.unknown is None:
                pos = int(np.argmax(bad))
                raise ValueError(
                    f"invalid character {text[pos]!r} at position {pos} "
                    f"for alphabet {self.name!r}"
                )
            toks = np.where(bad, np.int32(self.index(self.unknown)), toks)
        if not allow_gaps and (toks == GAP).any():
            raise ValueError("gap character in ungapped sequence input")
        return toks.astype(np.int32, copy=False)

    def detokenize(self, tokens: np.ndarray, *, gap_char: str = "-") -> str:
        """Inverse of :meth:`tokenize`; :data:`GAP` renders as ``gap_char``."""
        out = []
        for t in np.asarray(tokens).tolist():
            out.append(gap_char if t == GAP else self.symbols[t])
        return "".join(out)


# Canonical protein alphabet: the 20 canonical residues in BLOSUM file order,
# plus the ambiguity codes B (N/D), Z (Q/E) and X (unknown). U (selenocysteine)
# and O (pyrrolysine) alias to C and K; J (I/L) aliases to L; '*' maps to X.
ALPHABET_AA = Alphabet(
    name="protein",
    symbols=tuple("ARNDCQEGHILKMFPSTWYVBZX"),
    aliases={"U": "C", "O": "K", "J": "L", "*": "X"},
    unknown="X",
)

# Nucleotide alphabet: ACGT plus N; common IUPAC ambiguity codes fold to N,
# U (RNA) aliases to T.
ALPHABET_DNA = Alphabet(
    name="dna",
    symbols=tuple("ACGTN"),
    aliases={"U": "T", **{c: "N" for c in "RYSWKMBDHV"}},
    unknown="N",
)

ALPHABETS = {a.name: a for a in (ALPHABET_AA, ALPHABET_DNA)}
