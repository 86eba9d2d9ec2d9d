"""Array-first data containers.

These replace the reference's pure-Python object model (SURVEY.md C2/C3/C4/C5:
``Sequence``+tracks, ``Alignment``, ``ScoreMatrix``, ``SequenceTree``) with
numpy-array-backed values that move onto a TPU without conversion:

* a sequence is its ``int32[L]`` token track (plus optional profile tracks),
* an alignment is an ``int32[n, C]`` gapped token matrix (gap == -1),
* a profile is an ``float32[L, A]`` integer-valued residue-count matrix plus a
  ``float32[L]`` gap-count vector,
* a score matrix is an ``int32[A, A]`` array.

Profiles store raw COUNTS, not frequencies (SURVEY.md §8.1).  All scoring
normalizes with precomputed float32 reciprocals so kernel and oracle share
bit-exact arithmetic (see praline_tpu.oracle.score).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .alphabet import GAP, Alphabet

# Track ids mirror the reference's track concept (SURVEY.md C2).
TRACK_ID_INPUT = "input"
TRACK_ID_PREPROFILE = "preprofile"


@dataclasses.dataclass(frozen=True)
class Profile:
    """Position-specific residue counts: ``counts[L, A]`` + ``gaps[L]``.

    ``counts`` is float32 but always holds exact small integers so that
    count-space matmuls on the MXU are exact and therefore order-independent
    (the bit-parity trick pinned in SURVEY.md §9 hard-part 6).
    """

    counts: np.ndarray  # float32[L, A], integer-valued
    gaps: np.ndarray  # float32[L], integer-valued
    alphabet: Alphabet

    def __post_init__(self) -> None:
        c = np.asarray(self.counts, dtype=np.float32)
        g = np.asarray(self.gaps, dtype=np.float32)
        if c.ndim != 2 or c.shape[1] != self.alphabet.size:
            raise ValueError(f"bad profile counts shape {c.shape}")
        if g.shape != (c.shape[0],):
            raise ValueError(f"bad profile gaps shape {g.shape}")
        object.__setattr__(self, "counts", c)
        object.__setattr__(self, "gaps", g)

    @property
    def length(self) -> int:
        return self.counts.shape[0]

    def __len__(self) -> int:
        return self.length

    @staticmethod
    def from_tokens(tokens: np.ndarray, alphabet: Alphabet) -> "Profile":
        """One-hot profile of a single ungapped token sequence."""
        toks = np.asarray(tokens)
        L = toks.shape[0]
        counts = np.zeros((L, alphabet.size), dtype=np.float32)
        counts[np.arange(L), toks] = 1.0
        return Profile(counts, np.zeros(L, dtype=np.float32), alphabet)


@dataclasses.dataclass(frozen=True)
class Sequence:
    """A named sequence with parallel tracks keyed by track id.

    The symbol track (``TRACK_ID_INPUT``) is an ``int32[L]`` token array;
    profile tracks (e.g. ``TRACK_ID_PREPROFILE``) are :class:`Profile`s of the
    same length.  Mirrors the reference's Sequence/PlainTrack/ProfileTrack
    model (SURVEY.md C2) without the class hierarchy.
    """

    name: str
    tokens: np.ndarray  # int32[L], ungapped
    alphabet: Alphabet
    profiles: dict[str, Profile] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        toks = np.asarray(self.tokens, dtype=np.int32)
        if toks.ndim != 1:
            raise ValueError("sequence tokens must be 1-D")
        if toks.size and (toks.min() < 0 or toks.max() >= self.alphabet.size):
            raise ValueError("sequence tokens out of alphabet range (gaps not allowed)")
        object.__setattr__(self, "tokens", toks)
        for tid, prof in self.profiles.items():
            if prof.length != toks.shape[0]:
                raise ValueError(f"profile track {tid!r} length mismatch")

    @property
    def length(self) -> int:
        return int(self.tokens.shape[0])

    def __len__(self) -> int:
        return self.length

    @staticmethod
    def from_str(name: str, text: str, alphabet: Alphabet, *, strict: bool = False) -> "Sequence":
        return Sequence(name, alphabet.tokenize(text, strict=strict), alphabet)

    def text(self) -> str:
        return self.alphabet.detokenize(self.tokens)

    def with_profile(self, track_id: str, profile: Profile) -> "Sequence":
        profs = dict(self.profiles)
        profs[track_id] = profile
        return dataclasses.replace(self, profiles=profs)

    def one_hot_profile(self) -> Profile:
        return Profile.from_tokens(self.tokens, self.alphabet)


@dataclasses.dataclass(frozen=True)
class Alignment:
    """An MSA: member sequences + one gapped token row per member.

    ``rows`` is ``int32[n_members, n_cols]`` with :data:`GAP` (-1) marking
    gaps; row *k* with gaps removed equals ``members[k].tokens`` exactly.
    Replaces the reference Alignment container (SURVEY.md C3); merge support
    lives in praline_tpu.oracle.merge as pure functions over ``rows``.
    """

    members: tuple[Sequence, ...]
    rows: np.ndarray  # int32[n, C]

    def __post_init__(self) -> None:
        rows = np.asarray(self.rows, dtype=np.int32)
        if rows.ndim != 2 or rows.shape[0] != len(self.members):
            raise ValueError(f"bad alignment rows shape {rows.shape}")
        object.__setattr__(self, "rows", rows)
        for k, member in enumerate(self.members):
            ungapped = rows[k][rows[k] != GAP]
            if not np.array_equal(ungapped, member.tokens):
                raise ValueError(f"alignment row {k} does not match member {member.name!r}")

    @property
    def num_members(self) -> int:
        return len(self.members)

    @property
    def num_columns(self) -> int:
        return int(self.rows.shape[1])

    @property
    def alphabet(self) -> Alphabet:
        return self.members[0].alphabet

    @staticmethod
    def single(seq: Sequence) -> "Alignment":
        return Alignment((seq,), seq.tokens[None, :])

    def column(self, c: int) -> np.ndarray:
        return self.rows[:, c]

    def profile(self) -> Profile:
        """Per-column residue counts + gap counts (SURVEY.md C12, §8.1)."""
        return alignment_profile(self.rows, self.alphabet)


def alignment_profile(rows: np.ndarray, alphabet: Alphabet) -> Profile:
    """Profile of a gapped token matrix ``int32[n, C]`` (counts + gaps)."""
    rows = np.asarray(rows, dtype=np.int32)
    A = alphabet.size
    C = rows.shape[1]
    valid = rows != GAP
    cols = np.broadcast_to(np.arange(C, dtype=np.int64), rows.shape)
    flat = cols[valid] * A + rows[valid]
    counts = np.bincount(flat, minlength=C * A).reshape(C, A).astype(np.float32)
    gaps = (~valid).sum(axis=0).astype(np.float32)
    return Profile(counts, gaps, alphabet)


@dataclasses.dataclass(frozen=True)
class ScoreMatrix:
    """Substitution matrix over an alphabet: ``int32[A, A]`` (SURVEY.md C4)."""

    name: str
    scores: np.ndarray  # int32[A, A]
    alphabet: Alphabet

    def __post_init__(self) -> None:
        s = np.asarray(self.scores, dtype=np.int32)
        A = self.alphabet.size
        if s.shape != (A, A):
            raise ValueError(f"score matrix shape {s.shape} != ({A}, {A})")
        object.__setattr__(self, "scores", s)

    def score(self, a: int, b: int) -> int:
        return int(self.scores[a, b])

    def as_f32(self) -> np.ndarray:
        return self.scores.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class SequenceTree:
    """Binary guide tree over leaf indices 0..n-1 (SURVEY.md C5).

    Stored as a merge list: ``joins[k] = (left, right)`` creates internal node
    ``n + k``; node ids < n are leaves.  ``joins`` order IS the join order
    produced by the tree construction, so a post-order walk is simply iteration.
    """

    num_leaves: int
    joins: tuple[tuple[int, int], ...]

    def __post_init__(self) -> None:
        if self.num_leaves < 1:
            raise ValueError("tree needs at least one leaf")
        if len(self.joins) != max(0, self.num_leaves - 1):
            raise ValueError("a binary tree over n leaves has exactly n-1 joins")
        seen = set()
        for k, (l, r) in enumerate(self.joins):
            limit = self.num_leaves + k
            if not (0 <= l < limit and 0 <= r < limit):
                raise ValueError(f"join {k} references unknown node")
            if l in seen or r in seen or l == r:
                raise ValueError(f"join {k} reuses a node")
            seen.add(l)
            seen.add(r)

    @property
    def root(self) -> int:
        return self.num_leaves + len(self.joins) - 1

    def newick(self, names: list[str] | None = None) -> str:
        n = self.num_leaves

        def label(i: int) -> str:
            text = names[i] if names else str(i)
            # Newick spec: labels containing structural characters or
            # whitespace must be single-quoted, internal quotes doubled
            # (real FASTA headers routinely contain (),:; and spaces).
            if any(c in "()[]{},;:='\"\t\n " for c in text):
                return "'" + text.replace("'", "''") + "'"
            return text

        rendered: dict[int, str] = {i: label(i) for i in range(n)}
        for k, (l, r) in enumerate(self.joins):
            rendered[n + k] = f"({rendered[l]},{rendered[r]})"
        return rendered[self.root] + ";"
