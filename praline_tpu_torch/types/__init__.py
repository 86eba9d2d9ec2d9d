"""Array-first data model: alphabets, sequences, profiles, alignments, trees.

A copy of the JAX package's ``praline_tpu/types`` (plain numpy), kept here
because the port imports nothing of that package.
"""

from .alphabet import ALPHABET_AA, ALPHABET_DNA, ALPHABETS, GAP, Alphabet
from .config import PralineConfig
from .containers import (
    TRACK_ID_INPUT,
    TRACK_ID_PREPROFILE,
    Alignment,
    Profile,
    ScoreMatrix,
    Sequence,
    SequenceTree,
    alignment_profile,
)

__all__ = [
    "ALPHABET_AA",
    "ALPHABET_DNA",
    "ALPHABETS",
    "GAP",
    "Alphabet",
    "Alignment",
    "PralineConfig",
    "Profile",
    "ScoreMatrix",
    "Sequence",
    "SequenceTree",
    "TRACK_ID_INPUT",
    "TRACK_ID_PREPROFILE",
    "alignment_profile",
]
