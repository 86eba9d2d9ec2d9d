"""I/O layer: FASTA/CLUSTAL parse + byte-stable emission, matrix files.

A copy of the JAX package's ``praline_tpu/io``; matrices load from
``praline_tpu_torch/data/matrices``.
"""

from .clustal import (
    format_alignment_clustal,
    load_alignment_clustal,
    parse_alignment_clustal,
    write_alignment_clustal,
)
from .fasta import (
    alignment_from_gapped_texts,
    format_alignment_fasta,
    format_sequences_fasta,
    iter_fasta,
    load_alignment_fasta,
    load_sequence_fasta,
    write_alignment_fasta,
)
from .matrixfile import (
    BUILTIN_MATRICES,
    builtin_score_matrix,
    load_score_matrix,
    parse_score_matrix,
    resolve_score_matrix,
)

__all__ = [
    "BUILTIN_MATRICES",
    "alignment_from_gapped_texts",
    "builtin_score_matrix",
    "format_alignment_clustal",
    "format_alignment_fasta",
    "format_sequences_fasta",
    "iter_fasta",
    "load_alignment_clustal",
    "load_alignment_fasta",
    "load_score_matrix",
    "load_sequence_fasta",
    "parse_alignment_clustal",
    "parse_score_matrix",
    "resolve_score_matrix",
    "write_alignment_clustal",
    "write_alignment_fasta",
]
