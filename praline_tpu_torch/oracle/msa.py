"""End-to-end oracle MSA workflow (SURVEY.md C15/C18, §4.1).

Pure NumPy pipeline: preprofiles -> all-pairs similarity -> guide tree ->
progressive merge.  This is the correctness anchor the TPU pipeline
(praline_tpu.msa) must reproduce column-identically; it doubles as a slow CPU
backend for small problems.
"""

from __future__ import annotations

import numpy as np

from ..types import Alignment, PralineConfig, ScoreMatrix, Sequence
from .align import align_profiles
from .merge import progressive_merge
from .preprofile import attach_preprofiles
from .profile import member_profile
from .tree import build_guide_tree, similarity_from_scores


def all_pairs_scores(
    sequences: list[Sequence],
    matrix: ScoreMatrix,
    gap_series: tuple[int, ...],
    mode: str,
) -> tuple[np.ndarray, np.ndarray]:
    """N x N pairwise (score, alignment-length) matrices over preprofile
    tracks (one-hot when absent).  The serial O(N^2) reference of the batched
    TPU all-pairs stage (SURVEY.md C15)."""
    n = len(sequences)
    profiles = [member_profile(s) for s in sequences]
    scores = np.zeros((n, n), dtype=np.float64)
    lengths = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        lengths[i, i] = max(1, sequences[i].length)
        for j in range(i + 1, n):
            res = align_profiles(profiles[i], profiles[j], matrix, gap_series, mode)
            scores[i, j] = scores[j, i] = res.score
            lengths[i, j] = lengths[j, i] = res.length
    return scores, lengths


def oracle_msa(
    sequences: list[Sequence],
    matrix: ScoreMatrix,
    config: PralineConfig,
    extra_slaves: dict[int, list[Sequence]] | None = None,
    on_tree=None,
) -> Alignment:
    """Full PRALINE recipe, oracle semantics (§4.1)."""
    if not sequences:
        raise ValueError("no sequences")
    if len(sequences) == 1:
        return Alignment.single(sequences[0])

    seqs = attach_preprofiles(
        sequences,
        matrix,
        config.effective_preprofile_gap_series,
        config.preprofile_mode,
        extra_slaves=extra_slaves,
    )
    scores, lengths = all_pairs_scores(
        seqs, matrix, config.gap_series, config.distance_mode
    )
    sim = similarity_from_scores(scores, lengths, config.score_normalization)
    tree = build_guide_tree(sim, config.linkage)
    if on_tree is not None:
        on_tree(tree)
    return progressive_merge(seqs, tree, matrix, config.gap_series, config.merge_mode)
