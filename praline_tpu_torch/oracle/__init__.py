"""NumPy oracle: the executable parity contract (SURVEY.md §0, §8).

Everything here is pure NumPy, deterministic, and defines the exact semantics
the kernels must reproduce bit-for-bit.  A copy of the JAX package's
``praline_tpu/oracle`` (score, align, profile, tree, merge, preprofile, msa):
the port's host stages and its ``backend="oracle"`` run this code.
"""

from .align import AlignResult, align_profiles, align_scores, align_tokens, align_tracksets
from .merge import full_coverage_path, inject_gaps, merge_alignments, progressive_merge
from .msa import all_pairs_scores, oracle_msa
from .preprofile import attach_preprofiles, build_preprofile, project_to_master
from .profile import member_profile, node_profile, rescale_counts
from .score import (
    NEG,
    column_inverses,
    gap_cost_prefix,
    pair_score_matrix,
    seq_score_matrix,
)
from .tree import build_guide_tree, similarity_from_scores

__all__ = [
    "NEG",
    "AlignResult",
    "align_profiles",
    "align_scores",
    "align_tokens",
    "align_tracksets",
    "all_pairs_scores",
    "attach_preprofiles",
    "build_guide_tree",
    "build_preprofile",
    "column_inverses",
    "full_coverage_path",
    "gap_cost_prefix",
    "inject_gaps",
    "member_profile",
    "merge_alignments",
    "node_profile",
    "oracle_msa",
    "pair_score_matrix",
    "progressive_merge",
    "project_to_master",
    "rescale_counts",
    "seq_score_matrix",
    "similarity_from_scores",
]
