"""Progressive merging: tree walk + gap injection (SURVEY.md C17, §4.4, §8.6).

At each internal node the two child alignments are merged by profile-profile
DP over their node profiles; the resulting path injects gap columns into
every member row of both children ("once a gap, always a gap" — child columns
are atomic).  Local/semiglobal merge paths are first extended to full column
coverage (canonical flank order: unmatched leading X columns, then leading Y,
matched region, trailing X, then trailing Y).
"""

from __future__ import annotations

import numpy as np

from ..types import GAP, Alignment, ScoreMatrix, SequenceTree, Sequence
from .align import AlignResult, align_scores
from .profile import node_profile
from .score import pair_score_matrix


def full_coverage_path(result: AlignResult, L1: int, L2: int) -> tuple[np.ndarray, np.ndarray]:
    """Extend a pairwise path to cover all L1 x-columns and L2 y-columns."""
    cx, cy = result.cols_x, result.cols_y
    x0, x1 = result.x_range
    y0, y1 = result.y_range
    lead_x = np.arange(0, x0, dtype=np.int32)
    lead_y = np.arange(0, y0, dtype=np.int32)
    tail_x = np.arange(x1, L1, dtype=np.int32)
    tail_y = np.arange(y1, L2, dtype=np.int32)
    g = lambda m: np.full(m, GAP, dtype=np.int32)
    cols_x = np.concatenate([lead_x, g(lead_y.size), cx, tail_x, g(tail_y.size)])
    cols_y = np.concatenate([g(lead_x.size), lead_y, cy, g(tail_x.size), tail_y])
    return cols_x.astype(np.int32), cols_y.astype(np.int32)


def inject_gaps(left_rows: np.ndarray, right_rows: np.ndarray, cols_x: np.ndarray, cols_y: np.ndarray) -> np.ndarray:
    """Merge two gapped row matrices along a full-coverage pairwise path."""
    nl, _ = left_rows.shape
    nr, _ = right_rows.shape
    C = cols_x.shape[0]
    out = np.full((nl + nr, C), GAP, dtype=np.int32)
    xm = cols_x != GAP
    ym = cols_y != GAP
    out[:nl, xm] = left_rows[:, cols_x[xm]]
    out[nl:, ym] = right_rows[:, cols_y[ym]]
    return out


def merge_alignments(
    left: Alignment,
    right: Alignment,
    matrix: ScoreMatrix,
    gap_series: tuple[int, ...],
    mode: str = "global",
) -> Alignment:
    """Profile-profile align two alignments and merge their rows."""
    pl = node_profile(left)
    pr = node_profile(right)
    result = align_scores(pair_score_matrix(pl, pr, matrix), gap_series, mode)
    cols_x, cols_y = full_coverage_path(result, left.num_columns, right.num_columns)
    rows = inject_gaps(left.rows, right.rows, cols_x, cols_y)
    return Alignment(left.members + right.members, rows)


def progressive_merge(
    sequences: list[Sequence],
    tree: SequenceTree,
    matrix: ScoreMatrix,
    gap_series: tuple[int, ...],
    mode: str = "global",
) -> Alignment:
    """Post-order tree walk producing the root MSA, rows in INPUT order
    (§8.6: emission record order = input order).

    Node profiles COMPOSE bottom-up along the merge paths
    (profile.compose_profiles — the pinned semantics shared with the
    batched pipeline and the on-device merge stage) rather than being
    recomputed from member rows at every node.
    """
    from .profile import compose_profiles

    nodes: dict[int, Alignment] = {
        i: Alignment.single(seq) for i, seq in enumerate(sequences)
    }
    profiles: dict[int, "object"] = {i: node_profile(nodes[i]) for i in nodes}
    n = tree.num_leaves
    for k, (l, r) in enumerate(tree.joins):
        left, right = nodes.pop(l), nodes.pop(r)
        pl, pr = profiles.pop(l), profiles.pop(r)
        result = align_scores(pair_score_matrix(pl, pr, matrix), gap_series, mode)
        cols_x, cols_y = full_coverage_path(result, left.num_columns, right.num_columns)
        rows = inject_gaps(left.rows, right.rows, cols_x, cols_y)
        nodes[n + k] = Alignment(left.members + right.members, rows)
        profiles[n + k] = compose_profiles(
            pl, pr, left.num_members, right.num_members, cols_x, cols_y
        )
    return reorder_to_input(nodes[tree.root], sequences)


def reorder_to_input(root: Alignment, sequences) -> Alignment:
    """Root alignment rows permuted back to input order (§8.6: record
    order = input order).  Matches members by identity first (sequences
    flow through the walk unchanged), then by name as a fallback for
    reconstructed members.  Shared by the oracle walk, the per-level
    batched merge and the device-resident merge."""
    index_of = {id(m): k for k, m in enumerate(root.members)}
    perm = []
    used = set()
    for seq in sequences:
        k = index_of.get(id(seq))
        if k is None:
            k = next(
                i
                for i, m in enumerate(root.members)
                if i not in used and m.name == seq.name
            )
        used.add(k)
        perm.append(k)
    members = tuple(root.members[k] for k in perm)
    return Alignment(members, root.rows[perm])
