"""Pinned score model (SURVEY.md §8.1) — the bit-parity arithmetic contract.

A profile column is a vector of integer residue COUNTS ``c`` (float32-held)
plus a gap count.  The column-pair score is the frequency-weighted sum over
the substitution matrix::

    score(c1, c2) = f1^T S f2,   f = c / max(1, sum(c))

To make this bit-identical between the NumPy oracle, the XLA kernel and the
Pallas kernel regardless of summation order, the arithmetic is pinned as:

1. ``D = c1^T S c2`` computed exactly.  All operands are small integers, so
   every partial sum is an exactly-representable float32 integer as long as
   ``n1 * n2 * max|S| < 2**24`` — and exact arithmetic is order-independent,
   which is what buys us MXU-matmul == numpy-dot equality (SURVEY.md §9 hard
   part 6).  On TPU the matmuls must run with ``Precision.HIGHEST`` so the
   bf16 passes cover >8-bit integer operands exactly.
2. ``score = (D * inv1) * inv2`` in float32, with ``inv = 1/max(1, n)``
   computed by a single float32 division (correctly rounded IEEE on host;
   kernels receive ``inv`` precomputed so they never divide).

A sequence is the one-hot profile of its tokens, for which this reduces to
``S[a, b]`` exactly — one kernel path serves seq-seq, seq-profile and
profile-profile alignment.
"""

from __future__ import annotations

import numpy as np

from ..types import Profile, ScoreMatrix

# Finite "minus infinity" for DP cells: large enough to dominate every real
# score, small enough that a few additions never overflow float32.
NEG = np.float32(-1.0e30)

# Exactness bound for the integer count-space dot product (see module doc).
EXACT_DOT_LIMIT = float(2**24)


def column_inverses(profile: Profile) -> np.ndarray:
    """float32 ``1 / max(1, total_count)`` per column, single f32 division."""
    totals = np.maximum(profile.counts.sum(axis=1, dtype=np.float32), np.float32(1.0))
    return (np.float32(1.0) / totals).astype(np.float32)


def check_exactness(px: Profile, py: Profile, matrix: ScoreMatrix) -> None:
    nx = float(px.counts.sum(axis=1).max(initial=0.0))
    ny = float(py.counts.sum(axis=1).max(initial=0.0))
    max_s = float(np.abs(matrix.scores).max())
    if nx * ny * max_s >= EXACT_DOT_LIMIT:
        raise ValueError(
            f"profile counts too large for exact f32 scoring "
            f"({nx} * {ny} * {max_s} >= 2**24); reduce member counts or add "
            f"a float64 scoring path"
        )


def pair_score_matrix(px: Profile, py: Profile, matrix: ScoreMatrix) -> np.ndarray:
    """Full ``float32[L1, L2]`` column-pair score matrix, pinned arithmetic."""
    check_exactness(px, py, matrix)
    s = matrix.as_f32()
    # Exact integer-valued contractions (order-independent because exact).
    d = (px.counts @ s @ py.counts.T).astype(np.float32)
    inv_x = column_inverses(px)
    inv_y = column_inverses(py)
    # Pinned order: (D * inv_x) * inv_y.
    return ((d * inv_x[:, None]) * inv_y[None, :]).astype(np.float32)


def composite_pair_score_matrix(
    tracks_x: "list[Profile] | tuple[Profile, ...]",
    tracks_y: "list[Profile] | tuple[Profile, ...]",
    matrices: "list[ScoreMatrix] | tuple[ScoreMatrix, ...]",
    weights: "list[float] | tuple[float, ...]",
) -> np.ndarray:
    """Multi-track composite column scores (SURVEY.md C4, §8.1):

        h = sum_t  w_t * (f1_t^T S_t f2_t)

    The reference's composite score function combines one matrix per track
    with a weight (e.g. amino-acid + secondary-structure tracks).  Pinned
    arithmetic: each track's score matrix is computed exactly as
    :func:`pair_score_matrix`, then terms accumulate IN TRACK ORDER as
    ``acc = acc + w_t * h_t`` with float32 rounding at every step — the
    device path (kernels.scores.composite_skewed_scores) accumulates in
    the same order, so results stay bit-identical.

    All x tracks must share one length, likewise y tracks (they are
    parallel annotations of the same columns).
    """
    if not (len(tracks_x) == len(tracks_y) == len(matrices) == len(weights)):
        raise ValueError("tracks_x, tracks_y, matrices, weights must align")
    if not tracks_x:
        raise ValueError("need at least one track")
    L1 = tracks_x[0].length
    L2 = tracks_y[0].length
    if any(p.length != L1 for p in tracks_x) or any(p.length != L2 for p in tracks_y):
        raise ValueError("parallel tracks must have equal lengths per side")
    acc = np.zeros((L1, L2), dtype=np.float32)
    for px, py, s, w in zip(tracks_x, tracks_y, matrices, weights):
        acc = acc + np.float32(w) * pair_score_matrix(px, py, s)
    return acc


def seq_score_matrix(x_tokens: np.ndarray, y_tokens: np.ndarray, matrix: ScoreMatrix) -> np.ndarray:
    """Seq-seq special case: ``S[x_i, y_j]`` as float32 (exactly integral)."""
    return matrix.as_f32()[np.asarray(x_tokens)[:, None], np.asarray(y_tokens)[None, :]]


def gap_cost_prefix(gap_series: tuple[int, ...], length: int) -> np.ndarray:
    """``cum[m]`` = cost of m consecutive gap columns (SURVEY.md §8.2):
    the m-th gap column costs ``gap_series[min(m, k) - 1]``."""
    g = np.asarray(gap_series, dtype=np.float32)
    k = len(gap_series)
    idx = np.minimum(np.arange(1, length + 1), k) - 1
    cum = np.zeros(length + 1, dtype=np.float32)
    if length:
        cum[1:] = np.cumsum(g[idx], dtype=np.float32)
    return cum
