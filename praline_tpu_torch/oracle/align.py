"""NumPy oracle for the affine/gap-series pairwise DP (SURVEY.md §8, §4.2).

This module IS the executable parity contract (SURVEY.md §0): the XLA and
Pallas kernels and the C++ reference kernel must reproduce its scores and
traceback paths bit-exactly.  It is deliberately written as a clear per-cell
loop; the fast paths live in ``praline_tpu.kernels``.

Pinned semantics (canonical choices documented in SURVEY.md §8):

* Gap-penalty series ``G = (g1..gk)``: the m-th consecutive gap column costs
  ``G[min(m, k) - 1]``; ``k == 2`` is classic affine Gotoh with open ``g1``
  and extend ``g2`` (first gap column costs ``g1``).
* States: ``M`` plus per-direction level states ``Ix_l`` / ``Iy_l``
  (``Ix`` = gap in y, consuming x; ``Iy`` symmetric).  Gap states enter only
  from ``M`` or from a same-direction gap state — no direct ``Ix <-> Iy``
  transitions.
* Tie-breaks (§8.4): state preference ``M > Ix > Iy`` everywhere, lower gap
  level first within a direction; at the generalized level-k state the
  level-(k-1) predecessor is preferred over staying at level k.
* Modes (§8.3):
  - ``global``: borders carry cumulative gap cost; terminal ``(L1, L2)``.
  - ``semiglobal``: zero-cost leading gaps (zero borders, run levels still
    advance) and free trailing gaps; terminal = best cell on last row or
    last column, ties -> larger i, then larger j.
  - ``local``: ``M`` clamped at 0; terminal = argmax over ``M`` with ties ->
    smallest i then smallest j; traceback stops at the first 0-score M cell.
* ``length`` of a result = number of emitted alignment columns (for
  semiglobal this includes the free leading/trailing gap columns); used by
  guide-tree score normalization (§8.4).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..types import GAP, Profile, ScoreMatrix
from .score import NEG, gap_cost_prefix, pair_score_matrix

# ptrM encoding: 0 -> M, 1..k -> Ix level, k+1..2k -> Iy level, 255 -> none.
_PTR_NONE = 255


@dataclasses.dataclass(frozen=True)
class AlignResult:
    """A pairwise alignment path.

    ``cols_x[c]`` / ``cols_y[c]`` hold 0-based token indices or :data:`GAP`
    for each emitted column.  For ``local`` mode only the matched segment is
    emitted and ``x_range`` / ``y_range`` give its half-open spans; global
    and semiglobal cover both inputs fully.
    """

    score: float
    cols_x: np.ndarray  # int32[C]
    cols_y: np.ndarray  # int32[C]
    x_range: tuple[int, int]
    y_range: tuple[int, int]
    mode: str

    @property
    def length(self) -> int:
        return int(self.cols_x.shape[0])


def _empty_result(mode: str, score: float = 0.0) -> AlignResult:
    z = np.zeros(0, dtype=np.int32)
    return AlignResult(float(score), z, z, (0, 0), (0, 0), mode)


def align_scores(
    h: np.ndarray,
    gap_series: tuple[int, ...],
    mode: str,
) -> AlignResult:
    """Run the pinned DP over a precomputed score matrix ``h[L1, L2]``."""
    if mode not in ("global", "semiglobal", "local"):
        raise ValueError(f"unknown mode {mode!r}")
    h = np.asarray(h, dtype=np.float32)
    L1, L2 = h.shape
    k = len(gap_series)
    g = np.asarray(gap_series, dtype=np.float32)

    if L1 == 0 or L2 == 0:
        return _degenerate(L1, L2, gap_series, mode)

    M = np.full((L1 + 1, L2 + 1), NEG, dtype=np.float32)
    IX = np.full((k, L1 + 1, L2 + 1), NEG, dtype=np.float32)
    IY = np.full((k, L1 + 1, L2 + 1), NEG, dtype=np.float32)
    ptrM = np.full((L1 + 1, L2 + 1), _PTR_NONE, dtype=np.uint8)
    # Level-k (or the k==1 single-level) states have a binary choice:
    # 0 = enter from the lower level (M when k == 1), 1 = stay at level k.
    ptrIXk = np.zeros((L1 + 1, L2 + 1), dtype=np.uint8)
    ptrIYk = np.zeros((L1 + 1, L2 + 1), dtype=np.uint8)

    M[0, 0] = 0.0
    cum1 = gap_cost_prefix(gap_series, L1)
    cum2 = gap_cost_prefix(gap_series, L2)
    if mode == "global":
        for i in range(1, L1 + 1):
            IX[min(i, k) - 1, i, 0] = -cum1[i]
        for j in range(1, L2 + 1):
            IY[min(j, k) - 1, 0, j] = -cum2[j]
    elif mode == "semiglobal":
        for i in range(1, L1 + 1):
            IX[min(i, k) - 1, i, 0] = 0.0
        for j in range(1, L2 + 1):
            IY[min(j, k) - 1, 0, j] = 0.0
    else:  # local: alignments may start anywhere at zero cost.
        M[:, 0] = 0.0
        M[0, :] = 0.0

    local = mode == "local"
    for i in range(1, L1 + 1):
        for j in range(1, L2 + 1):
            # --- gap states (predecessors at (i-1, j) / (i, j-1)) ---
            for lvl in range(1, k + 1):
                if lvl == 1 and k == 1:
                    a, b = M[i - 1, j], IX[0, i - 1, j]
                    take_stay = b > a  # ties prefer M (enter)
                    IX[0, i, j] = (b if take_stay else a) - g[0]
                    ptrIXk[i, j] = 1 if take_stay else 0
                    a, b = M[i, j - 1], IY[0, i, j - 1]
                    take_stay = b > a
                    IY[0, i, j] = (b if take_stay else a) - g[0]
                    ptrIYk[i, j] = 1 if take_stay else 0
                elif lvl == 1:
                    IX[0, i, j] = M[i - 1, j] - g[0]
                    IY[0, i, j] = M[i, j - 1] - g[0]
                elif lvl < k:
                    IX[lvl - 1, i, j] = IX[lvl - 2, i - 1, j] - g[lvl - 1]
                    IY[lvl - 1, i, j] = IY[lvl - 2, i, j - 1] - g[lvl - 1]
                else:  # lvl == k >= 2
                    a, b = IX[k - 2, i - 1, j], IX[k - 1, i - 1, j]
                    take_stay = b > a  # ties prefer the lower level
                    IX[k - 1, i, j] = (b if take_stay else a) - g[k - 1]
                    ptrIXk[i, j] = 1 if take_stay else 0
                    a, b = IY[k - 2, i, j - 1], IY[k - 1, i, j - 1]
                    take_stay = b > a
                    IY[k - 1, i, j] = (b if take_stay else a) - g[k - 1]
                    ptrIYk[i, j] = 1 if take_stay else 0

            # --- M state (predecessor at (i-1, j-1)) ---
            best = M[i - 1, j - 1]
            ptr = 0
            for lvl in range(k):
                v = IX[lvl, i - 1, j - 1]
                if v > best:
                    best, ptr = v, 1 + lvl
            for lvl in range(k):
                v = IY[lvl, i - 1, j - 1]
                if v > best:
                    best, ptr = v, 1 + k + lvl
            m_val = h[i - 1, j - 1] + best
            if local and m_val < 0.0:
                m_val = 0.0
                ptr = _PTR_NONE
            M[i, j] = m_val
            ptrM[i, j] = ptr

    terminal = _pick_terminal(M, IX, IY, mode, L1, L2, k)
    return _traceback(
        M, IX, IY, ptrM, ptrIXk, ptrIYk, terminal, mode, L1, L2, k
    )


def _degenerate(L1: int, L2: int, gap_series: tuple[int, ...], mode: str) -> AlignResult:
    """One or both sequences empty: the alignment is pure gap columns."""
    if mode == "local" or (L1 == 0 and L2 == 0):
        return _empty_result(mode)
    if L1 == 0:
        cols_x = np.full(L2, GAP, dtype=np.int32)
        cols_y = np.arange(L2, dtype=np.int32)
        cost = 0.0 if mode == "semiglobal" else -float(gap_cost_prefix(gap_series, L2)[L2])
        return AlignResult(cost, cols_x, cols_y, (0, 0), (0, L2), mode)
    cols_x = np.arange(L1, dtype=np.int32)
    cols_y = np.full(L1, GAP, dtype=np.int32)
    cost = 0.0 if mode == "semiglobal" else -float(gap_cost_prefix(gap_series, L1)[L1])
    return AlignResult(cost, cols_x, cols_y, (0, L1), (0, 0), mode)


def _pick_terminal(M, IX, IY, mode, L1, L2, k):
    """Return (state, level, i, j, score); state in {'M','IX','IY'}."""

    def best_state(i: int, j: int):
        best, state, lvl = M[i, j], "M", 0
        for l in range(k):
            if IX[l, i, j] > best:
                best, state, lvl = IX[l, i, j], "IX", l + 1
        for l in range(k):
            if IY[l, i, j] > best:
                best, state, lvl = IY[l, i, j], "IY", l + 1
        return best, state, lvl

    if mode == "global":
        score, state, lvl = best_state(L1, L2)
        return state, lvl, L1, L2, float(score)

    if mode == "semiglobal":
        # Ties -> larger i first, then larger j (§8.3): iterate in that
        # preference order and keep strictly-better candidates only.
        best = None
        for i in range(L1, -1, -1):
            for j in (range(L2, -1, -1) if i == L1 else (L2,)):
                val, state, lvl = best_state(i, j)
                if best is None or val > best[4]:
                    best = (state, lvl, i, j, float(val))
        return best

    # local: argmax over M, ties -> smallest i then smallest j (row-major).
    sub = M[1:, 1:]
    flat = int(np.argmax(sub))
    bi, bj = divmod(flat, L2)
    return "M", 0, bi + 1, bj + 1, float(sub[bi, bj])


def _traceback(M, IX, IY, ptrM, ptrIXk, ptrIYk, terminal, mode, L1, L2, k) -> AlignResult:
    state, lvl, i, j, score = terminal
    rx: list[int] = []
    ry: list[int] = []

    # Free trailing gaps (semiglobal): emit the unconsumed suffix first.
    if mode == "semiglobal":
        for ii in range(L1, i, -1):
            rx.append(ii - 1)
            ry.append(GAP)
        for jj in range(L2, j, -1):
            rx.append(GAP)
            ry.append(jj - 1)

    if mode == "local" and score <= 0.0:
        return _empty_result(mode)

    while True:
        if state == "M":
            if i == 0 and j == 0:
                break
            if mode == "local" and M[i, j] <= 0.0:
                break
            rx.append(i - 1)
            ry.append(j - 1)
            ptr = int(ptrM[i, j])
            i -= 1
            j -= 1
            if ptr == _PTR_NONE:
                break  # local start cell
            if ptr == 0:
                state = "M"
            elif ptr <= k:
                state, lvl = "IX", ptr
            else:
                state, lvl = "IY", ptr - k
        elif state == "IX":
            rx.append(i - 1)
            ry.append(GAP)
            if j == 0:
                # Border run: deterministic walk to the origin.
                i -= 1
                if i == 0:
                    break
                lvl = min(i, k)
                continue
            if lvl == 1 and k == 1:
                stay = int(ptrIXk[i, j])
                i -= 1
                state, lvl = ("IX", 1) if stay else ("M", 0)
            elif lvl == 1:
                i -= 1
                state = "M"
            elif lvl < k:
                i -= 1
                lvl -= 1
            else:
                stay = int(ptrIXk[i, j])
                i -= 1
                lvl = k if stay else k - 1
            if state == "M" and i == 0 and j == 0:
                break
        else:  # IY
            rx.append(GAP)
            ry.append(j - 1)
            if i == 0:
                j -= 1
                if j == 0:
                    break
                lvl = min(j, k)
                continue
            if lvl == 1 and k == 1:
                stay = int(ptrIYk[i, j])
                j -= 1
                state, lvl = ("IY", 1) if stay else ("M", 0)
            elif lvl == 1:
                j -= 1
                state = "M"
            elif lvl < k:
                j -= 1
                lvl -= 1
            else:
                stay = int(ptrIYk[i, j])
                j -= 1
                lvl = k if stay else k - 1
            if state == "M" and i == 0 and j == 0:
                break

    cols_x = np.asarray(rx[::-1], dtype=np.int32)
    cols_y = np.asarray(ry[::-1], dtype=np.int32)
    xs = cols_x[cols_x != GAP]
    ys = cols_y[cols_y != GAP]
    x_range = (int(xs.min()), int(xs.max()) + 1) if xs.size else (0, 0)
    y_range = (int(ys.min()), int(ys.max()) + 1) if ys.size else (0, 0)
    return AlignResult(score, cols_x, cols_y, x_range, y_range, mode)


def align_profiles(
    px: Profile,
    py: Profile,
    matrix: ScoreMatrix,
    gap_series: tuple[int, ...],
    mode: str,
) -> AlignResult:
    """Profile-profile (or, via one-hot profiles, seq-seq) alignment."""
    return align_scores(pair_score_matrix(px, py, matrix), gap_series, mode)


def align_tracksets(
    tracks_x,
    tracks_y,
    matrices,
    weights,
    gap_series: tuple[int, ...],
    mode: str,
) -> AlignResult:
    """Multi-track composite alignment (SURVEY.md C4, §8.1): DP over the
    weighted per-track score sum.  The track/score-fn seam the reference's
    component architecture exposes — e.g. amino-acid + secondary-structure
    tracks with weights — as a first-class oracle entry point."""
    from .score import composite_pair_score_matrix

    h = composite_pair_score_matrix(tracks_x, tracks_y, matrices, weights)
    return align_scores(h, gap_series, mode)


def align_tokens(
    x_tokens: np.ndarray,
    y_tokens: np.ndarray,
    matrix: ScoreMatrix,
    gap_series: tuple[int, ...],
    mode: str,
) -> AlignResult:
    h = matrix.as_f32()[np.asarray(x_tokens)[:, None], np.asarray(y_tokens)[None, :]]
    return align_scores(h, gap_series, mode)
