"""PRALINE's progressive alignment, plain: the reference that decides ``correct``.

Works from the residue tokens the benchmark generated and the matrix file it
loaded, never from anything the program made: the all-pairs stage
(:func:`all_pairs`), the guide tree (``tree.py``), profiles and their
composition along a merge path, and the progressive merge
(:func:`progressive_merge`).  :func:`check_joins` judges an emitted
alignment join by join, each join's DP run afresh on profiles composed
along the emitted paths of the joins below it.  Profile arithmetic is that
of the port's documentation (``oracle/score.py``, ``oracle/profile.py``):
counts, ``inv = 1 / max(1, column count)`` in float32, a cell's score
``(D * inv_x) * inv_y`` with ``D = Cx S Cy^T`` exact.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dp
from .tree import build_guide_tree, similarity_from_scores

GAP = dp.GAP
COUNT_LIMIT = 992.0
RESCALE_TARGET = 256.0
PAIR_CHUNK = 8192  # pairs a batched DP: 8192 x 1024 lanes keeps each state array near 32 MB


def all_pairs(tokens, S, gap_series, mode, device, dtype=torch.float32):
    """N x N (score, alignment length) of every pair ``i < j``, scores-only
    DP on member one-hot profiles (``h = S[x_i, y_j]``).  The diagonal holds
    ``max(1, length)`` as the program's does."""
    n = len(tokens)
    pi, pj = np.triu_indices(n, 1)
    scores = np.zeros((n, n), dtype=np.float64)
    lengths = np.zeros((n, n), dtype=np.int64)
    lengths[np.arange(n), np.arange(n)] = [max(1, len(t)) for t in tokens]
    lx = np.array([len(t) for t in tokens], dtype=np.int64)
    for at in range(0, len(pi), PAIR_CHUNK):
        a, b = pi[at:at + PAIR_CHUNK], pj[at:at + PAIR_CHUNK]
        src = dp.token_source(tokens, a, b, S, device, dtype)
        s, length = dp.scores_and_lengths(src, lx[a], lx[b], gap_series, mode, dtype)
        scores[a, b] = scores[b, a] = s
        lengths[a, b] = lengths[b, a] = length
    return scores, lengths


def guide_tree(scores, lengths, linkage: str, normalization: str) -> tuple:
    return build_guide_tree(similarity_from_scores(scores, lengths, normalization), linkage)


def one_hot(tokens: np.ndarray, A: int):
    counts = np.zeros((len(tokens), A), dtype=np.float32)
    counts[np.arange(len(tokens)), tokens] = 1.0
    return counts, np.zeros(len(tokens), dtype=np.float32)


def rescale(counts, gaps):
    """Columns whose residue and gap count passes COUNT_LIMIT go to a
    fixed-point grid of total RESCALE_TARGET (``floor(c * 256 / n + 0.5)``)."""
    totals = counts.sum(axis=1, dtype=np.float64) + gaps.astype(np.float64)
    over = totals > COUNT_LIMIT
    if not over.any():
        return counts, gaps
    counts, gaps = counts.copy(), gaps.copy()
    n = totals[over]
    counts[over] = np.floor(counts[over].astype(np.float64) * RESCALE_TARGET / n[:, None]
                            + 0.5).astype(np.float32)
    gaps[over] = np.floor(gaps[over].astype(np.float64) * RESCALE_TARGET / n
                          + 0.5).astype(np.float32)
    return counts, gaps


def compose(left, right, n_left: int, n_right: int, cols_x, cols_y):
    """The merged node's profile: each column the left child's column (or
    ``n_left`` gaps) plus the right child's (or ``n_right`` gaps), then the
    rescale of over-limit columns."""
    C, A = len(cols_x), left[0].shape[1]
    counts = np.zeros((C, A), dtype=np.float32)
    gaps = np.zeros(C, dtype=np.float32)
    for (c_in, g_in, n_side), cols in (((*left, n_left), cols_x), ((*right, n_right), cols_y)):
        m = cols != GAP
        counts[m] += c_in[cols[m]]
        gaps[m] += g_in[cols[m]]
        gaps[~m] += np.float32(n_side)
    return rescale(counts, gaps)


def column_inverses(counts) -> np.ndarray:
    totals = np.maximum(counts.sum(axis=1, dtype=np.float32), np.float32(1.0))
    return (np.float32(1.0) / totals).astype(np.float32)


def profile_scores(left, right, S, device) -> torch.Tensor:
    """``h[i, j] = (D * inv_x[i]) * inv_y[j]`` in float32, ``D = Cx S Cy^T``
    exact (integer counts, products in float64)."""
    cx = torch.as_tensor(left[0], device=device, dtype=torch.float64)
    cy = torch.as_tensor(right[0], device=device, dtype=torch.float64)
    s = torch.as_tensor(np.asarray(S), device=device, dtype=torch.float64)
    d = (cx @ s @ cy.T).float()
    inv_x = torch.as_tensor(column_inverses(left[0]), device=device)
    inv_y = torch.as_tensor(column_inverses(right[0]), device=device)
    return (d * inv_x[:, None]) * inv_y[None, :]


def join_paths(pairs, S, gap_series, mode, device, dtype=torch.float32):
    """The traceback paths of profile pairs ``[(left, right), ...]``, one batched DP."""
    h = [profile_scores(left, right, S, device) for left, right in pairs]
    lx = [t.shape[0] for t in h]
    ly = [t.shape[1] for t in h]
    out = dp.paths(dp.dense_source(h, device, dtype), lx, ly, gap_series, mode, dtype)
    del h
    return out


def merge_levels(n: int, joins) -> list[list[int]]:
    """Join indices grouped by depth; the joins of a level are independent."""
    depth = {i: 0 for i in range(n)}
    levels: dict[int, list[int]] = {}
    for k, (l, r) in enumerate(joins):
        depth[n + k] = 1 + max(depth[l], depth[r])
        levels.setdefault(depth[n + k], []).append(k)
    return [levels[d] for d in sorted(levels)]


def inject(left_rows, right_rows, cols_x, cols_y):
    out = np.full((len(left_rows) + len(right_rows), len(cols_x)), GAP, dtype=np.int32)
    xm, ym = cols_x != GAP, cols_y != GAP
    out[:len(left_rows), xm] = left_rows[:, cols_x[xm]]
    out[len(left_rows):, ym] = right_rows[:, cols_y[ym]]
    return out


def progressive_merge(tokens, joins, S, gap_series, mode, device, dtype=torch.float32):
    """The whole merge, a tree level at a time: rows ``[N, C]`` in input
    order (:data:`GAP` for a gap)."""
    n, A = len(tokens), S.shape[0]
    members = {i: [i] for i in range(n)}
    rows = {i: np.asarray(t, np.int32)[None, :] for i, t in enumerate(tokens)}
    prof = {i: one_hot(np.asarray(t), A) for i, t in enumerate(tokens)}
    for level in merge_levels(n, joins):
        got = join_paths([(prof[joins[k][0]], prof[joins[k][1]]) for k in level],
                         S, gap_series, mode, device, dtype)
        for k, (cols_x, cols_y) in zip(level, got):
            l, r = joins[k]
            rows[n + k] = inject(rows.pop(l), rows.pop(r), cols_x, cols_y)
            prof[n + k] = compose(prof.pop(l), prof.pop(r), len(members[l]), len(members[r]),
                                  cols_x, cols_y)
            members[n + k] = members.pop(l) + members.pop(r)
    root = n + len(joins) - 1
    out = np.empty_like(rows[root])
    out[members[root]] = rows[root]
    return out


def check_joins(rows, joins, tokens, S, gap_series, mode, device) -> int:
    """Errors of an emitted alignment ``rows [N, C]`` (input order) under the
    tree ``joins``: rows that do not degap to their input, plus joins whose
    emitted path differs from the reference DP's path on the two child
    profiles.  A node's columns are those where any of its members has a
    residue; a child's profile is composed along the emitted paths below it,
    so each join is judged on its own."""
    rows = np.asarray(rows)
    n, A = len(tokens), S.shape[0]
    if rows.ndim != 2 or rows.shape[0] != n:
        return n
    filled = rows != GAP
    errors = sum(int(not np.array_equal(rows[i][filled[i]], np.asarray(tokens[i])))
                 for i in range(n))
    cols = {i: np.flatnonzero(filled[i]) for i in range(n)}
    size = {i: 1 for i in range(n)}
    prof = {i: one_hot(np.asarray(rows[i][filled[i]]), A) for i in range(n)}
    pairs, emitted = [], []
    for k, (l, r) in enumerate(joins):
        both = np.union1d(cols[l], cols[r])
        cols_x = np.where(np.isin(both, cols[l]), np.searchsorted(cols[l], both), GAP)
        cols_y = np.where(np.isin(both, cols[r]), np.searchsorted(cols[r], both), GAP)
        cols_x, cols_y = cols_x.astype(np.int32), cols_y.astype(np.int32)
        pairs.append((prof[l], prof[r]))
        emitted.append((cols_x, cols_y))
        prof[n + k] = compose(prof[l], prof[r], size[l], size[r], cols_x, cols_y)
        cols[n + k], size[n + k] = both, size[l] + size[r]
    got = join_paths(pairs, S, gap_series, mode, device)
    errors += sum(int(not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])))
                  for a, b in zip(got, emitted))
    return errors


def judge(tokens, output: dict, S, config: dict, device) -> dict:
    """The numbers a request's output is judged by, each 0 when it is right:
    ``pairs_differ`` (all-pairs scores or lengths unlike the reference's),
    and for a whole alignment ``tree_joins_differ`` (joins of the emitted
    guide tree unlike the reference's) and ``alignment_errors``
    (:func:`check_joins`)."""
    gaps = tuple(config["gap_series"])
    scores, lengths = all_pairs(tokens, S, gaps, config["distance_mode"], device)
    got_s, got_l = (np.asarray(x) for x in output["all_pairs"])
    upper = np.triu_indices(len(tokens), 1)
    differ = (got_s[upper] != scores[upper]) | (got_l[upper] != lengths[upper])
    out = {"pairs_differ": int(differ.sum())}
    if "rows" in output:
        joins = guide_tree(scores, lengths, config["linkage"], config["score_normalization"])
        out["tree_joins_differ"] = sum(int(a != b) for a, b in zip(joins, output["joins"]))
        out["alignment_errors"] = check_joins(output["rows"], output["joins"], tokens, S, gaps,
                                              config["merge_mode"], device)
    return out


def lowered(tokens, S, config: dict, whole: bool, device, dtype=torch.bfloat16) -> dict:
    """The control: the reference in the program's place, its DP cells in
    ``dtype``: the all-pairs matrices and, for a whole alignment, the guide
    tree on them and the merge along it."""
    gaps = tuple(config["gap_series"])
    scores, lengths = all_pairs(tokens, S, gaps, config["distance_mode"], device, dtype)
    out = {"all_pairs": (scores, lengths)}
    if whole:
        out["joins"] = guide_tree(scores, lengths, config["linkage"],
                                  config["score_normalization"])
        out["rows"] = progressive_merge(tokens, out["joins"], S, gaps, config["merge_mode"],
                                        device, dtype)
    return out
