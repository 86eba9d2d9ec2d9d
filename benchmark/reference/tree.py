"""The guide tree: average-linkage joining over length-normalised scores.

Frozen copy of ``praline_tpu_torch/oracle/tree.py`` (``_validate``,
``build_guide_tree``, ``similarity_from_scores``), returning the join list
(``joins[k] = (left, right)`` makes node ``n + k``) instead of the port's
tree type.  Semantics: join the pair of clusters with the largest linkage,
ties to the lexicographically smallest ``(min id, max id)``; average linkage
accumulates leaf-pair sums in float64 in join order.
"""

from __future__ import annotations

import numpy as np


def _validate(similarity: np.ndarray, linkage: str) -> tuple[np.ndarray, int]:
    sim = np.asarray(similarity, dtype=np.float64)
    n = sim.shape[0]
    if sim.shape != (n, n):
        raise ValueError("similarity matrix must be square")
    if n == 0:
        raise ValueError("need at least one sequence")
    if linkage not in ("single", "complete", "average"):
        raise ValueError(f"unknown linkage {linkage!r}")
    return sim, n


def build_guide_tree(similarity: np.ndarray, linkage: str = "average") -> tuple:
    """Incremental-linkage guide tree (semantics pinned above).

    ~O(N^2) on typical inputs; tie-heavy matrices (many exactly-equal
    linkages, e.g. duplicate-rich sets) invalidate many best-partner
    caches per join and degrade gracefully toward O(N^3) vectorized work
    — results stay identical to the reference construction either way.
    """
    sim, n = _validate(similarity, linkage)
    if n == 1:
        return ()

    BIG = np.int64(2 * n)  # node ids < 2n-1, so (min*BIG + max) orders pairs

    # Slot-reuse state: cluster c lives in a fixed slot; a join writes the
    # merged cluster into the left slot and deactivates the right one.
    ids = np.arange(n, dtype=np.int64)  # slot -> current node id
    active = np.ones(n, dtype=bool)
    cnt = np.ones(n, dtype=np.int64)  # leaves per cluster
    # Linkage state M: for single/complete the pairwise link itself
    # (max/min over leaf pairs); for average the SUM of leaf-pair
    # similarities (divided by cnt_a*cnt_b on read).
    M = sim.copy()
    np.fill_diagonal(M, 0.0)

    def link_row(s: int) -> np.ndarray:
        if linkage == "average":
            return M[s] / (cnt[s] * cnt).astype(np.float64)
        return M[s]

    def pair_keys(s: int) -> np.ndarray:
        mn = np.minimum(ids[s], ids)
        mx = np.maximum(ids[s], ids)
        return mn * BIG + mx

    # Per-slot best-partner cache: (value, lex pair key, partner slot).
    best_val = np.full(n, -np.inf)
    best_key = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
    best_slot = np.full(n, -1, dtype=np.int64)
    MAXK = np.iinfo(np.int64).max

    def recompute_best_many(S: np.ndarray) -> None:
        """Rescan the best partner of every slot in S at once (vectorized:
        tie-heavy matrices stale many caches per join)."""
        if len(S) == 0:
            return
        if linkage == "average":
            vals = M[S] / (cnt[S, None] * cnt[None, :]).astype(np.float64)
        else:
            vals = M[S].copy()
        mask = np.broadcast_to(active, (len(S), n)).copy()
        mask[np.arange(len(S)), S] = False
        vals[~mask] = -np.inf
        vmax = vals.max(axis=1)
        mn = np.minimum(ids[S, None], ids[None, :])
        mx = np.maximum(ids[S, None], ids[None, :])
        keys = mn * BIG + mx
        # & mask: when a row's max is -inf (degenerate all--inf input),
        # equality alone would admit self/inactive slots as candidates.
        cand_keys = np.where((vals == vmax[:, None]) & mask, keys, MAXK)
        pick = cand_keys.argmin(axis=1)
        best_val[S] = vmax
        best_key[S] = cand_keys[np.arange(len(S)), pick]
        best_slot[S] = pick

    recompute_best_many(np.arange(n))

    joins: list[tuple[int, int]] = []
    for step in range(n - 1):
        act = np.nonzero(active)[0]
        vb = best_val[act]
        cand = act[vb == vb.max()]
        s = int(cand[best_key[cand].argmin()])
        t = int(best_slot[s])
        a, b = int(ids[s]), int(ids[t])
        joins.append((a, b) if a < b else (b, a))
        if step == n - 2:
            break

        # Lance-Williams update: merge t's state into s, retire t.
        if linkage == "average":
            M[s] += M[t]
            M[:, s] += M[:, t]
        elif linkage == "single":
            np.maximum(M[s], M[t], out=M[s])
            np.maximum(M[:, s], M[:, t], out=M[:, s])
        else:
            np.minimum(M[s], M[t], out=M[s])
            np.minimum(M[:, s], M[:, t], out=M[:, s])
        cnt[s] += cnt[t]
        ids[s] = n + step
        active[t] = False
        M[s, s] = 0.0

        # Refresh stale caches: clusters whose best partner was a merged
        # slot rescan their rows (one vectorized pass), everyone else just
        # races the new cluster against their cached best.
        vals_z = link_row(s)
        keys_z = pair_keys(s)
        others = active.copy()
        others[s] = False
        stale = others & ((best_slot == s) | (best_slot == t))
        upd = (
            others
            & ~stale
            & ((vals_z > best_val) | ((vals_z == best_val) & (keys_z < best_key)))
        )
        best_val[upd] = vals_z[upd]
        best_key[upd] = keys_z[upd]
        best_slot[upd] = s
        recompute_best_many(np.concatenate(([s], np.nonzero(stale)[0])))
    return tuple(joins)


def similarity_from_scores(
    scores: np.ndarray, lengths: np.ndarray, normalization: str = "length"
) -> np.ndarray:
    """N x N similarity from pairwise (score, alignment-length) results."""
    scores = np.asarray(scores, dtype=np.float64)
    if normalization == "none":
        return scores
    if normalization == "length":
        return scores / np.maximum(np.asarray(lengths, dtype=np.float64), 1.0)
    raise ValueError(f"unknown score normalization {normalization!r}")
