"""Guide-tree construction (SURVEY.md C16, §4.3, §8.4).

Hierarchical agglomerative joining over a similarity matrix (larger = more
similar), kept on the host: it is O(N^2)-cheap scalar work next to the
O(N^2 L^2) DP stage (SURVEY.md §9 hard part 4).

Pinned semantics (§8.4):

* similarity(i, j) = pairwise alignment score, optionally divided by the
  pairwise alignment length (``score_normalization == "length"``),
* linkage over original leaf-pair similarities: ``single`` (max),
  ``complete`` (min), ``average`` (arithmetic mean in float64),
* at each step join the pair with maximal linkage; ties -> lexicographically
  smallest ``(min(node_id), max(node_id))``.

Two implementations share these semantics:

* :func:`build_guide_tree` — the production construction: Lance-Williams
  incremental linkage updates (max-of-max / min-of-min / sum-of-sums) with
  per-cluster best-partner caches, ~O(N^2) total.  ``single``/``complete``
  are bit-identical to the reference construction (max/min are associative);
  ``average`` accumulates the same leaf-pair sums in merge order rather
  than numpy's pairwise-summation order, so values may differ by ulps —
  property-tested equal on random matrices (tests/oracle).
* :func:`build_guide_tree_reference` — the pinned brute-force form
  (recompute linkage over member blocks each step, O(N^3)-O(N^4)); the
  executable statement of the contract and the test oracle.
"""

from __future__ import annotations

import numpy as np

from ..types import SequenceTree


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


def build_guide_tree(similarity: np.ndarray, linkage: str = "average") -> SequenceTree:
    """Incremental-linkage guide tree (semantics pinned above).

    ~O(N^2) on typical inputs; tie-heavy matrices (many exactly-equal
    linkages, e.g. duplicate-rich sets) invalidate many best-partner
    caches per join and degrade gracefully toward O(N^3) vectorized work
    — results stay identical to the reference construction either way.
    """
    sim, n = _validate(similarity, linkage)
    if n == 1:
        return SequenceTree(1, ())

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
    return SequenceTree(n, tuple(joins))


def build_guide_tree_reference(
    similarity: np.ndarray, linkage: str = "average"
) -> SequenceTree:
    """Brute-force construction: the executable form of the pinned contract."""
    sim, n = _validate(similarity, linkage)
    if n == 1:
        return SequenceTree(1, ())

    members: dict[int, list[int]] = {i: [i] for i in range(n)}
    joins: list[tuple[int, int]] = []

    def link(a: int, b: int) -> float:
        block = sim[np.ix_(members[a], members[b])]
        if linkage == "single":
            return float(block.max())
        if linkage == "complete":
            return float(block.min())
        return float(block.mean())

    for step in range(n - 1):
        active = sorted(members)
        best: tuple[float, int, int] | None = None
        for ai in range(len(active)):
            for bi in range(ai + 1, len(active)):
                a, b = active[ai], active[bi]
                v = link(a, b)
                # Ties resolve to the lexicographically smallest (a, b);
                # iteration order already visits pairs in that order, so
                # only strictly-better candidates replace.
                if best is None or v > best[0]:
                    best = (v, a, b)
        _, a, b = best  # type: ignore[misc]
        new_id = n + step
        members[new_id] = members.pop(a) + members.pop(b)
        joins.append((a, b))
    return SequenceTree(n, tuple(joins))


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
