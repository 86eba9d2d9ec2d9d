"""The traffic generator: seeded protein families from a traffic file's parameters.

Adapted from ``chip_smoke.py::synthetic_family`` and ``mutated``: a random
root, each member with ``substitution`` of its residues replaced, ``insertions``
short insertions of 1..``max_insert`` residues, then runs of 1..``max_cut``
residues deleted down to a target length.  Two changes make it a yardstick:
every family of every seed takes the same set of target lengths (evenly
spaced over ``lo``..``hi``, in an order drawn from the seed), so seeds change
the residues and not the work; and the draws are made for a whole family
at once (the deletions as runs placed among the kept residues), which makes
a 128-member family in milliseconds instead of seconds.
"""

from __future__ import annotations

import numpy as np


def target_lengths(members: int, lo: int, hi: int) -> np.ndarray:
    return np.rint(np.linspace(lo, hi, members)).astype(np.int64)


def family(seed: int, index: int, p: dict) -> list[np.ndarray]:
    """Family ``index`` of ``seed``: its own generator, so a family does not
    depend on how many were made before it.  Every draw is made for the
    whole family at once."""
    rng = np.random.default_rng([seed, index])
    n, L, A, k = p["members"], p["root"], p["alphabet"], p["insertions"]
    root = rng.integers(0, A, size=L)
    targets = rng.permutation(target_lengths(n, p["lo"], p["hi"]))
    subbed = np.where(rng.random((n, L)) < p["substitution"], rng.integers(0, A, size=(n, L)),
                      root)
    ins_at = rng.random((n, k))
    ins_len = rng.integers(1, p["max_insert"] + 1, size=(n, k))
    ins_res = rng.integers(0, A, size=(n, k, p["max_insert"]))
    runs = rng.integers(1, p["max_cut"] + 1, size=(n, L + k * p["max_insert"]))
    cut_at = rng.random(runs.shape)
    out = []
    for m in range(n):
        toks = subbed[m]
        for j in range(k):
            at = int(ins_at[m, j] * (toks.size + 1))
            toks = np.insert(toks, at, ins_res[m, j, :ins_len[m, j]])
        out.append(_cut(toks, int(targets[m]), runs[m], cut_at[m]))
    return out


def _cut(toks: np.ndarray, target: int, runs: np.ndarray, cut_at: np.ndarray) -> np.ndarray:
    """``toks`` down to ``target`` residues: deletion runs of the lengths
    ``runs`` (the last one shortened), placed among the kept residues at
    the fractions ``cut_at``."""
    cut = toks.size - target
    if cut <= 0:
        return toks.astype(np.int32)
    ends = np.cumsum(runs)
    n = int(np.searchsorted(ends, cut)) + 1
    runs = runs[:n].copy()
    runs[-1] -= int(ends[n - 1]) - cut
    keep = toks.size - cut
    kept = np.diff(np.concatenate(([0], np.sort((cut_at[:n] * (keep + 1)).astype(np.int64)),
                                   [keep])))
    seg = np.empty(2 * n + 1, dtype=np.int64)
    seg[0::2], seg[1::2] = kept, runs
    return toks[~np.repeat(np.arange(2 * n + 1) % 2 == 1, seg)].astype(np.int32)
