"""Profile construction for progressive alignment (SURVEY.md C12, §8.5).

Node profiles are built by summing, per alignment column, each member's
contribution: the member's preprofile counts at its residue position (a plain
sequence contributes a one-hot count), or a gap count when the member row has
a gap.  All counts stay small exact integers in float32.

To preserve the exact-arithmetic parity contract (oracle/score.py), a column
whose total count would exceed :data:`COUNT_LIMIT` is deterministically
rescaled to a fixed-point grid with total ~:data:`RESCALE_TARGET` — a pinned
canonical choice (SURVEY.md §0: the oracle defines parity) that keeps the
integer dot product below 2**24 for any input size.
"""

from __future__ import annotations

import numpy as np

from ..types import GAP, Alignment, Profile, Sequence, TRACK_ID_PREPROFILE

# max|S| for packaged matrices is 17 (PAM250's W-W); 992 * 992 * 17 < 2**24.
COUNT_LIMIT = 992.0
RESCALE_TARGET = 256.0


def rescale_counts(counts: np.ndarray, gaps: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic fixed-point rescale of over-limit columns.

    ``q = floor(c * 256 / n + 0.5)`` per entry, computed in float64 (exact for
    these magnitudes), applied only to columns with total residue+gap count
    above :data:`COUNT_LIMIT`.  Pinned canonical semantics.
    """
    totals = counts.sum(axis=1, dtype=np.float64) + gaps.astype(np.float64)
    over = totals > COUNT_LIMIT
    if not over.any():
        return counts, gaps
    counts = counts.copy()
    gaps = gaps.copy()
    n = totals[over][:, None]
    counts[over] = np.floor(counts[over].astype(np.float64) * RESCALE_TARGET / n + 0.5).astype(
        np.float32
    )
    gaps[over] = np.floor(
        gaps[over].astype(np.float64) * RESCALE_TARGET / totals[over] + 0.5
    ).astype(np.float32)
    return counts, gaps


def member_profile(seq: Sequence) -> Profile:
    """The profile a member contributes during merging: its preprofile track
    if present, else the one-hot of its tokens (dummy preprofile, §8.5)."""
    prof = seq.profiles.get(TRACK_ID_PREPROFILE)
    return prof if prof is not None else seq.one_hot_profile()


def compose_profiles(
    left: Profile,
    right: Profile,
    n_left: int,
    n_right: int,
    cols_x: np.ndarray,
    cols_y: np.ndarray,
) -> Profile:
    """Profile of a merged node from its CHILD profiles and the merge path.

    Pinned compositional semantics (canonical, SURVEY.md §0/§8.5): column c
    takes the left child's (possibly already-rescaled) column ``cols_x[c]``
    — or, at an inserted gap column, ``n_left`` gap counts (one per left
    member) — plus the right analog; over-limit columns then rescale at this
    node.  When no rescale triggers anywhere this equals recomputing
    :func:`node_profile` from the member rows, and it is what the on-device
    merge path (msa.device_merge) implements, so oracle, pipeline and device
    agree bit-exactly by construction.
    """
    C = cols_x.shape[0]
    A = left.counts.shape[1]
    counts = np.zeros((C, A), dtype=np.float32)
    gaps = np.zeros(C, dtype=np.float32)
    xm = cols_x != GAP
    counts[xm] += left.counts[cols_x[xm]]
    gaps[xm] += left.gaps[cols_x[xm]]
    gaps[~xm] += np.float32(n_left)
    ym = cols_y != GAP
    counts[ym] += right.counts[cols_y[ym]]
    gaps[ym] += right.gaps[cols_y[ym]]
    gaps[~ym] += np.float32(n_right)
    counts, gaps = rescale_counts(counts, gaps)
    return Profile(counts, gaps, left.alphabet)


def node_profile(alignment: Alignment) -> Profile:
    """Profile of an alignment node for progressive merging.

    Column c counts = sum over members k of: preprofile counts of member k at
    the member position aligned to column c, or +1 gap if row k has a gap.
    """
    alphabet = alignment.alphabet
    A = alphabet.size
    C = alignment.num_columns
    counts = np.zeros((C, A), dtype=np.float32)
    gaps = np.zeros(C, dtype=np.float32)
    for k, member in enumerate(alignment.members):
        row = alignment.rows[k]
        is_gap = row == GAP
        gaps += is_gap.astype(np.float32)
        pos = np.cumsum(~is_gap) - 1  # member position per column
        mp = member_profile(member)
        counts[~is_gap] += mp.counts[pos[~is_gap]]
    counts, gaps = rescale_counts(counts, gaps)
    return Profile(counts, gaps, alphabet)
