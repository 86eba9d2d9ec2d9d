"""Master-slave preprofile generation (SURVEY.md C13, §4.5, §8.5).

For master sequence *i*, every other input (plus any homology-search hits) is
pairwise-aligned to the master; each slave path is projected into master
coordinates (slave insertion columns dropped), the projected rows stack into
a star alignment whose master row is ungapped, and the star's per-position
counts become the master's preprofile track.

Pinned counting (§8.5): the master contributes its own residue with count 1;
each slave residue aligned to a master position adds 1; a slave gap INSIDE
the slave's aligned span adds 1 to the gap count; positions outside the span
(local mode) contribute nothing.  No sequence weighting.
"""

from __future__ import annotations

import numpy as np

from ..types import (
    GAP,
    Profile,
    ScoreMatrix,
    Sequence,
    TRACK_ID_PREPROFILE,
)
from .align import AlignResult, align_tokens

# Star-alignment cell for "slave not aligned here at all" (outside its span).
ABSENT = -2


def project_to_master(result: AlignResult, master_len: int) -> np.ndarray:
    """Project a master-vs-slave path into master coordinates.

    Returns ``int32[master_len]``: slave token index aligned at each master
    position, :data:`GAP` for a slave gap inside the aligned span, or
    :data:`ABSENT` outside it.  Columns where the master has a gap (slave
    insertions) are dropped (§4.5).
    """
    row = np.full(master_len, ABSENT, dtype=np.int32)
    keep = result.cols_x != GAP  # master consumes -> a master coordinate
    mpos = result.cols_x[keep]
    row[mpos] = result.cols_y[keep]
    return row


def star_counts(
    master: Sequence, slave_rows: list[np.ndarray], slave_tokens: list[np.ndarray]
) -> Profile:
    """Counts of the star alignment (master row + projected slave rows).

    ``slave_rows[k]`` holds slave POSITION indices per master position (or
    GAP/ABSENT); the residue counted is ``slave_tokens[k][position]``.
    """
    alphabet = master.alphabet
    L = master.length
    counts = np.zeros((L, alphabet.size), dtype=np.float32)
    counts[np.arange(L), master.tokens] = 1.0
    gaps = np.zeros(L, dtype=np.float32)
    for row, stoks in zip(slave_rows, slave_tokens):
        aligned = row >= 0
        pos = np.nonzero(aligned)[0]
        np.add.at(counts, (pos, stoks[row[pos]]), 1.0)
        gaps += (row == GAP).astype(np.float32)
    return Profile(counts, gaps, alphabet)


def build_preprofile(
    master: Sequence,
    slaves: list[Sequence],
    matrix: ScoreMatrix,
    gap_series: tuple[int, ...],
    mode: str,
) -> Profile:
    """Align every slave to the master and accumulate star counts.

    ``mode`` is ``"global"`` or ``"local"`` (SURVEY.md C13); the ``dummy``
    strategy never calls this (preprofile = one-hot master).
    """
    rows = []
    toks = []
    for slave in slaves:
        result = align_tokens(master.tokens, slave.tokens, matrix, gap_series, mode)
        rows.append(project_to_master(result, master.length))
        toks.append(slave.tokens)
    return star_counts(master, rows, toks)


def attach_preprofiles(
    sequences: list[Sequence],
    matrix: ScoreMatrix,
    gap_series: tuple[int, ...],
    mode: str,
    extra_slaves: dict[int, list[Sequence]] | None = None,
) -> list[Sequence]:
    """Return sequences with their ``TRACK_ID_PREPROFILE`` track attached.

    ``mode``: ``"dummy"`` -> one-hot master (plain progressive alignment);
    ``"global"``/``"local"`` -> master-slave star preprofiles.
    ``extra_slaves`` maps master index -> homology-search hits (SURVEY.md
    C14: homology-extended alignment uses identical mechanics with BLAST hits
    as extra slaves).
    """
    out = []
    for i, master in enumerate(sequences):
        if mode == "dummy":
            prof = master.one_hot_profile()
        else:
            slaves = [s for j, s in enumerate(sequences) if j != i]
            if extra_slaves and i in extra_slaves:
                slaves = slaves + list(extra_slaves[i])
            prof = build_preprofile(master, slaves, matrix, gap_series, mode)
        out.append(master.with_profile(TRACK_ID_PREPROFILE, prof))
    return out
