"""Column-accuracy metrics: SP and TC scores vs a reference alignment.

Copy of ``praline_tpu/util/accuracy.py`` (host numpy; the port keeps its
own, importing nothing of the JAX package), behind the CLI's
``--score-against``.

SURVEY.md §5.5: column accuracy is tracked as a METRIC, never asserted —
the parity contract is byte-equality with the oracle pipeline; SP/TC exist
to evaluate alignments against externally curated references
(BAliBASE-style benchmark sets), matching the reference toolkit's
evaluation workflow (bali_score definitions):

* **SP** (sum-of-pairs): the fraction of residue PAIRS aligned together in
  the reference that are also aligned together in the test alignment.
* **TC** (total-column): the fraction of reference columns whose entire
  residue set is reproduced as one column of the test alignment.

Members are matched by sequence name; both alignments must contain the
same sequences (tokens included — the metric compares alignments of the
same data, not different data).
"""

from __future__ import annotations

import numpy as np

from ..types import GAP, Alignment


def _residue_columns(aln: Alignment) -> dict[str, np.ndarray]:
    """name -> int32[len(seq)] mapping residue index -> alignment column."""
    out: dict[str, np.ndarray] = {}
    for k, member in enumerate(aln.members):
        if member.name in out:
            raise ValueError(
                f"duplicate sequence name {member.name!r}: SP/TC matches "
                "members by name and cannot disambiguate"
            )
        row = aln.rows[k]
        cols = np.flatnonzero(row != GAP).astype(np.int64)
        out[member.name] = cols
    return out


def sp_tc(test: Alignment, ref: Alignment) -> tuple[float, float]:
    """Return ``(sp, tc)`` of ``test`` against the reference alignment.

    Both in [0, 1]; a reference with no aligned pairs (single sequence or
    all-gap columns) scores (1.0, 1.0) by convention.
    """
    tcols = _residue_columns(test)
    rcols = _residue_columns(ref)
    if set(tcols) != set(rcols):
        raise ValueError(
            "test and reference alignments contain different sequences: "
            f"{sorted(set(tcols) ^ set(rcols))}"
        )
    ttoks = {m.name: m.tokens for m in test.members}
    for member in ref.members:
        if not np.array_equal(ttoks[member.name], member.tokens):
            raise ValueError(
                f"sequence {member.name!r} differs between alignments"
            )

    names = [m.name for m in ref.members]
    n = len(names)
    C_ref = ref.num_columns

    # For each member: map each REFERENCE column to the TEST column holding
    # the same residue (-1 where the reference column is a gap for it).
    ref_to_test = np.full((n, C_ref), -1, dtype=np.int64)
    for i, name in enumerate(names):
        ref_to_test[i, rcols[name]] = tcols[name]

    valid = ref_to_test >= 0
    pairs_total = 0
    pairs_hit = 0
    # Column-wise pair counting: residues in the same reference column are
    # aligned pairs; a pair is reproduced iff both land in the same test
    # column.  O(n^2 * C) with tiny constants (vectorized over columns).
    for i in range(n):
        for j in range(i + 1, n):
            both = valid[i] & valid[j]
            pairs_total += int(both.sum())
            pairs_hit += int((both & (ref_to_test[i] == ref_to_test[j])).sum())

    # TC: a reference column counts when every residue in it maps to ONE
    # test column (columns with < 2 residues count trivially).
    masked = np.where(valid, ref_to_test, np.int64(-1))
    col_max = masked.max(axis=0)
    agree = (~valid) | (ref_to_test == col_max[None, :])
    tc_hits = agree.all(axis=0)
    n_res = valid.sum(axis=0)
    core = n_res >= 2
    sp = pairs_hit / pairs_total if pairs_total else 1.0
    tc = float(tc_hits[core].mean()) if core.any() else 1.0
    return float(sp), tc
