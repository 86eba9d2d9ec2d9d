"""The tiled DP kernel's (K6) share of its roofline: the least time the card
could take for the work of the traced requests' problems past the fused
kernel's lanes (``roofline.py``), over the device time of K6's launches.

The problems are counted by the benchmark, from the inputs and the emitted
alignment alone (no number of the program's): the all-pairs pairs ``i <
j`` (the order of the stage's pairs, x the member of the lower index) whose
x has more than :data:`CAP` residues, at true lengths; and, where the
emitted alignment has more than :data:`CAP` columns (then every join of the
merge ran at a column capacity past it), every join of the merge at its
children's column counts, as the harness's ``Entry.merge_work`` counts
them.  Each member's residues are its row's in the emitted alignment, which
the check holds to the input.  K6 is every ``walk_kernel`` instance built
for the tiled kernel's CTAs (band off, 512 lanes, one CTA an SM:
``csrc/tiled_walk.cuh``), with or without the checkpointed launches, and
not the whole-row DP's (band on, 128 lanes).  Nothing in a cell whose
requests emit no alignment."""

import numpy as np

from benchmark import roofline

CAP = 4095  # the fused kernel's largest row: a cluster of 8 CTAs of 512 lanes, less one
GAP = -1
K6 = r"walk_kernel<[^>]*, false, 512, 1[,>]"  # the trace's demangled kernel names


def tiled_work(run, requests) -> tuple:
    """``(work, pairs, joins)``: the K6 problems of ``requests`` (records
    with an emitted alignment) and how many of each kind."""
    c = run.cell.config
    gaps, A = tuple(c["gap_series"]), len(c["alphabet"])
    pair_ops = roofline.lane_ops(gaps, c["distance_mode"], False)
    join_ops = roofline.lane_ops(gaps, c["merge_mode"], True)
    work, pairs, joins = roofline.Work(), 0, 0
    for r in requests:
        filled = np.asarray(r.output["rows"]) != GAP
        n = filled.shape[0]
        lengths = filled.sum(axis=1).astype(np.float64)
        for i in np.flatnonzero(lengths > CAP).tolist():
            if i + 1 < n:
                ly = lengths[i + 1:]
                work.add_problems(float(lengths[i] * ly.sum()), lengths[i] * ly.size + ly.sum(),
                                  ly.size, A, pair_ops, False)
                pairs += ly.size
        if filled.any(axis=0).sum() > CAP:
            cols = {i: filled[i] for i in range(n)}
            for k, (left, right) in enumerate(r.output["joins"]):
                cl, cr = int(cols[left].sum()), int(cols[right].sum())
                work.add_problems(float(cl) * cr, cl + cr, 1, A, join_ops, True)
                cols[n + k] = cols.pop(left) | cols.pop(right)
                joins += 1
    return work, pairs, joins


def read(run):
    traced = [r for r in run.requests if r.traced and "rows" in r.output]
    if run.trace is None or not traced:
        return None
    seconds = run.trace.layer_seconds([K6])
    if seconds <= 0:
        return None
    work, _, _ = tiled_work(run, traced)
    return 100.0 * roofline.bound_s(work, run.rates) / seconds
