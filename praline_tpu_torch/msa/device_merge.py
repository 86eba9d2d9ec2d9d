"""Device-resident progressive merge: the whole guide-tree walk enqueued on
the card, one host copy at the end.

Counterpart of ``praline_tpu/msa/device_merge.py`` (``try_device_merge``
``:334-491``, ``_assemble`` ``:494-520``).  A node table
(``kernels/compose.py::NodeTable``) holds every tree node's profile on
the device, a slot a node.  Each tree level gathers its joins' operands
from the table, runs one ``(C_cap, C_cap)`` traceback problem a join
through the batched aligner's route (``kernels/batch.py::choose_route`` and
``dispatch``: producer + whole-row DP up to 2047 columns, the fused kernel
up to 4095, the tiled kernel past it, then the walk), and composes the
merged profiles into the table with the compose kernel
(``kernels/compose.py::compose``).  Nothing is read back while the levels
are enqueued: route, geometry, score tier and chunk size come from sizes
the host knows, and dependent levels simply follow each other on the
stream, so the reference's chained ``lax.scan`` (``CHAIN_K``) and its pow2
join pads, which exist to cut TPU dispatches, have no counterpart.  The
host then copies every level's full-coverage move tape back at once
(:func:`collect_walk`) and injects the gaps into the member rows
(:func:`_assemble`, numpy as in the reference).

Every join shares one column capacity ``C_cap``; a merged profile longer
than it is seen in the copied tape lengths, and the walk reruns at the
next rung of :func:`ladder` (at most :data:`MAX_ATTEMPTS`, none past
:data:`LADDER_TOP`, the largest traceback problem the card takes).  The port's
rungs step by ``BUCKET_STEP`` (128) columns above 127 rather than the
reference's 2^n - 1: the traceback DP at 2047 costs about 3.8 times one at
1023 on the H100 (PERF.md), and a rung that stops near the longest leaf
keeps every join's DP small.

The producer's score tier cannot come from statistics of merged nodes (the
host has no copy of them).  It comes from upper bounds carried along the
tree on the host (:func:`node_bounds`, the proof is there), and a level
takes the tensor-core tier only where ``fused_scores.tensor_core_exact``
admits every join's bounds.

The host's steps are ``merge:`` spans (``util/metrics.py::span``):
``merge:plan``, ``merge:enqueue`` (around ``merge:table``, the chunks'
``dispatch:`` spans and ``merge:compose``), ``merge:collect`` and
``merge:assemble``.  ``METRICS.counters`` takes ``merge.cells_launched``
(joins times ``C_cap**2``, every rung tried) and ``merge.cells_needed``
(``cols_left * cols_right`` of each emitted join).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import batch
from ..kernels.compose import NodeTable, column_inverses, compose, inverse_table
from ..kernels.fused_scores import MAX_BATCH, SideStats, matrix_stats, score_tier, side_stats
from ..kernels.replay import moves_to_result
from ..kernels.scan import MODES
from ..oracle.merge import inject_gaps, reorder_to_input
from ..oracle.profile import COUNT_LIMIT, member_profile, rescale_counts
from ..types import Alignment, PralineConfig, Profile, ScoreMatrix, Sequence, SequenceTree
from ..util.metrics import METRICS, span

# The rungs of the column-capacity ladder: 63 and 127, then steps of
# batch.BUCKET_STEP, stopping at the two-kernel and fused lane caps
# (batch._bucket) and at LADDER_TOP.  Rung k of a walk holds
# int(HEADROOM**k * the longest leaf) + 1 columns.
LADDER_BASE = (63, 127)
HEADROOM = 1.25
MAX_ATTEMPTS = 3


# The largest rung: the reference's (``praline_tpu/msa/device_merge.py:57``,
# C_BUCKETS[-1]), and the largest ladder size (127 + 128 k) whose (C, C)
# traceback, (2C - 1)(C + 1) bytes, fits the unscaled
# batch.TB_BYTES_BUDGET.  A constant: the card's scaled budgets (which
# take full tracebacks far past it) do not change which families the
# device walk takes.
LADDER_TOP = 32767


def ladder(max_len: int) -> tuple[int, ...]:
    """The column capacities a walk tries in turn, at most
    :data:`MAX_ATTEMPTS`: rung k the smallest ladder size holding
    ``int(HEADROOM**k * max_len) + 1`` columns, or :data:`LADDER_TOP` where
    that is more; none past ``LADDER_TOP`` (empty where ``max_len`` exceeds
    it, as the reference gives up past its largest rung)."""
    if max_len > LADDER_TOP:
        return ()
    rungs: list[int] = []
    for k in range(1, MAX_ATTEMPTS + 1):
        want = max(int(HEADROOM**k * max_len) + 1, rungs[-1] + 1 if rungs else max_len)
        rung = batch._bucket(min(want, LADDER_TOP), LADDER_BASE)
        if rungs and rung <= rungs[-1]:
            break
        rungs.append(rung)
    return tuple(rungs)


def node_bounds(leaves: list[SideStats], tree: SequenceTree, max_s: float) -> list[SideStats]:
    """Upper bounds of every tree node's exactness statistics (the leaves'
    own first, then node n + k for join k), from the leaves' alone.

    Proof.  A merged column holds the left child's column, the right
    child's, or the sum of both (a gap side adds to the gap count only), so
    before the rescale each count is at most ``cmax(l) + cmax(r)`` and the
    column total at most ``tot(l) + tot(r)``.  A column that is not
    rescaled has counts plus gaps of at most ``COUNT_LIMIT``, so its counts
    and total are at most ``COUNT_LIMIT`` too.  A rescaled column (n =
    counts + gaps > ``COUNT_LIMIT``) takes ``q = floor(256 c / n + 1/2)``:
    ``q = 0`` for ``c = 0``, and ``q <= 256 c / 993 + 1/2 < c`` for ``c >=
    1``, so each count and the total only shrink; and the counts sum to at
    most ``256 + A / 2`` (``sum c <= n``), below ``COUNT_LIMIT``.  Hence
    ``cmax(n + k) <= min(cmax(l) + cmax(r), COUNT_LIMIT)`` and the same for
    ``tot``.  Integer counts stay integers (sums, and q an
    integer), so ``ints`` is the leaves' conjunction.  ``|counts @ S|`` of a
    column is at most its total times ``max |S|``, the ``tmax`` bound.

    With these, ``tensor_core_exact`` of a join's bounds implies it of the
    true statistics (every predicate is monotone in them).  P2 (y counts at
    most 65535) holds at every node, whose counts are at most
    ``COUNT_LIMIT``; P3-P5 hold wherever the merge's own guard
    ``bound**2 * max|S| < 2**24`` does, since every ``tot`` bound is at most
    ``bound``.  So a level leaves the tensor cores only above a leaf whose
    counts are not all integers (P1)."""
    out = [SideStats(st.ints, st.cmax, st.tot, st.tot * max_s) for st in leaves]
    for l, r in tree.joins:
        a, b = out[l], out[r]
        tot = min(a.tot + b.tot, COUNT_LIMIT)
        out.append(SideStats(a.ints and b.ints, min(a.cmax + b.cmax, COUNT_LIMIT), tot,
                             tot * max_s))
    return out


@dataclasses.dataclass
class MergePlan:
    """What the host knows before a walk: the rescaled leaves, the joins in
    walk order grouped by level, each level's score tier, the rungs."""

    sequences: list[Sequence]
    tree: SequenceTree
    leaves: list[Profile]
    levels: list[list[int]]
    tiers: list[str]
    rungs: tuple[int, ...]
    inv_table: np.ndarray
    s: np.ndarray
    gap_series: tuple[int, ...]
    mode: str

    @property
    def order(self) -> list[int]:
        """Join indices in walk order: row r of a walk's tapes is join
        ``order[r]``."""
        return [k for level in self.levels for k in level]


def plan_merge(sequences: list[Sequence], tree: SequenceTree, matrix: ScoreMatrix,
               config: PralineConfig) -> MergePlan | None:
    """The host's plan of a device walk, or None under the reference's
    conditions (``praline_tpu/msa/device_merge.py:350-373``): a merge mode
    other than global, semiglobal and local; fewer than two sequences or an
    empty one; leaf totals past the exactness bound ``bound**2 *
    max|S| < 2**24``, ``bound = max(largest leaf total, COUNT_LIMIT + A)``;
    or a leaf longer than the largest rung (``:380-386``).  The rungs are
    the :func:`ladder` of the longest leaf."""
    from .pipeline import _merge_levels

    if config.merge_mode not in MODES:
        return None
    if len(sequences) < 2 or any(s.length == 0 for s in sequences):
        return None
    # leaves enter as node_profile builds them: preprofile counts rescaled
    leaves = []
    for seq in sequences:
        p = member_profile(seq)
        c, g = rescale_counts(p.counts, p.gaps)
        leaves.append(Profile(c, g, p.alphabet))
    A = matrix.alphabet.size
    max_total = max(float(p.counts.sum(axis=1).max(initial=1.0)) for p in leaves)
    max_s = float(np.abs(matrix.scores).max())
    bound = max(max_total, COUNT_LIMIT + A)
    if bound * bound * max_s >= 2**24:
        return None
    rungs = ladder(max(p.length for p in leaves))
    if not rungs:
        return None
    s = matrix.as_f32()
    bounds = node_bounds([side_stats(p.counts) for p in leaves], tree, max_s)
    m_stats = matrix_stats(s)
    levels = _merge_levels(tree)
    tiers = ["mma" if all(score_tier(bounds[tree.joins[k][0]], bounds[tree.joins[k][1]], m_stats)
                          == "mma" for k in level) else "scalar" for level in levels]
    return MergePlan(list(sequences), tree, leaves, levels, tiers, rungs, inverse_table(max_total),
                     s, tuple(config.gap_series), config.merge_mode)


@dataclasses.dataclass
class Walk:
    """One enqueued walk at capacity ``C_cap``: the node table and, row r
    for join ``plan.order[r]``, the full-coverage tapes ``uint8[joins,
    2 C_cap]`` and their lengths ``int32[joins]``, all on the device;
    and the ``route`` every level took."""

    C_cap: int
    table: NodeTable
    tapes: torch.Tensor
    nmv: torch.Tensor
    route: str


def enqueue_walk(plan: MergePlan, C_cap: int, device) -> Walk:
    """Build the node table at ``C_cap`` columns on ``device`` and enqueue
    every level: operands gathered from the table, the DP of
    ``choose_route(C_cap, C_cap)`` with traceback and the walk
    (``batch.dispatch``), then the compose kernel into the table.  Reads
    nothing back from the device (on the card no call here synchronizes;
    ``chip_smoke.py`` runs it under ``torch.cuda.set_sync_debug_mode
    ("error")``).  A route the card refuses raises, as the per-level path
    would."""
    dev = resolve_device(device)
    n = len(plan.leaves)
    with span("merge:table"):
        M = 2 * n - 1  # a slot a tree node
        A = plan.s.shape[0]
        route = batch.choose_route(dev, C_cap, C_cap, True)
        counts = np.zeros((M, C_cap, A), dtype=np.float32)
        gaps = np.zeros((M, C_cap), dtype=np.float32)
        lens = np.ones(M, dtype=np.int32)
        mems = np.ones(M, dtype=np.int32)
        for i, p in enumerate(plan.leaves):
            counts[i, : p.length] = p.counts
            gaps[i, : p.length] = p.gaps
            lens[i] = p.length
        inv = column_inverses(counts, plan.inv_table)
        table = NodeTable(*(batch.upload(a, dev) for a in (counts, gaps, inv, lens, mems)))
        inv_dev = batch.upload(plan.inv_table, dev)
        s_dev = batch.upload(np.ascontiguousarray(plan.s), dev)
        order = plan.order
        joins = plan.tree.joins
        idx = batch.upload(np.array([[joins[k][0] for k in order], [joins[k][1] for k in order],
                                     [n + k for k in order]], dtype=np.int32), dev)
        steps = 2 * C_cap
        tapes = torch.empty((len(order), steps), dtype=torch.uint8, device=dev)
        nmv = torch.empty(len(order), dtype=torch.int32, device=dev)
        budget = batch.dispatch_budget(dev)
    row = 0
    for level, tier in zip(plan.levels, plan.tiers):
        per_problem = batch.chunk_problem_bytes(route, dev, C_cap, C_cap, A, True, tier,
                                                len(plan.gap_series))
        size = max(1, min(MAX_BATCH, budget // per_problem))
        for a in range(row, row + len(level), size):
            b = min(a + size, row + len(level))
            li, ri, oi = idx[0, a:b], idx[1, a:b], idx[2, a:b]
            out = batch.dispatch(
                route, table.counts.index_select(0, li), table.inv.index_select(0, li),
                table.counts.index_select(0, ri), table.inv.index_select(0, ri), s_dev,
                table.lens.index_select(0, li), table.lens.index_select(0, ri),
                gap_series=plan.gap_series, mode=plan.mode, traceback=True, tier=tier,
            )
            with span("merge:compose"):
                compose(out["moves"], out["nmoves"], out["ti"], out["tj"], table, li, ri, oi,
                        inv_dev, plan.mode, tape_out=tapes[a:b], nmv_out=nmv[a:b])
            del out
        row += len(level)
    return Walk(C_cap, table, tapes, nmv, route)


def collect_walk(plan: MergePlan, walk: Walk) -> Alignment | None:
    """The walk's one host copy (every tape and length at once), then the
    alignment, or None where a merged profile outgrew the capacity."""
    with span("merge:collect"):
        if walk.tapes.device.type == "cuda":
            tapes = torch.empty(walk.tapes.shape, dtype=torch.uint8, pin_memory=True)
            nmv = torch.empty(walk.nmv.shape, dtype=torch.int32, pin_memory=True)
            tapes.copy_(walk.tapes, non_blocking=True)
            nmv.copy_(walk.nmv, non_blocking=True)
            torch.cuda.current_stream(walk.tapes.device).synchronize()
        else:
            tapes, nmv = walk.tapes, walk.nmv
        ncols = nmv.numpy().astype(np.int64)
        if int(ncols.max(initial=0)) > walk.C_cap:
            return None
        order = plan.order
        moves_all = np.empty_like(tapes.numpy())
        moves_all[order] = tapes.numpy()
        by_join = np.empty_like(ncols)
        by_join[order] = ncols
    with span("merge:assemble"):
        return _assemble(plan.sequences, plan.tree, moves_all, by_join)


def try_device_merge(sequences: list[Sequence], tree: SequenceTree, matrix: ScoreMatrix,
                     config: PralineConfig, *, device="cuda") -> Alignment | None:
    """The whole merge stage on ``device`` (the card unless the caller asks
    for ``"cpu"``), or None, for the caller's per-level path, under the
    reference's conditions: those of :func:`plan_merge`, or every rung
    overflowing."""
    with span("merge:plan"):
        plan = plan_merge(sequences, tree, matrix, config)
    return None if plan is None else merge_on_device(plan, device)


def merge_on_device(plan: MergePlan, device) -> Alignment | None:
    """Walk ``plan`` at each of its rungs in turn until the merged profiles
    fit; None where none does.  Notes in ``METRICS``: ``merge_attempts``,
    and where it returns an alignment ``merge_walk`` ("device"),
    ``merge_rung`` and ``merge_route``; each rung tried adds its joins times
    ``C_cap**2`` to ``METRICS.counters["merge.cells_launched"]``."""
    tried = []
    for C_cap in plan.rungs:
        tried.append(C_cap)
        METRICS.count("merge.cells_launched", len(plan.order) * C_cap * C_cap)
        with span("merge:enqueue"):
            walk = enqueue_walk(plan, C_cap, device)
        merged = collect_walk(plan, walk)
        METRICS.note("merge_attempts", list(tried))
        if merged is not None:
            METRICS.note("merge_walk", "device")
            METRICS.note("merge_rung", C_cap)
            METRICS.note("merge_route", walk.route)
            return merged
        del walk
    return None


def _assemble(sequences: list[Sequence], tree: SequenceTree, moves_all: np.ndarray,
              ncols: np.ndarray) -> Alignment:
    """Inject gaps along the returned per-join paths (host, vectorized)."""
    nodes: dict[int, Alignment] = {i: Alignment.single(seq) for i, seq in enumerate(sequences)}
    n = tree.num_leaves
    cells = 0
    for k, (l, r) in enumerate(tree.joins):
        left, right = nodes.pop(l), nodes.pop(r)
        res = moves_to_result(moves_all[k], int(ncols[k]), 0.0, 0, 0, left.num_columns,
                              right.num_columns, "global")
        cells += left.num_columns * right.num_columns
        rows = inject_gaps(left.rows, right.rows, res.cols_x, res.cols_y)
        nodes[n + k] = Alignment(left.members + right.members, rows)
    METRICS.add_pairs("merge", len(tree.joins), float(cells))
    METRICS.count("merge.cells_needed", cells)
    return reorder_to_input(nodes[tree.root], sequences)
