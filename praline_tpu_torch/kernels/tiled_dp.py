"""The Hopper lane-tiled DP (``csrc/tiled_dp.cu``), its plain version and
its wrapper.

Replaces the TPU kernel ``praline_tpu/kernels/pallas_dp_tiled.py::
wavefront_dp_tiled`` (K6): the same DP as the whole-row kernels, walked
one lane tile at a time.  The row is cut into tiles of ``tile_lanes`` (W)
lanes and the diagonals into boxes of ``steps_per_visit`` (T); a visit
runs one box on one tile, and the left neighbour of a tile's first lane
at step t is the previous tile's last lane before its own step t, handed
over through an edge buffer of T entries.  On the card a problem runs on
a thread-block cluster of ``R`` CTAs of ``m`` tiles each
(:func:`tiled_geometry`): in phase p, CTA r visits box p - r on its m
tiles, so a row of any length takes ``(boxes + R - 1) * m * T`` steps in
sequence.  A thread runs one lane, or, in a scores chunk over ``hs`` of
more problems than the card holds such clusters at once, Q = 2 or 3 (a
row on fewer CTAs, so more problems at once: :func:`lanes_geometry`).
This is the route for rows past the fused kernel's 4096 lanes
(``kernels/batch.py::choose_route``).  The contract is that of the plain
DP ``kernels/scan.py::wavefront_dp``, bit for bit: ``score``, ``length``,
``ti``, ``tj``, ``tcode`` and, with traceback, ``tb uint8[D-2, B, Lp]``.
Unlike K6 (k <= 2, ``hs`` only, one of ``length`` / ``tcode``), it takes
every mode, 1 to 15 gap levels and three score sources: ``hs f32[D, B,
Lp]`` (from the producer) or, computed in place, the counts, inverses and
matrix ``(cx, inv_x, cy, inv_y, s)`` ("rows") or a multi-track
:class:`Composite` of them (``csrc/tiled_composite.cu``).

The in-place sources take a score tier, as the fused kernel does
(``tier=``, required there and refused on hs): ``"mma"`` fills each
visit's box of scores on the int8 tensor cores into shared memory before
its steps (``csrc/rows_box.cuh``; only for operands
``fused_scores.tensor_core_exact`` admits; two launches, each problem run
by the one built for whether its y counts pass 255), ``"scalar"``
computes each score in place by f32 dot products (``csrc/fused_rows.cuh``).
Their operands (:class:`InPlaceOperands`, :func:`prepare_operands`) are
made once and passed to every launch of a chunk (``operands=``): the
checkpointed route's forward and resume launches.  The ring's superstep
launch (:func:`wavefront_dp_tiled_ring`) stays on the "scalar" tier, its
operands made once a rank.  :func:`visit_box_plain` is one visit's box in the "mma"
tier's integer arithmetic.

The checkpointed traceback (the counterpart of ``praline_tpu/kernels/
scan.py:173`` ``wavefront_dp_checkpointed``, for tracebacks past the batch
aligner's byte budget) runs on the same kernel, built with the checkpoint
code in (``csrc/tiled_ckpt.cu``; the ordinary launches' kernels are built
without it), in two launches:
:func:`wavefront_dp_tiled_forward` (the terminals and a snapshot of every
lane's carries at the entry of each block of ``interval`` diagonals, no
direction bytes) and :func:`wavefront_dp_tiled_resume` (one block's bytes,
re-derived from its snapshot, byte for byte the traceback launch's rows);
``kernels/replay.py::replay_block`` walks each block.  Their plain versions
are ``kernels/scan.py``'s :func:`~.scan.forward_snapshots` and
:func:`~.scan.resume_block`.

:func:`wavefront_dp_tiled_plain` walks the same visits box by box over
the pieces of ``kernels/scan.py``: each visit comes after the same tile's
visit of the box before and after the previous tile's visit of the same
box, as in the cluster's phase order, so both give the same bits.  The
wrapper takes it for CPU tensors and launches the kernel (or raises) for
CUDA tensors.

Bound on the H100: the chain of dependent diagonals, ``m`` times as long
as one tile's, plus ``R - 1`` boxes to fill the cluster; see the source.

The wrappers' host steps run inside ``util.metrics.span`` ranges, innermost
under the batch drivers' ``dispatch:`` spans: ``tiled:geometry`` (the
cluster, its occupancy query, the carry scratch), ``tiled:operands`` (the
in-place sources' operands), ``tiled:launch`` (the kernel's entry point)
and, on the CPU, ``tiled:plain``.  Each call of :func:`wavefront_dp_tiled`
or :func:`wavefront_dp_tiled_forward` is one chunk of the tiled or the
checkpointed route: it adds ``tiled.chunks:{source}`` (``hs``, ``rows``,
``composite``) and its problems to ``tiled.problems:scores`` or
``tiled.problems:traceback`` in ``METRICS.counters``, host integers from
the source's shape (:func:`count_chunk`); a launch at Q > 1 lanes a thread
adds its problems to ``tiled.problems:q{Q}`` once it is launched
(:func:`count_lanes`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..util.metrics import METRICS, span
from . import build
from .fused_dp import (
    CAND_BYTES, SMEM_PER_CTA, check_out, check_rows, check_series, empty_outputs,
    padded_alphabet, round16,
)
from .fused_scores import TIERS, mma_scratch_bytes, pair_scores_limbs
from .scan import (
    MODES, Recurrence, RingRows, Terminals, _gap_prefix, carries_d1, diagonal_step, edge_of,
    edge_values, forward_snapshots, resume_block, ring_superstep_plain,
)
from .scores import composite_skewed_scores, skewed_pair_scores, track_weight

# Kernel launches (not by the plain paths), one a wrapper call, by score
# source and tier ("hs", or the in-place sources' "mma" and "scalar"): by
# wavefront_dp_tiled on the hs and rows sources and on the composite
# source, and the checkpointed forward and resume launches (any source);
# the ring's superstep launches (one tier, "scalar").  reset_launches sets
# them all to 0.
SOURCE_TIERS = ("hs", *TIERS)
launches = dict.fromkeys(SOURCE_TIERS, 0)
forward_launches = dict.fromkeys(SOURCE_TIERS, 0)
resume_launches = dict.fromkeys(SOURCE_TIERS, 0)
composite_launches = dict.fromkeys(TIERS, 0)
ring_launches = 0

MAX_TILE_LANES = 512  # threads of a CTA at most (csrc/tiled_walk.cuh MAX_W): W / Q
# R at most: the H100's non-portable cluster size (csrc/tiled_dp.cu MAX_R),
# and the default geometry's R: a row spread over more CTAs of narrower
# tiles takes fewer steps or cheaper ones (PERF.md, Findings: the tiled
# kernel's geometries at 4600 x 4400).
MAX_CTAS = 16
# W at least in the default geometry, so that short rows take fewer SMs.
MIN_SPREAD_LANES = 256
# Diagonals a box: the default and the most the kernel takes
# (csrc/tiled_dp.cu MAX_STEPS).
MAX_STEPS = 32
SOURCES = ("hs", "rows", "composite")
MAX_TRACKS = 8  # tracks of a composite on the card (csrc/tiled_composite.cu)
# Lanes a thread (Q) of the throughput geometry (:func:`lanes_geometry`) and
# the gap levels its launches are built for (csrc/tiled_walk.cuh MAX_Q,
# MAX_LANES_K).
LANES_PER_THREAD = (2, 3)
MAX_LANES_K = 3
# A step of a CTA of W lanes takes about as long as W + STEP_FIXED_LANES
# lanes' cells: a fixed part (the barriers, the shuffles, the chain's
# latency) and each lane's issue.  Fitted to K6 over hs on an H100 at 700 W
# (k = 2, global scores, B1 x 4735 x 4607): 0.470 us a step at 320 lanes a
# CTA, 1.232 us at 1248 (3 lanes a thread); 640-960 lanes a CTA fell on the
# same line (PERF.md, Findings: K6 with Q lanes a thread).  It holds for a CTA alone on its
# SM: narrow CTAs of few warps that share an SM ran slower than it says
# (0.74 us a step at 2 lanes a thread on 15 CTAs of 320 lanes), so the
# candidates are CTAs whose shared memory leaves no room for a second.  Not timed at k = 1
# or 3 yet, where a step's cells cost less or more (``chip_smoke.py lanes-times`` gives the
# model's ratio beside the measured one at both).
STEP_FIXED_LANES = 250
CTA_RESERVED_SMEM = 1024  # shared memory an SM reserves for each CTA it holds (sm_90)


@functools.cache
def _sm_shared_memory(device: int) -> int:
    return torch.cuda.get_device_properties(device).shared_memory_per_multiprocessor


def sm_shared_memory() -> int:
    """The shared memory of one SM of the current CUDA device (233,472 B
    on the H100), asked once per device."""
    return _sm_shared_memory(torch.cuda.current_device())


def reset_launches() -> None:
    global ring_launches
    for counts in (launches, forward_launches, resume_launches, composite_launches):
        for key in counts:
            counts[key] = 0
    ring_launches = 0


@dataclasses.dataclass(frozen=True)
class Composite:
    """The multi-track composite score source, computed in place: one
    entry a track of each field (counts ``f32[B, Lx, A_t]``, inverses, the
    track's matrix and its weight); the tracks share ``B``, ``Lx`` and
    ``Ly``.  Its scores are ``kernels/scores.py::composite_skewed_scores``'s,
    bit for bit."""

    cxs: tuple
    inv_xs: tuple
    cys: tuple
    inv_ys: tuple
    ss: tuple
    weights: tuple


def source_kind(source) -> str:
    """``"hs"``, ``"rows"`` or ``"composite"``."""
    if isinstance(source, torch.Tensor):
        return "hs"
    return "composite" if isinstance(source, Composite) else "rows"


def check_tier(kind: str, tier) -> str:
    """The launch counters' key of a source kind and tier: ``"hs"`` for
    the hs source, which takes no tier; the tier for the in-place sources,
    which require one of :data:`~.fused_scores.TIERS`."""
    if kind == "hs":
        if tier is not None:
            raise ValueError(f"the hs source takes no score tier, got {tier!r}")
        return "hs"
    if tier not in TIERS:
        raise ValueError(f"the {kind} source takes tier= one of {TIERS}, got {tier!r}")
    return tier


def source_scores(source) -> torch.Tensor:
    """The skewed scores ``f32[D, B, Lp]`` of a source (the plain
    versions' input)."""
    kind = source_kind(source)
    if kind == "hs":
        return source
    if kind == "rows":
        return skewed_pair_scores(*source)
    c = source
    return composite_skewed_scores(c.cxs, c.inv_xs, c.cys, c.inv_ys, c.ss, c.weights)


def carry_values(k: int) -> int:
    """f32 values a lane carries between visits at ``k`` gap levels
    (``csrc/wavefront.cuh`` ``Carries::NS``; k = 2 collapses to one level)."""
    return 10 + 4 * (1 if k == 2 else k)


def check_hs(hs, lx, ly) -> tuple[int, int, int]:
    """``(D, B, Lp)`` of the hs score source; raises unless ``hs`` and the
    lengths are contiguous tensors of their shapes on one device."""
    if hs.dtype != torch.float32 or hs.dim() != 3 or not hs.is_contiguous():
        raise ValueError("hs must be a contiguous f32[D, B, Lp] tensor")
    D, B, Lp = hs.shape
    if Lp < 2 or D < Lp + 1 or B < 1:
        raise ValueError(f"bad hs shape {tuple(hs.shape)}")
    dev = hs.device
    for name, t in (("lx", lx), ("ly", ly)):
        if t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != (B,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32[{B}] tensor on {dev}")
    return D, B, Lp


def box_depth(T: int) -> int:
    """Diagonals of an "mma" visit's box: T rounded up to whole n-tiles of
    8 (``csrc/rows_box.cuh`` ``box_depth``)."""
    return -(-T // 8) * 8


def box_smem(W: int, T: int) -> int:
    """Shared memory of the "mma" tier's source (``csrc/rows_box.cuh``
    ``BoxLayout``, the wide launch's, the larger): the box, two buffers of
    the rows' limbs, two bands of ``W + box_depth(T)`` columns of ``Cy_lo``
    and of ``Cy_hi`` with their inverses, two buffers of the rows'
    inverses."""
    TB = box_depth(T)
    cols = W + TB
    return (round16(TB * (W + 4) * 4) + 2 * 2 * W * 32 + 4 * cols * 32 + round16(2 * cols * 4)
            + round16(2 * W * 4))


def smem_layout(W: int, T: int, m: int, k: int, source: str,
                budget: int = SMEM_PER_CTA, tier: str | None = None,
                lanes: int = 1) -> tuple[int, bool]:
    """Dynamic shared memory of a CTA of ``W`` lanes, ``lanes`` a thread
    (``csrc/cluster_walk.cuh`` ``WalkLayout``) and whether the carries of
    its ``m`` tiles are in it: the walk's exchange, ring, edge and
    candidates (by warps); the score source's own: on the hs source two
    boxes of scores, on the in-place sources' "mma" tier :func:`box_smem`,
    on their "scalar" tier none; with m > 1 the carries where the whole
    fits in ``budget`` bytes (else they go to a device-memory scratch)."""
    kc = 1 if k == 2 else k
    nx, nw = 6 + 2 * kc, W // lanes // 32
    src = 2 * T * W * 4 if source == "hs" else box_smem(W, T) if tier == "mma" else 0
    total = (round16(2 * nw * nx * 4) + round16(2 * T * nx * 4) + round16(T * nx * 4)
             + round16((nw + 1) * CAND_BYTES) + src)
    carries = carry_values(k) * m * W * 4
    if m > 1 and total + carries <= budget:
        return total + carries, True
    return total, False


@dataclasses.dataclass(frozen=True)
class TiledGeometry:
    """A problem's cluster: ``R`` CTAs of ``m`` tiles of ``W`` lanes, ``Q``
    lanes a thread (so ``W / Q`` threads a CTA), boxes of ``T`` diagonals,
    each CTA's dynamic shared memory (``smem_bytes``) and whether the
    carries need the device-memory scratch (``carry_scratch``: m > 1 and
    they do not fit in shared memory)."""

    R: int
    m: int
    W: int
    T: int
    smem_bytes: int
    carry_scratch: bool
    Q: int = 1


def tiled_geometry(Lp: int, k: int, source: str = "hs", *, problems: int = 1,
                   traceback: bool = False, diagonals: int | None = None,
                   ctas: int | None = None, tile_lanes: int | None = None,
                   steps: int = MAX_STEPS, tier: str | None = None) -> TiledGeometry:
    """The cluster of a problem of ``Lp`` lanes at ``k`` gap levels on
    ``source`` (on the in-place sources, the score ``tier``'s shared
    memory), in a chunk of ``problems`` problems of ``diagonals`` (D) with
    or without ``traceback``.  By default, one lane a thread: the fewest
    tiles a CTA (m) that a cluster of :data:`MAX_CTAS` CTAs of at most
    :data:`MAX_TILE_LANES` lanes allows, then the row spread over that many
    CTAs in tiles of equal width rounded up to a warp, but no narrower than
    :data:`MIN_SPREAD_LANES` (or the lane cap, where it is lower), and the
    fewest CTAs of m such tiles: the least latency for one problem.  A
    scores chunk on hs at k <= :data:`MAX_LANES_K` of more problems than
    the card holds clusters of that shape at once
    (:func:`max_active_clusters`) takes :func:`lanes_geometry`'s choice,
    most often Q > 1 lanes a thread on fewer CTAs, so that more problems
    run at once.  ``tile_lanes`` fixes W and ``ctas`` fixes R (then m is
    the fewest that covers the row); either, or ``steps`` other than
    :data:`MAX_STEPS`, keeps one lane a thread."""
    if source not in SOURCES:
        raise ValueError(f"source must be one of {SOURCES}, got {source!r}")
    if Lp < 1:
        raise ValueError(f"the tiled DP takes Lp >= 1, got {Lp}")
    cap = ctas or MAX_CTAS
    if tile_lanes is None:
        m = -(-Lp // (cap * MAX_TILE_LANES))
        W = -(-(-(-Lp // (cap * m))) // 32) * 32
        if ctas is None:
            W = max(W, min(MIN_SPREAD_LANES, MAX_TILE_LANES))
    else:
        W = tile_lanes
        m = -(-Lp // (cap * W))
    R = ctas or -(-Lp // (m * W))
    smem, carries_in_smem = smem_layout(W, steps, m, k, source, tier=tier)
    g = TiledGeometry(R, m, W, steps, smem, m > 1 and not carries_in_smem)
    if (ctas, tile_lanes, steps) != (None, None, MAX_STEPS) or problems < 2 \
            or not takes_lanes(source, k, traceback) \
            or problems <= max_active_clusters(k, source, g):  # one wave
        return g
    return lanes_geometry(Lp, k, problems, diagonals or 2 * Lp - 1, g)


def takes_lanes(source: str, k: int, traceback: bool) -> bool:
    """Whether a launch may run more than one lane a thread: scores mode
    on the hs source at k <= :data:`MAX_LANES_K` (the launches built so,
    csrc/tiled_walk.cuh)."""
    return source == "hs" and not traceback and k <= MAX_LANES_K


@functools.cache
def lanes_candidates(Lp: int, k: int, sm_smem: int) -> tuple[TiledGeometry, ...]:
    """The Q-lane clusters of one tile a CTA for rows of ``Lp`` lanes at
    ``k`` levels on hs: for Q in :data:`LANES_PER_THREAD` and R = 1 ..
    :data:`MAX_CTAS`, the narrowest W, a multiple of 32 Q of at most 512 Q,
    that R tiles need (where R is the fewest of that W), at the deepest box
    T <= :data:`MAX_STEPS` that its shared memory allows, where that CTA is
    alone on its SM (no room in the SM's ``sm_smem`` bytes for a second);
    built once per row width, level count and card."""
    out = []
    for Q in LANES_PER_THREAD:
        warp = 32 * Q
        for R in range(1, MAX_CTAS + 1):
            W = -(-(-(-Lp // R)) // warp) * warp
            if W > MAX_TILE_LANES * Q or -(-Lp // W) != R:
                continue
            for T in range(MAX_STEPS, 0, -1):
                smem = smem_layout(W, T, 1, k, "hs", lanes=Q)[0]
                if smem <= SMEM_PER_CTA:
                    if 2 * (smem + CTA_RESERVED_SMEM) > sm_smem:
                        out.append(TiledGeometry(R, 1, W, T, smem, False, Q))
                    break
    return tuple(out)


def chunk_time(g: TiledGeometry, k: int, problems: int, diagonals: int) -> int | None:
    """The model of a chunk's time on geometry ``g`` at ``k`` levels over
    hs, in lane-steps: waves x steps x (W + :data:`STEP_FIXED_LANES`),
    waves = ceil(problems / clusters at once), steps = (boxes + R - 1) m T,
    the chain of one problem of ``diagonals`` (D); None where the card
    holds no such cluster."""
    n = max_active_clusters(k, "hs", g)
    if n < 1:
        return None
    steps = (-(-(diagonals - 2) // g.T) + g.R - 1) * g.m * g.T
    return -(-problems // n) * steps * (g.W + STEP_FIXED_LANES)


def lanes_geometry(Lp: int, k: int, problems: int, diagonals: int,
                   one_lane: TiledGeometry) -> TiledGeometry:
    """The geometry of a scores chunk over hs of ``problems`` problems of
    ``Lp`` lanes and ``diagonals`` (D): of ``one_lane`` (the one-lane
    default) and :func:`lanes_candidates` on the current card, the one of
    the least :func:`chunk_time`; ties to the smaller Q, then R."""
    def key(g):
        t = chunk_time(g, k, problems, diagonals)
        return (t is None, t or 0, g.Q, g.R)

    return min([one_lane, *lanes_candidates(Lp, k, sm_shared_memory())], key=key)


def wavefront_dp_tiled_plain(source, lx, ly, gap_series=(11, 1), mode="global",
                             traceback=False, *, tile_lanes=None, ctas=None,
                             steps_per_visit=MAX_STEPS, band=False):
    """The plain version: the kernel's visits over ``kernels/scan.py``'s
    recurrence, at the tile width of :func:`tiled_geometry` (``tile_lanes``
    and ``ctas`` as there; a thread's Q lanes are part of its tile, so the
    Q-lane geometries are tile widths here).  ``source`` is ``hs f32[D, B, Lp]`` or the
    tuple ``(cx, inv_x, cy, inv_y, s)``, whose ``hs`` it builds first.  With
    ``band`` (scores mode only; the whole-row DP's walk,
    ``csrc/wavefront_dp.cu``) each problem runs only the visits and steps
    of its band, as ``csrc/cluster_walk.cuh``'s BAND rule says
    (:func:`_band_walk`)."""
    hs = source_scores(source)
    D, B, Lp = hs.shape
    T = steps_per_visit
    if (tile_lanes is not None and tile_lanes < 1) or (ctas is not None and ctas < 1) or T < 1:
        raise ValueError(f"tile_lanes {tile_lanes}, ctas {ctas} and steps_per_visit {T} "
                         "must be positive")
    W = tiled_geometry(Lp, len(gap_series), ctas=ctas, tile_lanes=tile_lanes, steps=T).W
    rec = Recurrence(gap_series, mode, traceback, D)
    dev = hs.device
    lx = lx.to(dev, torch.int32)
    ly = ly.to(dev, torch.int32)
    term = Terminals(rec, lx, ly)
    if band and not traceback:
        _band_walk(rec, hs, lx, ly, W, T, term)
        return term.result()
    tb = torch.empty((D - 2, B, Lp), dtype=torch.uint8, device=dev) if traceback else None
    # Scores mode skips what reaches no terminal: diagonals past lx + ly and
    # tiles past lx (here for the batch's largest problem, in the kernel per
    # problem).
    dend = D - 1 if traceback else min(D - 1, int((lx + ly).max()))
    lane_end = Lp - 1 if traceback else min(Lp - 1, int(lx.max()))
    tiles = lane_end // W + 1
    lanes = [torch.arange(j * W, min(j * W + W, Lp), device=dev, dtype=torch.int32)[None, :]
             for j in range(tiles)]
    scratch = [carries_d1(rec, lane, B) for lane in lanes]
    edge = [None] * T
    for d0 in range(2, dend + 1, T):
        for j, lane in enumerate(lanes):
            j0, w = j * W, lane.shape[1]
            c = scratch[j]
            for d in range(d0, min(d0 + T - 1, dend) + 1):
                s = d - d0
                left = edge[s] if j > 0 else None
                edge[s] = edge_of(c)
                c, cell = diagonal_step(rec, c, left, d, j0, hs[d, :, j0 : j0 + w])
                term.add(d, j0, lane, cell)
                if traceback:
                    tb[d - 2, :, j0 : j0 + w] = cell["bits"]
            scratch[j] = c
    out = term.result()
    if traceback:
        out["tb"] = tb
    return out


def _poison_edge(B, kc, dev):
    """An edge no step wrote: large positive values and impossible codes,
    so that a cell of the band that read it would differ from the plain
    DP."""
    big = torch.full((B,), 1e29, dtype=torch.float32, device=dev)
    code = torch.full((B,), 29, dtype=torch.int32, device=dev)
    return dict(m1=big, r2v=big, r2l=big, r2c=code, lm1=big, psx=code,
                ix1=[big] * kc, lix1=[big] * kc)


def _select(active, new, old):
    """Per problem (``active`` ``[B]``), ``new`` where active else ``old``,
    over a carries or edge dict."""
    def pick(a, b):
        if isinstance(a, list):
            return [pick(x, y) for x, y in zip(a, b)]
        return torch.where(active.view(-1, *([1] * (a.dim() - 1))), a, b)
    return {key: pick(new[key], old[key]) for key in new}


def _band_walk(rec, hs, lx, ly, W, T, term):
    """Scores mode on ``csrc/cluster_walk.cuh``'s BAND rule, problem by
    problem over the batch: the visit of box d0 .. d1 on the tile of lanes
    i0 .. ie (ie = min(i0 + W - 1, lx)) runs the steps max(d0, i0) ..
    min(d1, ie + ly + 1) where max(d0, i0) <= min(d1, ie + ly), starting
    from the tile's d = 1 carries where d0 <= i0; a visit that does not run
    hands on only edge slot 0, from its carries.  A problem's carries move
    only at its own steps, and edge slots that the previous tile did not
    write this box are poisoned, so a rule that let a cell of the band read
    what no step wrote would not give the plain DP's bits."""
    D, B, Lp = hs.shape
    dev = hs.device
    dend = torch.clamp(lx + ly, max=D - 1)
    lane_end = torch.clamp(lx, max=Lp - 1)
    tiles = int(lane_end.max()) // W + 1
    lanes = [torch.arange(j * W, min(j * W + W, Lp), device=dev, dtype=torch.int32)[None, :]
             for j in range(tiles)]
    init = [carries_d1(rec, lane, B) for lane in lanes]
    scratch = list(init)
    for d0 in range(2, int(dend.max()) + 1, T):
        d1 = torch.clamp(dend, max=d0 + T - 1)
        edge_in = [None] * T
        for j, lane in enumerate(lanes):
            i0 = j * W
            ie = torch.clamp(lane_end, max=i0 + W - 1)
            first = torch.full_like(ie, max(d0, i0))
            last = torch.minimum(d1, ie + ly + 1)
            runs = (i0 <= lane_end) & (d0 <= dend) & (first <= torch.minimum(d1, ie + ly))
            c = _select(runs & (d0 <= i0), init[j], scratch[j])
            edge_out = [_poison_edge(B, rec.kc, dev) for _ in range(T)]
            skipped = (i0 <= lane_end) & (d0 <= dend) & ~runs
            edge_out[0] = _select(skipped, edge_of(c), edge_out[0])
            for d in range(d0, min(d0 + T - 1, D - 1) + 1):
                s = d - d0
                active = runs & (first <= d) & (d <= last)
                if not bool(active.any()):
                    continue
                left = edge_in[s] if j > 0 else None
                edge_out[s] = _select(active, edge_of(c), edge_out[s])
                new, cell = diagonal_step(rec, c, left, d, i0, hs[d, :, i0 : i0 + lane.shape[1]])
                term.add(d, i0, lane, cell, active)
                c = _select(active, new, c)
            scratch[j] = c
            edge_in = edge_out


_clusters: dict[tuple, int] = {}

# The cluster queries of each kernel family: (source, checkpointed, tier).
_CLUSTERS = {("composite", True, "scalar"): "praline_tiled_composite_clusters",
             ("composite", True, "mma"): "praline_tiled_composite_mma_clusters",
             ("ring", False, None): "praline_tiled_ring_clusters",
             ("rows", False, "mma"): "praline_tiled_mma_clusters",
             ("rows", True, "mma"): "praline_tiled_ckpt_mma_clusters"}


def max_active_clusters(k: int, source: str, geometry: TiledGeometry,
                        ckpt: bool = False, tier: str | None = None) -> int:
    """Clusters of this geometry the card holds at once
    (``cudaOccupancyMaxActiveClusters``) for the ordinary launches or, with
    ``ckpt``, the checkpointed ones (``csrc/tiled_ckpt.cu``; the composite
    source has one kernel for both; source "ring": the ring's launch,
    ``csrc/tiled_ring.cu``), on the in-place sources' ``tier`` (on "mma"
    the wide launch's, ``csrc/rows_box.cuh``), asked once per shape."""
    g = geometry
    ckpt = ckpt or source == "composite"
    key = (k, source, g.R, g.m, g.W, g.T, g.Q, ckpt, tier)
    n = _clusters.get(key)
    if n is None:
        got = ctypes.c_int(0)
        lib = build.load_library()
        name = _CLUSTERS.get((source, ckpt, tier))
        if name is not None:
            rc = getattr(lib, name)(k, g.W, g.R, g.m, g.T, ctypes.byref(got))
        elif ckpt:
            name = "praline_tiled_ckpt_clusters"
            rc = lib.praline_tiled_ckpt_clusters(k, int(source == "hs"), g.W, g.R, g.m, g.T,
                                                 ctypes.byref(got))
        else:
            name = "praline_tiled_dp_clusters"
            rc = lib.praline_tiled_dp_clusters(k, int(source == "hs"), g.W, g.R, g.m, g.T, g.Q,
                                               ctypes.byref(got))
        build.check(rc, name)
        n = _clusters[key] = got.value
    return n


def check_geometry(g: TiledGeometry, Lp: int, k: int, source: str, traceback: bool) -> None:
    """Raise for a geometry the kernel does not take."""
    if g.Q != 1 and not (g.Q in LANES_PER_THREAD and g.m == 1
                         and takes_lanes(source, k, traceback)):
        raise ValueError(f"{g.Q} lanes a thread: only {LANES_PER_THREAD}, one tile a CTA, in "
                         f"scores mode on the hs source at k <= {MAX_LANES_K}")
    if not (32 * g.Q <= g.W <= MAX_TILE_LANES * g.Q and g.W % (32 * g.Q) == 0):
        raise ValueError(f"tile_lanes must be a multiple of {32 * g.Q} from {32 * g.Q} to "
                         f"{MAX_TILE_LANES * g.Q} at {g.Q} lanes a thread, got {g.W}")
    if not 1 <= g.R <= MAX_CTAS:
        raise ValueError(f"ctas must be 1 to {MAX_CTAS}, got {g.R}")
    if not 1 <= g.T <= MAX_STEPS:
        raise ValueError(f"steps_per_visit must be 1 to {MAX_STEPS}, got {g.T}")
    if g.R * g.m * g.W < Lp or g.smem_bytes > SMEM_PER_CTA:
        raise ValueError(f"geometry {g} does not cover {Lp} lanes within the shared memory")


def problem_shape(source) -> tuple[int, int, int]:
    """``(B, Lx, Ly)`` of a score source."""
    kind = source_kind(source)
    if kind == "hs":
        D, B, Lp = source.shape
        return B, Lp - 1, D - Lp
    cx, cy = (source.cxs[0], source.cys[0]) if kind == "composite" else (source[0], source[2])
    return cx.shape[0], cx.shape[1], cy.shape[1]


def source_device(source) -> torch.device:
    """The device of a score source's tensors."""
    kind = source_kind(source)
    return (source if kind == "hs" else source.cxs[0] if kind == "composite"
            else source[0]).device


def _check_composite(c: Composite, lx, ly) -> tuple[int, int, int, list[int]]:
    """``(B, Lx, Ly, alphabets)`` of a composite; raises unless every
    track's operands are the rows source's and the tracks share their
    shape."""
    n = len(c.cxs)
    if not 1 <= n <= MAX_TRACKS or not all(
            len(f) == n for f in (c.inv_xs, c.cys, c.inv_ys, c.ss, c.weights)):
        raise ValueError(f"a composite takes 1 to {MAX_TRACKS} tracks, one entry each")
    shapes = [check_rows(*ops, lx, ly) for ops in zip(c.cxs, c.inv_xs, c.cys, c.inv_ys, c.ss)]
    if len({sh[:3] for sh in shapes}) != 1 or len({t.device for t in c.cxs}) != 1:
        raise ValueError("the tracks of a composite must share B, Lx, Ly and the device")
    B, Lx, Ly, _ = shapes[0]
    return B, Lx, Ly, [sh[3] for sh in shapes]


@dataclasses.dataclass(frozen=True)
class InPlaceOperands:
    """What the in-place sources' launches read, made once by
    ``praline_tiled_prep`` (``csrc/tiled_mma.cu``) for B problems of
    ``rows`` x ``Ly``: one ``scratch`` tensor a track (on "mma" the limbs
    and flags of ``csrc/score_box.cuh``, ``mma_scratch_bytes``; on "scalar"
    ``T = Cx @ S`` and ``Cy`` rows padded to ``padded_alphabet(A)``
    floats), each track's alphabet, and on "mma" ``pwide u8[B]``: 1 where a
    count of problem b's y passes 255 on some track."""

    tier: str
    B: int
    rows: int
    Ly: int
    scratch: tuple
    alphabets: tuple
    pwide: torch.Tensor | None


def _tracks(source) -> list[tuple]:
    """``(cx, cy, s)`` of each track of an in-place source."""
    if source_kind(source) == "composite":
        return list(zip(source.cxs, source.cys, source.ss))
    return [(source[0], source[2], source[4])]


def prepare_operands(source, tier: str) -> InPlaceOperands:
    """The operands of the in-place ``source`` (the rows tuple or a
    :class:`Composite`, on a card) on ``tier``, on the current stream."""
    check_tier(source_kind(source), tier)
    tracks = _tracks(source)
    cx0, cy0, _ = tracks[0]
    B, Lx, _ = cx0.shape
    Ly = cy0.shape[1]
    dev = cx0.device
    pwide = torch.zeros(B, dtype=torch.uint8, device=dev) if tier == "mma" else None
    scratch = []
    lib = build.load_library()
    with span("tiled:operands"), torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for cx, cy, s in tracks:
            A = cx.shape[2]
            nbytes = (mma_scratch_bytes(B, Lx, Ly) if tier == "mma"
                      else B * (Lx + Ly) * padded_alphabet(A) * 4)
            scratch.append(torch.empty(nbytes, dtype=torch.uint8, device=dev))
            rc = lib.praline_tiled_prep(cx.data_ptr(), cy.data_ptr(), s.data_ptr(), B, Lx, Ly, A,
                                        TIERS.index(tier), scratch[-1].data_ptr(),
                                        pwide.data_ptr() if pwide is not None else None, stream)
            build.check(rc, "praline_tiled_prep")
    return InPlaceOperands(tier, B, Lx, Ly, tuple(scratch),
                           tuple(cx.shape[2] for cx, _, _ in tracks), pwide)


def _operands_for(source, tier, operands) -> InPlaceOperands:
    """``operands`` where given (checked against the source), else made."""
    if operands is None:
        return prepare_operands(source, tier)
    B, Lx, Ly = problem_shape(source)
    if (operands.tier, operands.B, operands.rows, operands.Ly, len(operands.scratch)) != (
            tier, B, Lx, Ly, len(_tracks(source))):
        raise ValueError(f"operands of tier {operands.tier!r} for {operands.B} x "
                         f"{operands.rows} x {operands.Ly} do not fit this {tier!r} launch")
    return operands


# The in-place launches' entry points: (source, checkpointed, tier).
_ENTRIES = {("rows", False, "scalar"): "praline_tiled_dp_rows",
            ("rows", False, "mma"): "praline_tiled_mma_rows",
            ("rows", True, "scalar"): "praline_tiled_ckpt_rows",
            ("rows", True, "mma"): "praline_tiled_ckpt_mma_rows",
            ("composite", False, "scalar"): "praline_tiled_dp_composite",
            ("composite", True, "scalar"): "praline_tiled_dp_composite",
            ("composite", False, "mma"): "praline_tiled_composite_mma",
            ("composite", True, "mma"): "praline_tiled_composite_mma"}


def _launch(source, lx, ly, gap_series, mode, traceback, out, ckpt, geometry, tier, operands):
    """One launch of the tiled kernel on ``source``'s entry point: ``out``
    the dict of output tensors (``score`` .. ``tcode`` and, where written,
    ``tb``), ``ckpt`` ``(snap, interval, block, cum0)`` or None, geometry
    the keyword arguments of :func:`tiled_geometry`, ``tier`` the in-place
    sources' (None on hs) and ``operands`` their :class:`InPlaceOperands`
    (None: made here)."""
    k = check_series(gap_series, mode)
    kind = source_kind(source)
    if kind == "hs":
        D, B, Lp = check_hs(source, lx, ly)
    elif kind == "rows":
        B, Lx, Ly, _ = check_rows(*source, lx, ly)
        D, Lp = Lx + Ly + 1, Lx + 1
    else:
        B, Lx, Ly, _ = _check_composite(source, lx, ly)
        D, Lp = Lx + Ly + 1, Lx + 1
    dev = source_device(source)
    with span("tiled:geometry"):
        g = tiled_geometry(Lp, k, kind, problems=B, traceback=traceback or ckpt is not None,
                           diagonals=D, tier=tier, **geometry)
        check_geometry(g, Lp, k, kind, traceback or ckpt is not None)
        if ckpt is not None and ckpt[1] % g.T:
            raise ValueError(f"the interval {ckpt[1]} must be a multiple of the box depth {g.T}")
        if max_active_clusters(k, kind, g, ckpt is not None, tier) < 1:
            raise RuntimeError(f"the card cannot hold one cluster of {g.R} CTAs of {g.W} "
                               f"threads and {g.smem_bytes} B of shared memory at k={k} on the "
                               f"{kind} source" + (f" ({tier!r} tier)" if tier else ""))
        gaps = np.ascontiguousarray(gap_series, dtype=np.float32)
        f32 = dict(dtype=torch.float32, device=dev)
        carry = torch.empty((B, carry_values(k), Lp), **f32) if g.carry_scratch else None
    tb = out.get("tb")
    outs = (carry.data_ptr() if carry is not None else None, out["score"].data_ptr(),
            out["length"].data_ptr(), out["ti"].data_ptr(), out["tj"].data_ptr(),
            out["tcode"].data_ptr(), tb.data_ptr() if tb is not None else None)
    snap, interval, block, cum0 = ckpt or (None, 0, -1, 0.0)
    # the ordinary launches take no checkpoint arguments (csrc/tiled_dp.cu)
    checkpoints = (snap.data_ptr(), interval, block, cum0) if ckpt is not None else ()
    series = (gaps.ctypes.data_as(ctypes.c_void_p), k, MODES.index(mode), int(traceback))
    shape = (g.W, g.R, g.m, g.T)
    lib = build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kind == "hs":
            # the ordinary launch over hs takes Q lanes a thread after the shape
            name, lanes = (("praline_tiled_ckpt_hs", ()) if ckpt is not None
                           else ("praline_tiled_dp_hs", (g.Q,)))
            with span("tiled:launch"):
                rc = getattr(lib, name)(source.data_ptr(), lx.data_ptr(), ly.data_ptr(), *series,
                                        D, B, Lp, *shape, *lanes, *outs, *checkpoints, stream)
            build.check(rc, name)
            count_lanes(g, B)
            return
        ops = _operands_for(source, tier, operands)
        pwide = ops.pwide.data_ptr() if ops.pwide is not None else None
        name = _ENTRIES[(kind, ckpt is not None, tier)]
        with span("tiled:launch"):
            if kind == "rows":
                rc = getattr(lib, name)(ops.scratch[0].data_ptr(), pwide, source[1].data_ptr(),
                                        source[3].data_ptr(), lx.data_ptr(), ly.data_ptr(),
                                        *series, B, Lx, Ly, padded_alphabet(ops.alphabets[0]),
                                        *shape, *outs, *checkpoints, stream)
            else:
                n = len(ops.scratch)

                def ptrs(ts):
                    return (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))

                weights = np.array([float(track_weight(w)) for w in source.weights], np.float32)
                aps = (ctypes.c_int * n)(*(padded_alphabet(A) for A in ops.alphabets))
                checkpoints = (snap.data_ptr() if snap is not None else None, interval, block,
                               cum0)
                rc = getattr(lib, name)(
                    n, ptrs(ops.scratch), ptrs(source.inv_xs), ptrs(source.inv_ys), aps,
                    weights.ctypes.data_as(ctypes.c_void_p), pwide, lx.data_ptr(),
                    ly.data_ptr(), *series, B, Lx, Ly, *shape, *outs, *checkpoints, stream)
    build.check(rc, name)


def count_lanes(g: TiledGeometry, problems: int) -> None:
    """A launch of ``problems`` problems on ``g`` into ``METRICS.counters``:
    ``tiled.problems:q{Q}`` where it ran Q > 1 lanes a thread (host
    integers, no device sync)."""
    if g.Q > 1:
        METRICS.count(f"tiled.problems:q{g.Q}", problems)


def count_chunk(source, traceback: bool) -> None:
    """One chunk of the tiled or checkpointed route into ``METRICS.counters``:
    ``tiled.chunks:{source kind}`` and its problems under
    ``tiled.problems:scores`` or ``tiled.problems:traceback`` (from the
    source's shape: no device sync)."""
    METRICS.count(f"tiled.chunks:{source_kind(source)}", 1)
    METRICS.count(f"tiled.problems:{'traceback' if traceback else 'scores'}",
                  problem_shape(source)[0])


def wavefront_dp_tiled(source, lx, ly, gap_series=(11, 1), mode="global", traceback=False,
                       *, tier: str | None = None, tile_lanes=None, ctas=None,
                       steps_per_visit=MAX_STEPS, out=None):
    """Batched DP of ``source`` (``hs f32[D, B, Lp]``, ``(cx f32[B, Lx,
    A], inv_x f32[B, Lx], cy f32[B, Ly, A], inv_y f32[B, Ly], s f32[A, A])``
    with ``Lp = Lx + 1``, or a :class:`Composite` of such tracks) with true
    lengths ``lx, ly int32[B]``, on the cluster of :func:`tiled_geometry`
    for the chunk (``tile_lanes`` W a multiple of 32 up to 512, ``ctas`` R
    from 1 to 16, ``steps_per_visit`` T from 1 to 32: any of them fixed,
    one lane a thread).  ``tier`` ("mma", only for
    operands ``fused_scores.tensor_core_exact`` admits, or "scalar") is
    required on the in-place sources and refused on hs, their operands made
    for the launch (:func:`prepare_operands`).  Same outputs as
    :func:`wavefront_dp_tiled_plain` and ``kernels.scan.wavefront_dp``;
    ``out``, where given, is the dict of output tensors written (as
    ``fused_dp.wavefront_dp_fused``'s).  CPU tensors take the plain version;
    CUDA tensors launch the kernel, or raise where the card cannot hold one
    cluster of the geometry."""
    key = check_tier(source_kind(source), tier)
    geometry = dict(ctas=ctas, tile_lanes=tile_lanes, steps=steps_per_visit)
    count_chunk(source, traceback)
    if source_device(source).type == "cpu":
        with span("tiled:plain"):
            got = wavefront_dp_tiled_plain(source, lx, ly, gap_series, mode, traceback,
                                           tile_lanes=tile_lanes, ctas=ctas,
                                           steps_per_visit=steps_per_visit)
        if out is None:
            return got
        check_out(out, *problem_shape(source), traceback, got["score"].device)
        for k, t in out.items():
            t.copy_(got[k])
        return out
    B, Lx, Ly = problem_shape(source)
    dev = source_device(source)
    if out is None:
        out = empty_outputs(B, Lx, Ly, traceback, dev)
    check_out(out, B, Lx, Ly, traceback, dev)
    _launch(source, lx, ly, gap_series, mode, traceback, out, None, geometry, tier, None)
    (composite_launches if source_kind(source) == "composite" else launches)[key] += 1
    return out


def wavefront_dp_tiled_forward(source, lx, ly, gap_series, mode, interval, *, tier=None,
                               operands=None, tile_lanes=None, ctas=None,
                               steps_per_visit=MAX_STEPS):
    """The forward launch of the checkpointed traceback on ``source`` (as
    :func:`wavefront_dp_tiled`'s, ``tier`` too; ``operands``, where given,
    are the source's :func:`prepare_operands` on ``tier``): returns
    ``(out, snap)``, ``out`` the terminal dict of the traceback launch and
    ``snap f32[nblk, B, NS, Lp]`` each lane's carries at the entry of every
    block of ``interval`` diagonals (a multiple of the box depth on the
    card), block q at diagonal 2 + q interval, nblk = ceil((D - 2) /
    interval).  CPU tensors take :func:`~.scan.forward_snapshots`."""
    key = check_tier(source_kind(source), tier)
    count_chunk(source, True)
    if source_device(source).type == "cpu":
        with span("tiled:plain"):
            return forward_snapshots(source_scores(source), lx, ly, gap_series, mode, interval)
    B, Lx, Ly = problem_shape(source)
    dev = source_device(source)
    D, Lp = Lx + Ly + 1, Lx + 1
    out = empty_outputs(B, Lx, Ly, False, dev)
    nblk = -(-(D - 2) // interval)
    snap = torch.empty((nblk, B, carry_values(len(gap_series)), Lp), dtype=torch.float32,
                       device=dev)
    _launch(source, lx, ly, gap_series, mode, False, out, (snap, interval, -1, 0.0),
            dict(ctas=ctas, tile_lanes=tile_lanes, steps=steps_per_visit), tier, operands)
    forward_launches[key] += 1
    return out, snap


def wavefront_dp_tiled_resume(source, lx, ly, gap_series, mode, interval, block, snap, *,
                              tier=None, operands=None, out=None, tile_lanes=None, ctas=None,
                              steps_per_visit=MAX_STEPS):
    """The resume launch of block ``block``: its direction bytes ``uint8[
    interval, B, Lp]`` (row r = diagonal 2 + block interval + r), re-derived
    from ``snap`` (:func:`wavefront_dp_tiled_forward`'s), byte for byte the
    traceback launch's rows; rows past D - 1 are not written on the card
    (0 in the plain version).  ``tier`` and ``operands`` as
    :func:`wavefront_dp_tiled_forward`'s; ``out``, where given, is the
    tensor written.  CPU tensors take :func:`~.scan.resume_block`."""
    key = check_tier(source_kind(source), tier)
    if source_device(source).type == "cpu":
        return resume_block(source_scores(source), snap, block, interval, gap_series, mode, out)
    B, Lx, Ly = problem_shape(source)
    dev = source_device(source)
    Lp = Lx + 1
    if out is None:
        out = torch.empty((interval, B, Lp), dtype=torch.uint8, device=dev)
    if out.dtype != torch.uint8 or tuple(out.shape) != (interval, B, Lp) \
            or not out.is_contiguous() or out.device != dev:
        raise ValueError(f"out must be a contiguous uint8[{interval}, {B}, {Lp}] tensor on {dev}")
    k = len(gap_series)
    if snap.dtype != torch.float32 or snap.dim() != 4 or tuple(snap.shape[1:]) != (
            B, carry_values(k), Lp) or not snap.is_contiguous() or snap.device != dev \
            or not 0 <= block < snap.shape[0]:
        raise ValueError(f"snap must be the forward launch's f32[nblk, {B}, {carry_values(k)}, "
                         f"{Lp}] with block {block} in it")
    d0 = 2 + block * interval
    cum0 = float(_gap_prefix(tuple(gap_series), d0 - 1)[d0 - 1])
    scratch = empty_outputs(B, Lx, Ly, False, dev)
    scratch["tb"] = out
    _launch(source, lx, ly, gap_series, mode, True, scratch, (snap, interval, block, cum0),
            dict(ctas=ctas, tile_lanes=tile_lanes, steps=steps_per_visit), tier, operands)
    resume_launches[key] += 1
    return out


def visit_box_plain(source, d0: int, i0: int, steps: int, lanes: int) -> torch.Tensor:
    """One visit's box ``f32[steps, B, lanes]`` of the "mma" tier
    (``csrc/rows_box.cuh``): the scores of walk lanes ``i0 .. i0 + lanes -
    1`` at diagonals ``d0 .. d0 + steps - 1`` of the in-place ``source``
    (the rows tuple, or a :class:`Composite`, whose tracks' boxes are
    weighted and summed in track order), from the int64 limb arithmetic of
    the tile's rows and the band's columns alone
    (``fused_scores.pair_scores_limbs``), +0 off the problem: lane i's score
    at diagonal d is ``H[i - 1, d - i - 1]``."""
    if source_kind(source) == "composite":
        c = source
        acc = None
        for ops in zip(c.cxs, c.inv_xs, c.cys, c.inv_ys, c.ss, c.weights):
            term = visit_box_plain(ops[:5], d0, i0, steps, lanes) * track_weight(ops[5])
            acc = term if acc is None else acc + term
        return acc
    cx, inv_x, cy, inv_y, s = source
    B, Lx, _ = cx.shape
    Ly = cy.shape[1]
    r0, r1 = max(i0 - 1, 0), min(i0 - 1 + lanes, Lx)  # the tile's rows of x
    jb = d0 - i0 - lanes  # the band's column 0
    j0, j1 = max(jb, 0), min(jb + lanes + steps - 1, Ly)  # its columns within y
    box = torch.zeros((B, steps, lanes), dtype=torch.float32)
    if r0 < r1 and j0 < j1:
        h = pair_scores_limbs(cx[:, r0:r1], inv_x[:, r0:r1], cy[:, j0:j1], inv_y[:, j0:j1], s)
        m = torch.arange(lanes)[None, :]
        r = i0 + m - 1
        j = d0 + torch.arange(steps)[:, None] - (i0 + m) - 1
        valid = (r >= r0) & (r < r1) & (j >= j0) & (j < j1)
        got = h[:, (r - r0).clamp(0, r1 - r0 - 1).expand(steps, lanes),
                (j - j0).clamp(0, j1 - j0 - 1)]
        box = torch.where(valid[None], got, box)
    return box.permute(1, 0, 2).contiguous()


# ---- the ring's superstep launch (dist/ring.py) --------------------------------


# T at most in a ring launch's default geometry: a launch walks one chunk,
# so its cluster fills every superstep: (K / T + R - 1) m T steps in
# sequence, and a smaller box cuts the fill for one cluster barrier more a
# box.  At the titin pair's rank shape (17,216 lanes, R = 15, m = 3, K = 32)
# one launch took 1.88-1.90 ms at T = 32, 0.65-0.66 at 8, 0.47 at 4 and
# 0.40-0.46 at 2, on an H100 80GB HBM3 at 700 W (chip_smoke.py's
# long-times; PERF.md, Findings).  The ring stays on the rows source's
# "scalar" tier: the "mma" tier, its box filled before each visit, took
# 0.57 ms at T = 2, 0.47-0.48 at 4 and 0.48-0.50 at 8 there, slower at
# every T than the scalar tier at T = 2.
RING_MAX_STEPS = 2


def ring_steps(K: int) -> int:
    """The box depth T of a ring launch of K diagonals: the largest divisor
    of K up to :data:`RING_MAX_STEPS`, so that every box of a chunk is
    whole."""
    return max(t for t in range(1, RING_MAX_STEPS + 1) if K % t == 0)


def _check_ring(rows: RingRows, lx, ly, gap_series, d0, K, carries, heads, tails, cand, tb,
                tb_row0, carries_out, cand_out) -> int:
    """Raise unless the ring launch's tensors are the contiguous f32 / int32
    / u8 tensors of their shapes on the rows' device; the chunk's last
    diagonal."""
    dev, B, Lpn, D = rows.device, rows.B, rows.Lpn, rows.D
    k = len(gap_series)
    d1 = min(d0 + K - 1, D - 1)
    if K < 1 or not 2 <= d0 <= d1:
        raise ValueError(f"a chunk of {K} diagonals at {d0} is outside 2 .. {D - 1}")
    if (heads is None) != (rows.base == 0):
        raise ValueError("heads are required on every rank but lane 0's, and refused there")

    def want(t, name, shape, dtype=torch.float32):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype}{list(shape)} tensor on {dev}")

    for name, t in (("carries", carries), ("carries_out", carries_out)):
        if t is not None:
            want(t, name, (B, carry_values(k), Lpn))
    for name, t in (("heads", heads), ("tails", tails)):
        if t is not None:
            want(t, name, (K, edge_values(k), B))
    for name, t in (("cand", cand), ("cand_out", cand_out)):
        if t is not None:
            want(t, name, (5, B))
    for name, t in (("lx", lx), ("ly", ly)):
        want(t, name, (B,), torch.int32)
    if tb is not None:
        if tb.device != dev or tb.dtype != torch.uint8 or tb.dim() != 3 \
                or tuple(tb.shape[1:]) != (B, Lpn) or not tb.is_contiguous():
            raise ValueError(f"tb must be a contiguous uint8[rows, {B}, {Lpn}] tensor on {dev}")
        if not (0 <= d0 - 2 - tb_row0 and d1 - 2 - tb_row0 < tb.shape[0]):
            raise ValueError(f"tb's rows from diagonal {2 + tb_row0} miss {d0} .. {d1}")
    return d1


def ring_operands(rows: RingRows) -> InPlaceOperands:
    """The rank's "scalar" :class:`InPlaceOperands` for its ``Lpn``
    lane-indexed rows, made once a rank and kept in ``rows.scratch``."""
    if "operands" not in rows.scratch:
        rows.scratch["operands"] = prepare_operands(
            (rows.cx, rows.inv_x, rows.cy, rows.inv_y, rows.s), "scalar")
    return rows.scratch["operands"]


def wavefront_dp_tiled_ring(rows: RingRows, lx, ly, gap_series, mode, traceback, d0: int,
                            K: int, carries, heads, tails, cand, *, tb=None, tb_row0: int = 0,
                            carries_out=None, cand_out=None, tile_lanes=None, ctas=None,
                            steps_per_visit=None):
    """One superstep of the ring on one rank (``dist/ring.py``): diagonals
    d0 .. min(d0 + K - 1, D - 1) on the rank's lanes ``rows`` (a
    :class:`~.scan.RingRows`), the contract of
    :func:`~.scan.ring_superstep_plain` (carries, heads, tails, candidate
    and the chunk's bytes, in place unless ``carries_out`` / ``cand_out`` are
    given).  CPU tensors take the plain version; CUDA tensors launch the
    tiled kernel built with its ring flag on the rows source's "scalar"
    tier (``csrc/tiled_ring.cu``), its operands made once a rank
    (:func:`ring_operands`), on the cluster of :func:`tiled_geometry` for
    Lpn lanes (``tile_lanes``, ``ctas``; ``steps_per_visit`` T default
    :func:`ring_steps`), or raise where the card cannot hold one cluster of
    it."""
    d1 = _check_ring(rows, lx, ly, gap_series, d0, K, carries, heads, tails, cand, tb, tb_row0,
                     carries_out, cand_out)
    if rows.device.type == "cpu":
        ring_superstep_plain(rows, lx, ly, gap_series, mode, traceback, d0, K, carries, heads,
                             tails, cand, tb=tb, tb_row0=tb_row0, carries_out=carries_out,
                             cand_out=cand_out)
        return
    global ring_launches
    k = check_series(gap_series, mode)
    if traceback and tb is None:
        raise ValueError("a traceback launch writes into tb")
    dev, B, Lpn = rows.device, rows.B, rows.Lpn
    g = tiled_geometry(Lpn, k, "rows", ctas=ctas, tile_lanes=tile_lanes,
                       steps=steps_per_visit or ring_steps(K), tier="scalar")
    check_geometry(g, Lpn, k, "rows", traceback)
    if Lpn < 2:
        raise ValueError(f"a ring launch takes at least 2 lanes a rank, got {Lpn}")
    if max_active_clusters(k, "ring", g) < 1:
        raise RuntimeError(f"the card cannot hold one cluster of {g.R} CTAs of {g.W} threads "
                           f"and {g.smem_bytes} B of shared memory at k={k} for the ring")
    lib = build.load_library()
    f32 = dict(dtype=torch.float32, device=dev)
    ops = ring_operands(rows)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = torch.empty((B, carry_values(k), Lpn), **f32) if g.carry_scratch else None
        gaps = np.ascontiguousarray(gap_series, dtype=np.float32)
        cum0 = float(_gap_prefix(tuple(gap_series), d0 - 1)[d0 - 1])
        rc = lib.praline_tiled_ring(
            ops.scratch[0].data_ptr(), rows.inv_x.data_ptr(), rows.inv_y.data_ptr(),
            lx.data_ptr(), ly.data_ptr(),
            gaps.ctypes.data_as(ctypes.c_void_p), k, MODES.index(mode), int(traceback),
            B, rows.Lx, rows.Ly, padded_alphabet(ops.alphabets[0]), Lpn, rows.base, d0, d1,
            cum0, g.W, g.R, g.m, g.T,
            carries.data_ptr(), (carries if carries_out is None else carries_out).data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            heads.data_ptr() if heads is not None else None, tails.data_ptr(),
            cand.data_ptr(), (cand if cand_out is None else cand_out).data_ptr(),
            tb.data_ptr() if traceback else None, tb.shape[0] if traceback else 0, tb_row0,
            stream)
    build.check(rc, "praline_tiled_ring")
    ring_launches += 1
