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
sequence; this is the route for rows past the fused kernel's 4096 lanes
(``kernels/batch.py::choose_route``).  The contract is that of the plain
DP ``kernels/scan.py::wavefront_dp``, bit for bit: ``score``, ``length``,
``ti``, ``tj``, ``tcode`` and, with traceback, ``tb uint8[D-2, B, Lp]``.
Unlike K6 (k <= 2, ``hs`` only, one of ``length`` / ``tcode``), it takes
every mode, 1 to 15 gap levels and two score sources: ``hs f32[D, B, Lp]``
(from the producer) or, computed in place, the counts, inverses and
matrix ``(cx, inv_x, cy, inv_y, s)``.

:func:`wavefront_dp_tiled_plain` walks the same visits box by box over
the pieces of ``kernels/scan.py``: each visit comes after the same tile's
visit of the box before and after the previous tile's visit of the same
box, as in the cluster's phase order, so both give the same bits.  The
wrapper takes it for CPU tensors and launches the kernel (or raises) for
CUDA tensors.

Bound on the H100: the chain of dependent diagonals, ``m`` times as long
as one tile's, plus ``R - 1`` boxes to fill the cluster; see the source.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import build
from .fused_dp import (
    CAND_BYTES, SMEM_PER_CTA, check_out, check_rows, check_series, empty_outputs,
    padded_alphabet, round16,
)
from .scan import MODES, Recurrence, Terminals, carries_d1, diagonal_step, edge_of
from .scores import skewed_pair_scores

launches = 0  # kernel launches by wavefront_dp_tiled (not by the plain path)

MAX_TILE_LANES = 512  # W at most: lanes (= threads) of a CTA (csrc/tiled_dp.cu MAX_W)
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
SOURCES = ("hs", "rows")


def reset_launches() -> None:
    global launches
    launches = 0


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


def smem_layout(W: int, T: int, m: int, k: int, source: str,
                budget: int = SMEM_PER_CTA) -> tuple[int, bool]:
    """Dynamic shared memory of a CTA (``csrc/cluster_walk.cuh``
    ``WalkLayout``) and whether the carries of its ``m`` tiles are in it:
    the walk's exchange, ring, edge and candidates; on the hs source two
    boxes of scores; with m > 1 the carries where the whole fits in
    ``budget`` bytes (else they go to a device-memory scratch)."""
    kc = 1 if k == 2 else k
    nx, nw = 6 + 2 * kc, W // 32
    total = (round16(2 * nw * nx * 4) + round16(2 * T * nx * 4) + round16(T * nx * 4)
             + round16((nw + 1) * CAND_BYTES) + (2 * T * W * 4 if source == "hs" else 0))
    carries = carry_values(k) * m * W * 4
    if m > 1 and total + carries <= budget:
        return total + carries, True
    return total, False


@dataclasses.dataclass(frozen=True)
class TiledGeometry:
    """A problem's cluster: ``R`` CTAs of ``m`` tiles of ``W`` lanes, boxes
    of ``T`` diagonals, each CTA's dynamic shared memory (``smem_bytes``)
    and whether the carries need the device-memory scratch
    (``carry_scratch``: m > 1 and they do not fit in shared memory)."""

    R: int
    m: int
    W: int
    T: int
    smem_bytes: int
    carry_scratch: bool


def tiled_geometry(Lp: int, k: int, source: str = "hs", *, ctas: int | None = None,
                   tile_lanes: int | None = None, steps: int = MAX_STEPS) -> TiledGeometry:
    """The cluster of a problem of ``Lp`` lanes at ``k`` gap levels on
    ``source``.  By default: the fewest tiles a CTA (m) that a cluster of
    :data:`MAX_CTAS` CTAs of at most :data:`MAX_TILE_LANES` lanes allows,
    then the row spread over that many CTAs in tiles of equal width
    rounded up to a warp, but no narrower than :data:`MIN_SPREAD_LANES`
    (or the lane cap, where it is lower), and the fewest CTAs of m such
    tiles.  ``tile_lanes`` fixes W and ``ctas`` fixes R (then m is the
    fewest that covers the row)."""
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
    smem, carries_in_smem = smem_layout(W, steps, m, k, source)
    return TiledGeometry(R, m, W, steps, smem, m > 1 and not carries_in_smem)


def wavefront_dp_tiled_plain(source, lx, ly, gap_series=(11, 1), mode="global",
                             traceback=False, *, tile_lanes=None, ctas=None,
                             steps_per_visit=MAX_STEPS, band=False):
    """The plain version: the kernel's visits over ``kernels/scan.py``'s
    recurrence, at the tile width of :func:`tiled_geometry` (``tile_lanes``
    and ``ctas`` as there).  ``source`` is ``hs f32[D, B, Lp]`` or the tuple
    ``(cx, inv_x, cy, inv_y, s)``, whose ``hs`` it builds first.  With
    ``band`` (scores mode only; the whole-row DP's walk,
    ``csrc/wavefront_dp.cu``) each problem runs only the visits and steps
    of its band, as ``csrc/cluster_walk.cuh``'s BAND rule says
    (:func:`_band_walk`)."""
    hs = source if isinstance(source, torch.Tensor) else skewed_pair_scores(*source)
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


def max_active_clusters(k: int, source: str, geometry: TiledGeometry) -> int:
    """Clusters of this geometry the card holds at once
    (``cudaOccupancyMaxActiveClusters``), asked once per shape."""
    g = geometry
    key = (k, source, g.R, g.m, g.W, g.T)
    n = _clusters.get(key)
    if n is None:
        got = ctypes.c_int(0)
        rc = build.load_library().praline_tiled_dp_clusters(
            k, int(source == "hs"), g.W, g.R, g.m, g.T, ctypes.byref(got))
        build.check(rc, "praline_tiled_dp_clusters")
        n = _clusters[key] = got.value
    return n


def check_geometry(g: TiledGeometry, Lp: int) -> None:
    """Raise for a geometry the kernel does not take."""
    if not (32 <= g.W <= MAX_TILE_LANES and g.W % 32 == 0):
        raise ValueError(f"tile_lanes must be a multiple of 32 from 32 to {MAX_TILE_LANES}, "
                         f"got {g.W}")
    if not 1 <= g.R <= MAX_CTAS:
        raise ValueError(f"ctas must be 1 to {MAX_CTAS}, got {g.R}")
    if not 1 <= g.T <= MAX_STEPS:
        raise ValueError(f"steps_per_visit must be 1 to {MAX_STEPS}, got {g.T}")
    if g.R * g.m * g.W < Lp or g.smem_bytes > SMEM_PER_CTA:
        raise ValueError(f"geometry {g} does not cover {Lp} lanes within the shared memory")


def wavefront_dp_tiled(source, lx, ly, gap_series=(11, 1), mode="global", traceback=False,
                       *, tile_lanes=None, ctas=None, steps_per_visit=MAX_STEPS, out=None):
    """Batched DP of ``source`` (``hs f32[D, B, Lp]``, or ``(cx f32[B, Lx,
    A], inv_x f32[B, Lx], cy f32[B, Ly, A], inv_y f32[B, Ly], s f32[A, A])``
    with ``Lp = Lx + 1``) with true lengths ``lx, ly int32[B]``, on the
    cluster of :func:`tiled_geometry` (``tile_lanes`` W a multiple of 32 up
    to 512, ``ctas`` R from 1 to 16, ``steps_per_visit`` T from 1 to 32).
    Same outputs as :func:`wavefront_dp_tiled_plain` and
    ``kernels.scan.wavefront_dp``; ``out``, where given, is the dict of
    output tensors written (as ``fused_dp.wavefront_dp_fused``'s).  CPU
    tensors take the plain version; CUDA tensors launch the kernel, or
    raise where the card cannot hold one cluster of the geometry."""
    from_hs = isinstance(source, torch.Tensor)
    if (source if from_hs else source[0]).device.type == "cpu":
        got = wavefront_dp_tiled_plain(source, lx, ly, gap_series, mode, traceback,
                                       tile_lanes=tile_lanes, ctas=ctas,
                                       steps_per_visit=steps_per_visit)
        if out is None:
            return got
        check_out(out, *_problem_shape(source), traceback, got["score"].device)
        for key, t in out.items():
            t.copy_(got[key])
        return out
    global launches
    k = check_series(gap_series, mode)
    if from_hs:
        D, B, Lp = check_hs(source, lx, ly)
        dev = source.device
    else:
        B, Lx, Ly, A = check_rows(*source, lx, ly)
        D, Lp = Lx + Ly + 1, Lx + 1
        dev = source[0].device
    kind = "hs" if from_hs else "rows"
    g = tiled_geometry(Lp, k, kind, ctas=ctas, tile_lanes=tile_lanes, steps=steps_per_visit)
    check_geometry(g, Lp)
    if max_active_clusters(k, kind, g) < 1:
        raise RuntimeError(f"the card cannot hold one cluster of {g.R} CTAs of {g.W} threads "
                           f"and {g.smem_bytes} B of shared memory at k={k} on the {kind} source")
    gaps = np.ascontiguousarray(gap_series, dtype=np.float32)
    f32 = dict(dtype=torch.float32, device=dev)
    carry = torch.empty((B, carry_values(k), Lp), **f32) if g.carry_scratch else None
    if out is None:
        out = empty_outputs(B, Lp - 1, D - Lp, traceback, dev)
    check_out(out, B, Lp - 1, D - Lp, traceback, dev)
    tb = out.get("tb")
    outs = (carry.data_ptr() if carry is not None else None, out["score"].data_ptr(),
            out["length"].data_ptr(), out["ti"].data_ptr(), out["tj"].data_ptr(),
            out["tcode"].data_ptr(), tb.data_ptr() if traceback else None)
    series = (gaps.ctypes.data_as(ctypes.c_void_p), k, MODES.index(mode), int(traceback))
    shape = (g.W, g.R, g.m, g.T)
    lib = build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if from_hs:
            rc = lib.praline_tiled_dp_hs(source.data_ptr(), lx.data_ptr(), ly.data_ptr(),
                                         *series, D, B, Lp, *shape, *outs, stream)
        else:
            AP = padded_alphabet(A)
            t_rows = torch.empty((B, Lx, AP), **f32)
            cy_rows = torch.empty((B, Ly, AP), **f32)
            rc = lib.praline_tiled_dp_rows(*(t.data_ptr() for t in source), lx.data_ptr(),
                                           ly.data_ptr(), *series, B, Lx, Ly, A, *shape,
                                           t_rows.data_ptr(), cy_rows.data_ptr(), *outs,
                                           stream)
    build.check(rc, "praline_tiled_dp_hs" if from_hs else "praline_tiled_dp_rows")
    launches += 1
    return out


def _problem_shape(source) -> tuple[int, int, int]:
    """``(B, Lx, Ly)`` of a score source."""
    if isinstance(source, torch.Tensor):
        D, B, Lp = source.shape
        return B, Lp - 1, D - Lp
    return source[0].shape[0], source[0].shape[1], source[2].shape[1]
