"""The Hopper wavefront DP over ``hs`` (``csrc/wavefront_dp.cu``) and its
wrapper.

Replaces the TPU kernels ``praline_tpu/kernels/strip.py::
wavefront_dp_strip`` and ``praline_tpu/kernels/pallas_dp.py::
wavefront_dp_pallas``: both run the M/Ix/Iy anti-diagonal recurrence, and
differ only in the TPU's lane packing.  The contract here is that of the
plain version, ``kernels/scan.py::wavefront_dp``, bit for bit: scores,
lengths, terminal cells and state codes, and the traceback bytes
``tb uint8[D-2, B, Lp]``.

The kernel walks ``hs`` in lane tiles of W lanes and boxes of T diagonals
on the cluster walk of the other Hopper DPs (``csrc/cluster_walk.cuh``),
in one of two geometries a chunk (:func:`dp_geometry`): "throughput", one
CTA a problem of m narrow tiles, several problems an SM, for chunks that
fill the card; "latency", a cluster of R CTAs of one tile a problem, for
chunks too small to fill it.  In scores mode it runs only the visits that
hold a cell of the problem's band (``0 <= j <= ly``); traceback mode walks
every lane.  The plain twin of that schedule, for the tests, is
``kernels/tiled_dp.py::wavefront_dp_tiled_plain(..., band=True)``; on the
CPU the path is the plain DP.

Bound on the H100: the chain of dependent diagonals inside a problem and
the SM's issue rate over the lane slots the walk runs (:func:`lane_slots`);
see the source.

Taken on the card: every mode, gap series of 1 to 15 levels, buckets up
to 2047 (``Lp <= 2048``).  Anything else raises; nothing falls back.  The
batch driver sends longer rows to the fused kernel
(``kernels/batch.py::choose_route``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import build
from .fused_dp import SMEM_PER_CTA, check_out, check_series, empty_outputs
from .scan import MODES
from .scan import wavefront_dp as wavefront_dp_plain
from .tiled_dp import carry_values, check_hs, smem_layout

launches = 0  # kernel launches by wavefront_dp (not by the plain path)

MAX_LANES = 2048
MAX_TILE_LANES = 128  # W at most: lanes (= threads) of a CTA (csrc/wavefront_dp.cu MAX_W)
MAX_CTAS = 16  # R at most: the H100's non-portable cluster size
BOX_STEPS = 32  # T: diagonals a box, the most the kernel takes
TILE_LANES = 128  # W of the default geometries: a step's barrier spans four warps
# The kernel's launch bound: at least this many CTAs an SM (4: at most 128
# registers a thread; 5: at most 102), csrc/wavefront_dp.cu MINB.
MIN_BLOCKS = (4, 5)
GEOMETRIES = ("throughput", "latency")


def reset_launches() -> None:
    global launches
    launches = 0


@dataclasses.dataclass(frozen=True)
class DpGeometry:
    """A problem's CTAs: ``R`` CTAs of ``m`` tiles of ``W`` lanes, boxes of
    ``T`` diagonals; each CTA's dynamic shared memory (``smem_bytes``);
    ``min_blocks``: the kernel's build for at least that many CTAs an SM.
    The carries of m > 1 tiles wait between visits in a device-memory (L2)
    scratch (``carry_scratch``)."""

    kind: str
    R: int
    m: int
    W: int
    T: int
    smem_bytes: int
    min_blocks: int = MIN_BLOCKS[0]

    @property
    def carry_scratch(self) -> bool:
        return self.m > 1


def geometry(kind: str, Lp: int, k: int, *, tile_lanes: int | None = None,
             ctas: int | None = None, steps: int = BOX_STEPS,
             min_blocks: int = MIN_BLOCKS[0]) -> DpGeometry:
    """The ``kind`` geometry of a problem of ``Lp`` lanes at ``k`` levels
    in tiles of ``tile_lanes`` (:data:`TILE_LANES`): "throughput" one CTA
    of all the tiles; "latency" a cluster of one tile a CTA (at most
    :data:`MAX_CTAS`).  ``ctas`` fixes R (then m is the fewest tiles a CTA
    that cover the row)."""
    if kind not in GEOMETRIES:
        raise ValueError(f"kind must be one of {GEOMETRIES}, got {kind!r}")
    if Lp < 1:
        raise ValueError(f"the DP takes Lp >= 1, got {Lp}")
    W = tile_lanes or TILE_LANES
    tiles = -(-Lp // W)
    R = ctas or (1 if kind == "throughput" else min(MAX_CTAS, tiles))
    m = -(-tiles // R)
    smem, _ = smem_layout(W, steps, m, k, "hs", 0)
    return DpGeometry(kind, R, m, W, steps, smem, min_blocks)


def check_geometry(g: DpGeometry, Lp: int) -> None:
    """Raise for a geometry the kernel does not take."""
    if not (32 <= g.W <= MAX_TILE_LANES and g.W % 32 == 0):
        raise ValueError(f"tile_lanes must be a multiple of 32 from 32 to {MAX_TILE_LANES}, "
                         f"got {g.W}")
    if not 1 <= g.R <= MAX_CTAS:
        raise ValueError(f"ctas must be 1 to {MAX_CTAS}, got {g.R}")
    if not 1 <= g.T <= BOX_STEPS:
        raise ValueError(f"steps must be 1 to {BOX_STEPS}, got {g.T}")
    if g.min_blocks not in MIN_BLOCKS:
        raise ValueError(f"min_blocks must be one of {MIN_BLOCKS}, got {g.min_blocks}")
    if g.R * g.m * g.W < Lp or g.smem_bytes > SMEM_PER_CTA:
        raise ValueError(f"geometry {g} does not cover {Lp} lanes within the shared memory")


_clusters: dict[tuple, int] = {}


def max_active_clusters(k: int, g: DpGeometry) -> int:
    """Clusters (CTAs where R = 1) of this geometry the card holds at once
    (``cudaOccupancyMaxActiveClusters``), asked once per shape."""
    key = (k, g.R, g.m, g.W, g.T, g.min_blocks)
    n = _clusters.get(key)
    if n is None:
        got = ctypes.c_int(0)
        rc = build.load_library().praline_wavefront_dp_clusters(
            k, g.W, g.R, g.m, g.T, g.min_blocks, ctypes.byref(got))
        build.check(rc, "praline_wavefront_dp_clusters")
        n = _clusters[key] = got.value
    return n


def dp_geometry(B: int, Lp: int, k: int, traceback: bool, *,
                clusters=max_active_clusters) -> DpGeometry:
    """The geometry of a chunk of ``B`` problems of ``Lp`` lanes at ``k``
    levels in scores or (``traceback``) traceback mode, from the card's
    occupancy (``clusters(k, geometry)``, its answer by default) and these
    measurements at bucket 1023 and 2047 (PERF.md, Findings):

    - the kernel built for five CTAs an SM (96 registers) is 6-25% faster
      than the one built for four (116) wherever the chunk needs the
      room, but spills at k = 15: it is taken at k <= 3, and the build
      for four wherever the card holds the chunk's clusters without it;
    - a chunk that fills the card runs one CTA a problem ("throughput", R
      = 1): 17.2 ms at 2945 problems of 1023, against 24.96 with two CTAs
      a problem and 32.6 with eight;
    - a smaller one spreads each problem over R CTAs ("latency"): one
      tile a CTA (up to 16) where the chunk's CTAs fit the card in two
      waves (64 x 2047: 16 CTAs a problem in two waves 4.19 ms, 8 CTAs of
      two tiles in one 4.76), else the most CTAs a problem that keep the
      chunk within one wave (256 x 1023 traceback: 2 CTAs of four tiles
      4.79 ms, one tile a CTA 5.14, one CTA a problem 6.85).

    The same thresholds held in both modes, so ``traceback`` does not
    change the choice.  The carries of m > 1 tiles go to the L2 scratch:
    four or five CTAs an SM fit beside it where two fit beside the carries
    of eight tiles in shared memory (18.4 ms at 2945 x 1023 against 27.7)."""
    n = MIN_BLOCKS[1] if k <= 3 else MIN_BLOCKS[0]
    thr = geometry("throughput", Lp, k, min_blocks=n)
    cap = clusters(k, thr)  # CTAs of one problem each the card holds at once
    tiles = -(-Lp // TILE_LANES)
    if B * tiles <= 2 * cap:
        R = min(MAX_CTAS, tiles)
    else:
        R = min(MAX_CTAS, tiles, cap // B)
        if R > 1:
            R = -(-tiles // -(-tiles // R))  # no CTA without a tile
    if R <= 1:
        return thr
    g = geometry("latency", Lp, k, ctas=R, min_blocks=n)
    if n != MIN_BLOCKS[0]:
        four = dataclasses.replace(g, min_blocks=MIN_BLOCKS[0])
        if clusters(k, four) >= B:
            return four
    return g


def lane_slots(lx, ly, D: int, Lp: int, g: DpGeometry, traceback: bool) -> float:
    """Lane slots the kernel runs for problems of true lengths ``lx, ly``
    (numpy or torch, ``[B]``) over ``hs f32[D, B, Lp]`` on geometry ``g``:
    W for every step of every visit a tile runs.  Traceback mode runs every
    tile over diagonals 2 .. D - 1; scores mode, tile by tile, the steps
    max(2, i0) .. min(lx + ly, ie + ly + 1) of its band (ie its last lane
    up to lx), less the step past the band where it alone would open a box
    (``csrc/cluster_walk.cuh``)."""
    lx = np.asarray(lx, dtype=np.int64)
    ly = np.asarray(ly, dtype=np.int64)
    W, T = g.W, g.T
    if traceback:
        return float(len(lx) * -(-Lp // W) * W * (D - 2))
    dend = np.minimum(lx + ly, D - 1)
    lane_end = np.minimum(lx, Lp - 1)
    total = 0.0
    for i0 in range(0, Lp, W):
        ie = np.minimum(i0 + W - 1, lane_end)
        past = ie + ly + 1
        lo, hi = max(2, i0), np.minimum(dend, past)
        alone = (past <= dend) & ((past - 2) % T == 0)
        steps = np.where(i0 <= lane_end, np.maximum(hi - lo + 1, 0) - alone, 0)
        total += float(steps.sum()) * W
    return total


def wavefront_dp(hs, lx, ly, gap_series=(11, 1), mode="global", traceback=False, *,
                 geometry: DpGeometry | None = None, out=None, slots=None):
    """Batched DP over skewed scores ``hs f32[D, B, Lp]`` with per-problem
    lengths ``lx, ly int32[B]`` (``1 <= lx < Lp``, ``1 <= ly <= D - Lp``).
    Same outputs as ``kernels.scan.wavefront_dp``; ``out``, where given, is
    the dict of output tensors written (as ``fused_dp.wavefront_dp_fused``'s).
    CPU tensors take the plain version; CUDA tensors launch the kernel on
    ``geometry`` (by default :func:`dp_geometry`'s), or raise where the card
    cannot hold one of its clusters.  ``slots``, an int64 ``[1]`` tensor on
    the card where given, gets the lane slots the kernel ran added to it (W
    for each step of each visit a tile runs; :func:`lane_slots` is their
    model): a measurement, which the plain version has no counterpart of."""
    if hs.device.type == "cpu":
        if slots is not None:
            raise ValueError("slots counts the kernel's walk; the plain DP runs none")
        got = wavefront_dp_plain(hs, lx, ly, gap_series, mode, traceback)
        if out is None:
            return got
        D, B, Lp = hs.shape
        check_out(out, B, Lp - 1, D - Lp, traceback, hs.device)
        for key, t in out.items():
            t.copy_(got[key])
        return out
    global launches
    k = check_series(gap_series, mode)
    D, B, Lp = check_hs(hs, lx, ly)
    if Lp > MAX_LANES:
        raise NotImplementedError(
            f"the CUDA DP takes Lp <= {MAX_LANES} (bucket 2047), got {Lp}; "
            "longer rows take kernels.fused_dp.wavefront_dp_fused"
        )
    g = geometry or dp_geometry(B, Lp, k, traceback)
    check_geometry(g, Lp)
    if slots is not None and (slots.dtype != torch.int64 or slots.device != hs.device
                              or slots.numel() < 1 or not slots.is_contiguous()):
        raise ValueError("slots must be a contiguous int64 tensor on the DP's device")
    if max_active_clusters(k, g) < 1:
        raise RuntimeError(f"the card cannot hold one cluster of {g.R} CTAs of {g.W} threads "
                           f"and {g.smem_bytes} B of shared memory at k={k}")
    dev = hs.device
    gaps = np.ascontiguousarray(gap_series, dtype=np.float32)
    carry = (torch.empty((B, carry_values(k), Lp), dtype=torch.float32, device=dev)
             if g.carry_scratch else None)
    if out is None:
        out = empty_outputs(B, Lp - 1, D - Lp, traceback, dev)
    check_out(out, B, Lp - 1, D - Lp, traceback, dev)
    tb = out.get("tb")
    lib = build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.praline_wavefront_dp(
            hs.data_ptr(), lx.data_ptr(), ly.data_ptr(),
            gaps.ctypes.data_as(ctypes.c_void_p), k, MODES.index(mode),
            int(traceback), D, B, Lp, g.W, g.R, g.m, g.T, g.min_blocks,
            carry.data_ptr() if carry is not None else None,
            out["score"].data_ptr(), out["length"].data_ptr(),
            out["ti"].data_ptr(), out["tj"].data_ptr(), out["tcode"].data_ptr(),
            tb.data_ptr() if traceback else None,
            slots.data_ptr() if slots is not None else None, stream,
        )
    build.check(rc, "praline_wavefront_dp")
    launches += 1
    return out
