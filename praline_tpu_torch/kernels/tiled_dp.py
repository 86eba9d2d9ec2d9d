"""The Hopper lane-tiled DP (``csrc/tiled_dp.cu``), its plain version and
its wrapper.

Replaces the TPU kernel ``praline_tpu/kernels/pallas_dp_tiled.py::
wavefront_dp_tiled`` (K6): the same DP as the whole-row kernels, walked
one lane tile at a time.  For each block of ``steps_per_visit`` (T)
diagonals the walk visits the tiles of ``tile_lanes`` (W) lanes from left
to right; a visit loads the tile's carries, runs T diagonals and stores
them back, and the left neighbour of a tile's first lane at step t is the
previous tile's last lane before its own step t, handed over through an
edge buffer of T entries.  Only one tile's carries are live at a time, so
on the card a row of any length fits one block's registers: this is the
route for rows past the fused kernel's 4096 lanes
(``kernels/batch.py::choose_route``).  The contract is that of the plain
DP ``kernels/scan.py::wavefront_dp``, bit for bit: ``score``, ``length``,
``ti``, ``tj``, ``tcode`` and, with traceback, ``tb uint8[D-2, B, Lp]``.
Unlike K6 (k <= 2, ``hs`` only, one of ``length`` / ``tcode``), it takes
every mode, 1 to 15 gap levels and two score sources: ``hs f32[D, B, Lp]``
(from the producer) or, computed in place, the counts, inverses and
matrix ``(cx, inv_x, cy, inv_y, s)``.

:func:`wavefront_dp_tiled_plain` walks the same (diagonal block, tile,
step) order with the same edge hand-off over the pieces of
``kernels/scan.py``; the wrapper takes it for CPU tensors and launches the
kernel (or raises) for CUDA tensors.

Bound on the H100: the chain of diagonals, ``n_tiles`` times as long (a
problem runs ``D * n_tiles`` tile steps in sequence), plus one round trip
of the carries through L2 per T diagonals; see the source.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .fused_dp import check_rows, check_series, padded_alphabet
from .scan import MODES, Recurrence, Terminals, carries_d1, diagonal_step, edge_of
from .scores import skewed_pair_scores
from .wavefront import check_hs

launches = 0  # kernel launches by wavefront_dp_tiled (not by the plain path)

MAX_TILE_LANES = 1024  # threads a block (csrc/wavefront.cuh MAXT)
# Diagonals a visit: the default and the most the kernel takes
# (csrc/tiled_dp.cu MAX_STEPS, the edge buffer's depth).
MAX_STEPS = 32


def reset_launches() -> None:
    global launches
    launches = 0


def carry_values(k: int) -> int:
    """f32 values a lane carries between visits at ``k`` gap levels
    (``csrc/wavefront.cuh`` ``Carries::NS``; k = 2 collapses to one level)."""
    return 10 + 4 * (1 if k == 2 else k)


def tile_width(Lp: int, tile_lanes: int | None = None) -> int:
    """Lanes a tile: ``tile_lanes``, or by default the row cut into the
    fewest tiles of at most :data:`MAX_TILE_LANES`, of equal width rounded
    up to a warp."""
    if tile_lanes is not None:
        return tile_lanes
    n = -(-Lp // MAX_TILE_LANES)
    per_tile = -(-Lp // n)
    return -(-per_tile // 32) * 32


def wavefront_dp_tiled_plain(source, lx, ly, gap_series=(11, 1), mode="global",
                             traceback=False, *, tile_lanes=None,
                             steps_per_visit=MAX_STEPS):
    """The plain version: the kernel's walk over ``kernels/scan.py``'s
    recurrence.  ``source`` is ``hs f32[D, B, Lp]`` or the tuple
    ``(cx, inv_x, cy, inv_y, s)``, whose ``hs`` it builds first."""
    hs = source if isinstance(source, torch.Tensor) else skewed_pair_scores(*source)
    D, B, Lp = hs.shape
    W = tile_width(Lp, tile_lanes)
    T = steps_per_visit
    if W < 1 or T < 1:
        raise ValueError(f"tile_lanes {W} and steps_per_visit {T} must be positive")
    rec = Recurrence(gap_series, mode, traceback, D)
    dev = hs.device
    lx = lx.to(dev, torch.int32)
    ly = ly.to(dev, torch.int32)
    term = Terminals(rec, lx, ly)
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


def wavefront_dp_tiled(source, lx, ly, gap_series=(11, 1), mode="global", traceback=False,
                       *, tile_lanes=None, steps_per_visit=MAX_STEPS):
    """Batched DP of ``source`` (``hs f32[D, B, Lp]``, or ``(cx f32[B, Lx,
    A], inv_x f32[B, Lx], cy f32[B, Ly, A], inv_y f32[B, Ly], s f32[A, A])``
    with ``Lp = Lx + 1``) with true lengths ``lx, ly int32[B]``, ``W =
    tile_lanes`` lanes a tile (on the card a multiple of 32 up to 1024;
    default :func:`tile_width`) and ``T = steps_per_visit`` diagonals a
    visit (1 to 32).  Same outputs as :func:`wavefront_dp_tiled_plain` and
    ``kernels.scan.wavefront_dp``.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise)."""
    from_hs = isinstance(source, torch.Tensor)
    if (source if from_hs else source[0]).device.type == "cpu":
        return wavefront_dp_tiled_plain(source, lx, ly, gap_series, mode, traceback,
                                        tile_lanes=tile_lanes, steps_per_visit=steps_per_visit)
    global launches
    k = check_series(gap_series, mode)
    if from_hs:
        D, B, Lp = check_hs(source, lx, ly)
        dev = source.device
    else:
        B, Lx, Ly, A = check_rows(*source, lx, ly)
        D, Lp = Lx + Ly + 1, Lx + 1
        dev = source[0].device
    W = tile_width(Lp, tile_lanes)
    T = steps_per_visit
    if not (32 <= W <= MAX_TILE_LANES and W % 32 == 0):
        raise ValueError(f"tile_lanes must be a multiple of 32 from 32 to {MAX_TILE_LANES}, got {W}")
    if not 1 <= T <= MAX_STEPS:
        raise ValueError(f"steps_per_visit must be 1 to {MAX_STEPS}, got {T}")
    gaps = np.ascontiguousarray(gap_series, dtype=np.float32)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    carry = torch.empty((B, carry_values(k), Lp), **f32)
    out = {
        "score": torch.empty(B, **f32),
        "length": torch.empty(B, **f32),
        "ti": torch.empty(B, **i32),
        "tj": torch.empty(B, **i32),
        "tcode": torch.empty(B, **i32),
    }
    tb = torch.empty((D - 2, B, Lp), dtype=torch.uint8, device=dev) if traceback else None
    outs = (carry.data_ptr(), out["score"].data_ptr(), out["length"].data_ptr(),
            out["ti"].data_ptr(), out["tj"].data_ptr(), out["tcode"].data_ptr(),
            tb.data_ptr() if traceback else None)
    series = (gaps.ctypes.data_as(ctypes.c_void_p), k, MODES.index(mode), int(traceback))
    lib = build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if from_hs:
            rc = lib.praline_tiled_dp_hs(source.data_ptr(), lx.data_ptr(), ly.data_ptr(),
                                         *series, D, B, Lp, W, T, *outs, stream)
        else:
            AP = padded_alphabet(A)
            t_rows = torch.empty((B, Lx, AP), **f32)
            cy_rows = torch.empty((B, Ly, AP), **f32)
            rc = lib.praline_tiled_dp_rows(*(t.data_ptr() for t in source), lx.data_ptr(),
                                           ly.data_ptr(), *series, B, Lx, Ly, A, W, T,
                                           t_rows.data_ptr(), cy_rows.data_ptr(), *outs,
                                           stream)
    build.check(rc, "praline_tiled_dp_hs" if from_hs else "praline_tiled_dp_rows")
    launches += 1
    if traceback:
        out["tb"] = tb
    return out
