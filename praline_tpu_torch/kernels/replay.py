"""Traceback walk over the DP's direction bytes: plain version and the
Hopper kernel's wrapper (``csrc/replay.cu``).

Counterpart of ``praline_tpu/kernels/replay.py`` (``_walk_init``,
``_walk_step``, ``replay_moves``, ``moves_to_result``), an XLA scan on the
TPU.  The plain version is a batched torch walk: each step gathers one byte
per problem and advances an ``(i, j, state, level)`` machine that mirrors
``praline_tpu.oracle.align._traceback``; only a move tape of one byte per
emitted column leaves the device.  It costs some thirty tensor operations
per move, each a launch on the card, so on CUDA tensors the walk is one
kernel instead: a thread per problem, bounded by the latency of its
dependent one-byte reads.

Move codes (emitted terminal -> origin): 0 = none (walk finished),
1 = diagonal, 2 = up (consume x, gap in y), 3 = left (consume y, gap in x).
"""

from __future__ import annotations

import numpy as np
import torch

from praline_tpu.oracle.align import AlignResult
from praline_tpu.types import GAP

from . import build
from .scan import MODES, PTR_NONE

launches = 0  # kernel launches by replay_moves (not by the plain path)


def reset_launches() -> None:
    global launches
    launches = 0


def _walk_init(tcode, k):
    """Initial (state, level) of the walk from the terminal state code."""
    st0 = torch.where(tcode == 0, 0, torch.where(tcode <= k, 1, 2)).to(torch.int32)
    lvl0 = torch.where(tcode <= k, tcode, tcode - k).to(torch.int32)
    return st0, lvl0


def _walk_step(bits, i, j, st, lvl, done, k, local=False):
    """One move of the traceback state machine for a batch of walks.
    Returns ``((ni, nj, nst, nlvl, ndone), move)``."""
    mptr = bits & 31
    stay_x = ((bits >> 5) & 1) == 1
    stay_y = ((bits >> 6) & 1) == 1

    live = ~done
    is_m = (st == 0) & live
    is_ix = (st == 1) & live
    is_iy = (st == 2) & live

    stop = (i == 0) & (j == 0)
    if local:  # entering an M cell worth <= 0 ends the path
        stop = stop | (((bits >> 7) & 1) == 1)
    m_stop = is_m & stop
    m_emit = is_m & ~stop

    m_done = m_emit & (mptr == PTR_NONE)
    m_nst = torch.where(mptr == 0, 0, torch.where(mptr <= k, 1, 2))
    m_nlvl = torch.where(mptr <= k, mptr, mptr - k)

    ix_border = is_ix & (j == 0)
    ix_norm = is_ix & (j > 0)
    iy_border = is_iy & (i == 0)
    iy_norm = is_iy & (i > 0)
    if k == 1:
        ixn_st = torch.where(stay_x, 1, 0)
        ixn_lvl = torch.where(stay_x, 1, 0)
        iyn_st = torch.where(stay_y, 2, 0)
        iyn_lvl = torch.where(stay_y, 1, 0)
    else:
        lvl1 = lvl == 1
        ixn_st = torch.where(lvl1, 0, 1)
        iyn_st = torch.where(lvl1, 0, 2)
        ixn_lvl = torch.where(
            lvl1, 0, torch.where(lvl < k, lvl - 1, torch.where(stay_x, k, k - 1))
        )
        iyn_lvl = torch.where(
            lvl1, 0, torch.where(lvl < k, lvl - 1, torch.where(stay_y, k, k - 1))
        )

    ni = i - (m_emit | is_ix).to(i.dtype)
    nj = j - (m_emit | is_iy).to(j.dtype)

    nst = torch.where(m_emit, m_nst, st)
    nst = torch.where(ix_norm, ixn_st, nst)
    nst = torch.where(iy_norm, iyn_st, nst)
    nlvl = torch.where(m_emit, m_nlvl, lvl)
    nlvl = torch.where(ix_norm, ixn_lvl, nlvl)
    nlvl = torch.where(iy_norm, iyn_lvl, nlvl)
    # border runs re-level from the remaining run length
    nlvl = torch.where(ix_border, ni.clamp(max=k), nlvl)
    nlvl = torch.where(iy_border, nj.clamp(max=k), nlvl)

    ndone = done | m_stop | m_done
    ndone = ndone | (ix_border & (ni == 0)) | (iy_border & (nj == 0))
    # an interior gap cell stepping into M exactly at the origin
    ndone = ndone | ((ix_norm | iy_norm) & (nst == 0) & (ni == 0) & (nj == 0))

    move = torch.where(
        m_emit, 1, torch.where(is_ix, 2, torch.where(is_iy, 3, 0))
    ).to(torch.uint8)
    return (ni, nj, nst.to(torch.int32), nlvl.to(torch.int32), ndone), move


def replay_moves_plain(tb, ti, tj, tcode, gap_series=(11, 1), mode="global", steps=None):
    """Walk the direction bytes ``tb uint8[T, B, Lp]`` (row t = diagonal
    t + 2) for a whole batch.

    Returns ``(moves uint8[B, steps], n int32[B])`` in terminal -> origin
    order.  ``steps`` must bound the longest walk (``lx + ly``; default
    ``T + 1``).
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    local = mode == "local"
    T, B, Lp = tb.shape
    k = len(gap_series)
    if steps is None:
        steps = T + 1
    dev = tb.device
    i32 = torch.int32
    bidx = torch.arange(B, device=dev)
    i = ti.to(dev, i32)
    j = tj.to(dev, i32)
    st, lvl = _walk_init(tcode.to(dev, i32), k)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    moves = torch.zeros((steps, B), dtype=torch.uint8, device=dev)
    for s in range(steps):
        # finished walks emit zeros: stop once every walk is done (one
        # host sync every 64 steps)
        if s % 64 == 63 and bool(done.all()):
            break
        row = (i + j - 2).clamp(0, T - 1).long()
        bits = tb[row, bidx, i.clamp(0, Lp - 1).long()].to(i32)
        (i, j, st, lvl, done), moves[s] = _walk_step(bits, i, j, st, lvl, done, k, local)
    moves = moves.t().contiguous()
    n = (moves != 0).sum(dim=1, dtype=i32)
    return moves, n


def replay_moves(tb, ti, tj, tcode, gap_series=(11, 1), mode="global", steps=None):
    """``replay_moves_plain``'s contract; CPU tensors take the plain version,
    CUDA tensors launch the kernel (or raise)."""
    if tb.device.type == "cpu":
        return replay_moves_plain(tb, ti, tj, tcode, gap_series, mode, steps)
    global launches
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    k = len(gap_series)
    if not 1 <= k <= 15:
        raise ValueError("gap series must have 1 to 15 levels")
    if tb.dtype != torch.uint8 or tb.dim() != 3 or not tb.is_contiguous():
        raise ValueError("tb must be a contiguous uint8[T, B, Lp] tensor")
    T, B, Lp = tb.shape
    if steps is None:
        steps = T + 1
    dev = tb.device
    for name, t in (("ti", ti), ("tj", tj), ("tcode", tcode)):
        if t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != (B,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32[{B}] tensor on {dev}")
    moves = torch.empty((B, steps), dtype=torch.uint8, device=dev)
    n = torch.empty(B, dtype=torch.int32, device=dev)
    lib = build.load_library()
    with torch.cuda.device(dev):
        rc = lib.praline_replay_moves(
            tb.data_ptr(), ti.data_ptr(), tj.data_ptr(), tcode.data_ptr(),
            T, B, Lp, k, int(mode == "local"), steps, moves.data_ptr(), n.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(rc, "praline_replay_moves")
    launches += 1
    return moves, n


def moves_to_result(moves: np.ndarray, n: int, score: float, ti: int, tj: int,
                    lx: int, ly: int, mode: str) -> AlignResult:
    """Decode one move tape (numpy ``uint8[steps]``) into an AlignResult.

    Reversal gives origin -> terminal; semiglobal appends the free trailing
    suffix (y tail, then x tail), exactly as ``oracle.align._traceback``.
    """
    m = moves[:n][::-1]
    takes_x = (m == 1) | (m == 2)
    takes_y = (m == 1) | (m == 3)
    cum_x = np.cumsum(takes_x).astype(np.int32)
    cum_y = np.cumsum(takes_y).astype(np.int32)
    # a local walk starts mid-matrix at (ti - #x moves, tj - #y moves)
    offx = offy = 0
    if mode == "local" and n:
        offx = ti - int(cum_x[-1])
        offy = tj - int(cum_y[-1])
    cols_x = np.where(takes_x, cum_x - 1 + offx, GAP).astype(np.int32)
    cols_y = np.where(takes_y, cum_y - 1 + offy, GAP).astype(np.int32)
    if mode == "semiglobal":
        ytail = np.arange(tj, ly, dtype=np.int32)
        xtail = np.arange(ti, lx, dtype=np.int32)
        cols_x = np.concatenate([cols_x, np.full(ytail.size, GAP, np.int32), xtail])
        cols_y = np.concatenate([cols_y, ytail, np.full(xtail.size, GAP, np.int32)])
    xs = cols_x[cols_x != GAP]
    ys = cols_y[cols_y != GAP]
    x_range = (int(xs.min()), int(xs.max()) + 1) if xs.size else (0, 0)
    y_range = (int(ys.min()), int(ys.max()) + 1) if ys.size else (0, 0)
    return AlignResult(float(score), cols_x, cols_y, x_range, y_range, mode)
