"""The schedules of the merge's two Hopper kernels, modelled on the CPU.

``csrc/replay.cu`` walks a problem with one warp, its path's direction
bytes staged in shared memory a window of ``WINDOW`` diagonals at a time
(rows of 2 ``WINDOW`` columns, placed from the cell where the walk entered
the window before), and reads device memory only where a byte lies outside
the staged window.  :func:`windowed_walk` is that schedule in torch, over
the plain walk's machine (``kernels/replay.py::_walk_step``): the tapes it
builds must be the JAX package's ``replay_moves`` tapes, on the JAX DP's
bytes in the three modes at one and three gap levels, with border runs and
local stops among the walks, and every byte it reads must lie in the
window staged for it (so the kernel never leaves shared memory on a DP's
bytes).  The same for the block walk of the checkpointed traceback, whose
windows stop at its block's lower edge.

``csrc/compose.cu`` cuts each join's tape into tiles, a CTA a tile, each
counting the takes of the tape before its tile itself.
:func:`compose_tiles` is that plan in numpy: it must equal
``compose_plain`` bit for bit on random tapes (empty local walks, x or y
moves alone, merged profiles past the capacity), and every output column
must have exactly one writer.  Tolerance 0.
"""

import re
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from praline_tpu import ALPHABET_AA, builtin_score_matrix
from praline_tpu.kernels.replay import replay_moves as jax_replay
from praline_tpu.kernels.scan import wavefront_dp as jax_dp
from praline_tpu.kernels.scores import skewed_pair_scores as jax_skewed
from praline_tpu_torch.kernels import compose as compose_mod
from praline_tpu_torch.kernels.replay import _walk_step, walk_state

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "praline_tpu_torch" / "csrc"
WINDOW = int(re.search(r"constexpr int WINDOW = (\d+);", (CSRC / "replay.cu").read_text())[1])
TILE = int(re.search(r"constexpr int THREADS = (\d+);", (CSRC / "compose.cu").read_text())[1])
B62 = builtin_score_matrix("blosum62")
A = ALPHABET_AA.size
MODES = ["global", "semiglobal", "local"]


def window(D, i, base, rows, Lp, W):
    """The kernel's window of diagonals (D - W, D] for a walk that entered
    the one above at row i: (rlo, rhi, clo, chi)."""
    return ((D - W - 1 - base).clamp(0, rows - 1), (D - 2 - base).clamp(0, rows - 1),
            (i - 2 * W + 1).clamp(0, Lp - 1), i.clamp(0, Lp - 1))


def windowed_walk(bits, state, moves, *, cap, base, edge, gap_series, mode, W=WINDOW):
    """``csrc/replay.cu``'s ``walk`` for every problem at once: from
    ``state`` (advanced in place) over ``bits uint8[R, B, Lp]``, each move
    appended at n of ``moves``, at most ``cap`` steps, stopping (``edge``)
    where a diagonal leaves the block's lower edge.  Windows 0 and 1 are
    placed from the first cell, window k + 1 from the cell where the walk
    entered window k.  Returns the reads outside the staged window, and the
    walks that ran a border (i == 0 or j == 0) and that stopped on the
    local bit."""
    rows, B, Lp = bits.shape
    k = len(gap_series)
    bidx = torch.arange(B)
    i, j, st, lvl, done, n = (state[v].clone() for v in range(6))
    done = done != 0
    active = ~done & ~(edge & (i + j - 2 < base))
    D = i + j
    cur = window(D, i, base, rows, Lp, W)
    nxt = window(D - W, i, base, rows, Lp, W)
    outside = 0
    border = torch.zeros(B, dtype=torch.bool)
    local_stop = torch.zeros(B, dtype=torch.bool)
    for _ in range(cap):
        d = i + j
        active = active & ~done & ~(edge & (d - 2 < base))
        if not bool(active.any()):
            break
        into = active & (d <= D - W)
        D = torch.where(into, D - W, D)
        cur = tuple(torch.where(into, b, a) for a, b in zip(cur, nxt))
        nxt = tuple(torch.where(into, b, a) for a, b in zip(nxt, window(D - W, i, base, rows,
                                                                       Lp, W)))
        row = (d - 2 - base).clamp(0, rows - 1)
        col = i.clamp(0, Lp - 1)
        inside = (row >= cur[0]) & (row <= cur[1]) & (col >= cur[2]) & (col <= cur[3])
        outside += int((active & ~inside).sum())
        cell = bits[row.long(), bidx, col.long()].to(torch.int32)
        border |= active & (((st == 1) & (j == 0)) | ((st == 2) & (i == 0)))
        local_stop |= active & (st == 0) & ((cell >> 7) & 1 == 1) & ~((i == 0) & (j == 0)) \
            & (mode == "local")
        (ni, nj, nst, nlvl, ndone), mv = _walk_step(cell, i, j, st, lvl, done, k,
                                                    mode == "local")
        put = active & (mv != 0)
        at = put & (n < moves.shape[1])
        moves[bidx[at], n[at].long()] = mv[at]
        n = n + put.to(torch.int32)
        i, j = torch.where(active, ni, i), torch.where(active, nj, j)
        st, lvl = torch.where(active, nst, st), torch.where(active, nlvl, lvl)
        done = torch.where(active, ndone, done)
    state.copy_(torch.stack([i, j, st, lvl, done.to(torch.int32), n]))
    return outside, border, local_stop


def jax_traceback(seed, gap_series, mode, B=8, bx=150, by=190):
    """The JAX DP's traceback bytes and terminals on seeded one-hot pairs
    (lengths 1 .. bucket, and the first three pairs 1 x 1, 1 x by and bx x
    1, whose walks run the borders), and the JAX walk's tapes."""
    rng = np.random.default_rng(seed)
    cx = np.zeros((B, bx, A), np.float32)
    cy = np.zeros((B, by, A), np.float32)
    lx = rng.integers(bx // 2, bx + 1, size=B).astype(np.int32)
    ly = rng.integers(by // 2, by + 1, size=B).astype(np.int32)
    lx[:3], ly[:3] = (1, 1, bx), (1, by, 1)
    for b in range(B):
        cx[b, np.arange(lx[b]), rng.integers(0, 20, lx[b])] = 1.0
        cy[b, np.arange(ly[b]), rng.integers(0, 20, ly[b])] = 1.0
    hs = jax_skewed(cx, np.ones((B, bx), np.float32), cy, np.ones((B, by), np.float32),
                    B62.as_f32())
    out = jax_dp(hs, jnp.asarray(lx), jnp.asarray(ly), gap_series=gap_series, mode=mode,
                 traceback=True)
    moves, n = jax_replay(out["tb"], out["ti"], out["tj"], out["tcode"], gap_series=gap_series,
                          mode=mode, steps=bx + by)
    terminal = [torch.from_numpy(np.array(out[key])) for key in ("tb", "ti", "tj", "tcode")]
    return (*terminal, torch.from_numpy(np.array(moves)), torch.from_numpy(np.array(n)))


CASES = [(mode, series) for mode in MODES for series in ((11, 1), (13, 7, 1))]


@pytest.fixture(scope="module")
def tracebacks():
    return {}


def traceback_of(cache, mode, series):
    if (mode, series) not in cache:
        cache[mode, series] = jax_traceback(zlib.crc32(repr((mode, series)).encode()), series,
                                            mode)
    return cache[mode, series]


@pytest.mark.parametrize("W", [WINDOW, 5])
@pytest.mark.parametrize("mode,series", CASES)
def test_walk_reads_only_its_staged_window(tracebacks, mode, series, W):
    """The whole walk (``replay_moves``): the tapes equal JAX's and every
    byte read lies in its window, at the kernel's WINDOW and at 5 (a
    window switch every few moves)."""
    tb, ti, tj, tcode, want_moves, want_n = traceback_of(tracebacks, mode, series)
    steps = want_moves.shape[1]
    state = walk_state(ti, tj, tcode, len(series))
    moves = torch.zeros((tb.shape[1], steps), dtype=torch.uint8)
    outside, border, local_stop = windowed_walk(tb, state, moves, cap=steps, base=0, edge=False,
                                                gap_series=series, mode=mode, W=W)
    assert outside == 0
    assert torch.equal(moves, want_moves) and torch.equal(state[5], want_n)
    assert bool(border.any()) == (mode != "local")
    assert bool(local_stop.any()) == (mode == "local")


@pytest.mark.parametrize("mode,series", CASES)
def test_block_walk_reads_only_its_staged_window(tracebacks, mode, series):
    """The checkpointed traceback's block walk over blocks of 37 rows,
    from the last to the first (each block's windows from the cell where
    the walk entered it, cut at its lower edge): the tape equals JAX's
    whole walk and every byte read lies in its window."""
    tb, ti, tj, tcode, want_moves, want_n = traceback_of(tracebacks, mode, series)
    R = 37
    T, B, Lp = tb.shape
    nblk = -(-T // R)
    pad = torch.full((nblk * R - T, B, Lp), 0xAB, dtype=torch.uint8)
    blocks = torch.cat([tb, pad]).view(nblk, R, B, Lp)
    state = walk_state(ti, tj, tcode, len(series))
    moves = torch.zeros_like(want_moves)
    outside = 0
    for q in range(nblk - 1, -1, -1):
        outside += windowed_walk(blocks[q], state, moves, cap=R + 2, base=q * R, edge=q > 0,
                                 gap_series=series, mode=mode)[0]
    assert outside == 0
    assert torch.equal(moves, want_moves) and torch.equal(state[5], want_n)


def compose_tiles(moves, nmoves, ti, tj, table, li, ri, oi, inv_table, mode, tile):
    """``csrc/compose.cu``'s plan in numpy: for each join, a CTA a tile of
    ``tile`` tape positions, each counting the takes before its tile from
    the tape itself, then its positions' columns (summed a = 0 .. A - 1,
    rescaled past COUNT_LIMIT, inverse looked up), and the columns past the
    merged profile whose index lies in its tile.  Returns the new slots
    (counts, gaps, inv, lens, mems), the tapes, nmv, the writes each
    output column got and the columns rescaled."""
    m_all = moves.numpy().astype(np.int64)
    J, steps = m_all.shape
    counts, gaps = table.counts.numpy(), table.gaps.numpy()
    lens, mems = table.lens.numpy(), table.mems.numpy()
    C, A_ = counts.shape[1], counts.shape[2]
    inv_t = inv_table.numpy()
    out_c = np.full((J, C, A_), np.nan, np.float32)
    out_g = np.full((J, C), np.nan, np.float32)
    out_i = np.full((J, C), np.nan, np.float32)
    writes = np.zeros((J, C), np.int64)
    rescaled = 0
    tapes = np.zeros((J, steps), np.uint8)
    nmvs = np.zeros(J, np.int32)
    f32 = np.float32
    for jn in range(J):
        l, r = int(li[jn]), int(ri[jn])
        Cl, Cr, m = int(lens[l]), int(lens[r]), m_all[jn]
        nmv = int(nmoves[jn])
        tx = ty = shift = after = x0 = y0 = 0
        if mode == "semiglobal":
            tx, ty = Cl - int(ti[jn]), Cr - int(tj[jn])
            shift = tx + ty
            nmv += shift
        elif mode == "local":
            empty = nmv == 0
            ti_e, tj_e = (0, 0) if empty else (int(ti[jn]), int(tj[jn]))
            tx, ty = Cl - ti_e, Cr - tj_e
            x0 = ti_e - int(((m == 1) | (m == 2)).sum())
            y0 = tj_e - int(((m == 1) | (m == 3)).sum())
            shift, after = tx + ty, tx + ty + nmv
            nmv += shift + x0 + y0

        def at(p):
            if mode == "semiglobal":
                return 2 if p < tx else 3 if p < shift else m[p - shift]
            if mode != "local":
                return m[p]
            if p < ty:
                return 3
            if p < shift:
                return 2
            if p < after:
                return m[p - shift]
            if p < after + y0:
                return 3
            return 2 if p < after + y0 + x0 else 0

        takes = lambda v: (int(v in (1, 2)), int(v in (1, 3)))
        for p0 in range(0, max(steps, C), tile):
            if p0 < steps:
                bx = sum(takes(at(p))[0] for p in range(min(p0, nmv)))
                by = sum(takes(at(p))[1] for p in range(min(p0, nmv)))
                for p in range(p0, min(p0 + tile, steps)):
                    mv = at(p)
                    tapes[jn, p] = mv
                    tkx, tky = takes(mv)
                    bx, by = bx + tkx, by + tky
                    c = nmv - 1 - p
                    if mv == 0 or c < 0 or c >= C:
                        continue
                    xi, yi = min(max(Cl - bx, 0), C - 1), min(max(Cr - by, 0), C - 1)
                    x, y = counts[l, xi], counts[r, yi]
                    v = (x + y).astype(f32) if tkx and tky else (x if tkx else y).copy()
                    s = f32(0)
                    for a in range(A_):
                        s = f32(s + v[a])
                    g = f32((gaps[l, xi] if tkx else f32(mems[l]))
                            + (gaps[r, yi] if tky else f32(mems[r])))
                    if f32(s + g) > 992.0:
                        n = max(int(f32(s + g)), 1)
                        v = ((512 * v.astype(np.int64) + n) // (2 * n)).astype(f32)
                        s = f32(0)
                        for a in range(A_):
                            s = f32(s + v[a])
                        g = f32((512 * int(g) + n) // (2 * n))
                        rescaled += 1
                    out_c[jn, c], out_g[jn, c] = v, g
                    out_i[jn, c] = inv_t[min(max(int(s), 0), inv_t.shape[0] - 1)]
                    writes[jn, c] += 1
            for c in range(max(min(max(nmv, 0), C), p0), min(C, p0 + tile)):
                out_c[jn, c], out_g[jn, c], out_i[jn, c] = 0.0, 0.0, inv_t[0]
                writes[jn, c] += 1
        nmvs[jn] = nmv
    new_lens = np.minimum(nmvs, C).astype(np.int32)
    new_mems = (mems[li] + mems[ri]).astype(np.int32)
    return out_c, out_g, out_i, new_lens, new_mems, tapes, nmvs, writes, rescaled


def random_tapes(rng, mode, lens, li, ri, steps):
    """Valid walk tapes, one a join: global from (Cl, Cr) to the origin,
    semiglobal from a cell inside, local a segment ending inside; outside
    global mode the first three joins walk nothing, x moves alone and y
    moves alone."""
    J = len(li)
    moves = np.zeros((J, steps), np.uint8)
    nm, ti, tj = (np.zeros(J, np.int32) for _ in range(3))
    for jn in range(J):
        Cl, Cr = int(lens[li[jn]]), int(lens[ri[jn]])
        ti[jn], tj[jn] = (Cl, Cr) if mode == "global" else (rng.integers(0, Cl + 1),
                                                            rng.integers(0, Cr + 1))
        kind = jn if mode != "global" else 3
        if mode == "semiglobal" and kind < 3:  # a walk from (ti, 0), (0, tj) or the origin
            ti[jn] = 0 if kind in (0, 2) else ti[jn]
            tj[jn] = 0 if kind in (0, 1) else tj[jn]
        xt, yt = int(ti[jn]), int(tj[jn])
        if mode == "local":  # a segment; none, x moves alone, y moves alone first
            xt = 0 if kind in (0, 2) else int(rng.integers(0, xt + 1))
            yt = 0 if kind in (0, 1) else int(rng.integers(0, yt + 1))
        seq = []
        while xt or yt:
            choice = rng.integers(0, 3)
            if choice == 0 and xt and yt:
                seq.append(1)
                xt, yt = xt - 1, yt - 1
            elif choice == 1 and xt or not yt:
                seq.append(2)
                xt -= 1
            else:
                seq.append(3)
                yt -= 1
        moves[jn, : len(seq)] = seq
        nm[jn] = len(seq)
    return moves, nm, ti, tj


@pytest.mark.parametrize("tile", [TILE, 16, 7])
@pytest.mark.parametrize("mode", MODES)
def test_compose_tiles_equal_plain(mode, tile):
    """The kernel's tile plan at its TILE and at 16 and 7 positions a tile
    against ``compose_plain``: tapes, nmv and every slot bit for bit, each
    output column written exactly once (past nmv too), over columns past
    COUNT_LIMIT and joins whose merged profile outgrows the capacity."""
    rng = np.random.default_rng(zlib.crc32(repr(("tiles", mode, tile)).encode()))
    J, C, A_ = 6, 48, 5
    lens = np.r_[rng.integers(1, C // 2 + 1, size=2 * J - 2), C, C, np.ones(J)].astype(np.int32)
    counts = np.zeros((3 * J, C, A_), np.float32)
    gaps = np.zeros((3 * J, C), np.float32)
    for s in range(2 * J):
        c = rng.integers(0, 3, size=(lens[s], A_)).astype(np.float32)
        big = rng.random(lens[s]) < 0.3
        c[big, 0] += rng.integers(500, 700, size=int(big.sum()))
        counts[s, : lens[s]], gaps[s, : lens[s]] = c, rng.integers(0, 60, size=lens[s])
    mems = np.r_[rng.integers(1, 400, size=2 * J), np.zeros(J)].astype(np.int32)
    inv_table = compose_mod.inverse_table(float(counts.sum(-1).max()))
    table = compose_mod.NodeTable(torch.from_numpy(counts), torch.from_numpy(gaps),
                                  torch.from_numpy(compose_mod.column_inverses(counts, inv_table)),
                                  torch.from_numpy(lens), torch.from_numpy(mems))
    li = np.arange(0, 2 * J, 2, dtype=np.int32)
    ri, oi = li + 1, np.arange(2 * J, 3 * J, dtype=np.int32)
    steps = 2 * C
    moves, nm, ti, tj = random_tapes(rng, mode, lens, li, ri, steps)
    want = compose_mod.NodeTable(*(t.clone() for t in (table.counts, table.gaps, table.inv,
                                                       table.lens, table.mems)))
    tape_p, nmv_p = compose_mod.compose_plain(
        torch.from_numpy(moves), torch.from_numpy(nm), torch.from_numpy(ti),
        torch.from_numpy(tj), want, torch.from_numpy(li), torch.from_numpy(ri),
        torch.from_numpy(oi), torch.from_numpy(inv_table), mode)
    got = compose_tiles(torch.from_numpy(moves), nm, ti, tj, table, li, ri, oi,
                        torch.from_numpy(inv_table), mode, tile)
    out_c, out_g, out_i, new_lens, new_mems, tapes, nmvs, writes, rescaled = got
    assert (writes == 1).all()
    assert np.array_equal(tapes, tape_p.numpy()) and np.array_equal(nmvs, nmv_p.numpy())
    assert (nmvs > C).any()  # the last join's merged profile outgrows the capacity
    assert rescaled > 0
    for got_t, want_t in ((out_c, want.counts[oi]), (out_g, want.gaps[oi]),
                          (out_i, want.inv[oi])):
        assert np.array_equal(got_t.view(np.int32), want_t.numpy().view(np.int32))
    assert np.array_equal(new_lens, want.lens[oi].numpy())
    assert np.array_equal(new_mems, want.mems[oi].numpy())
