"""Plain batched anti-diagonal wavefront DP: the reference for the Hopper DPs.

Counterpart of ``praline_tpu/kernels/scan.py::wavefront_dp`` (the
single-device, materialized-``hs`` form of ``_wavefront``), written as a
torch loop over anti-diagonals.  It is the parity anchor of the CUDA
kernels in ``kernels/wavefront.py``, ``kernels/fused_dp.py`` and
``kernels/tiled_dp.py`` and the path every CPU run takes.

Layout: diagonal vectors are indexed by lane ``i`` (rows consumed of x);
lane ``i`` of diagonal ``d`` holds cell ``(i, d - i)``.  Per-problem true
lengths ``lx, ly`` are at most the bucket shape; padded cells compute
values that only flow to other padded cells, and terminals are read at the
true lengths.

The recurrence is split as ``csrc/wavefront.cuh`` splits it, so the lane
tiled walk (``kernels/tiled_dp.py``) reuses it piece for piece: the d = 1
carries of a range of lanes (:func:`carries_d1`), one diagonal over that
range given its left neighbour's carries (:func:`diagonal_step`, with
:func:`edge_of` giving a range's last lane), and the terminal trackers
(:class:`Terminals`).  :func:`wavefront_dp` runs them over the whole row.

Traceback byte per interior cell (identical to the JAX package):
  bits 0-4  M predecessor code (0 = M, 1..k = Ix level, k+1..2k = Iy level,
            31 = none, a local fresh start);
  bit 5     level-k Ix choice (1 = stay at level k, 0 = enter from the level
            below, or from M when k == 1);
  bit 6     the same for Iy;
  bit 7     local mode only: this M cell's value is <= 0.

Every value is f32 and every operation is one IEEE-rounded add, subtract
or compare, in the JAX package's order, so results are bit-identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NEG = -1.0e30  # rounds to the same f32 as the JAX package's np.float32(-1e30)
PTR_NONE = 31
MODES = ("global", "semiglobal", "local")


def _gap_prefix(gap_series: tuple[int, ...], length: int) -> np.ndarray:
    """``cum[m]`` = cost of m consecutive gap columns, f32 cumulative sum."""
    k = len(gap_series)
    g = np.asarray(gap_series, dtype=np.float32)
    idx = np.minimum(np.arange(1, length + 1), k) - 1
    cum = np.zeros(length + 1, dtype=np.float32)
    if length:
        cum[1:] = np.cumsum(g[idx], dtype=np.float32)
    return cum


def _priority_select(m, ixs, iys, lm, lixs, liys, codes_x, codes_y):
    """Best state per cell, ties M > Ix (levels ascending) > Iy (levels
    ascending).  Returns (value, length, code)."""
    val, ln = m, lm
    code = torch.zeros_like(m, dtype=torch.int32)
    for v, l, c in zip(list(ixs) + list(iys), list(lixs) + list(liys),
                       list(codes_x) + list(codes_y)):
        better = v > val
        val = torch.where(better, v, val)
        ln = torch.where(better, l, ln)
        code = torch.where(better, c, code)
    return val, ln, code


def _shift(v, fill):
    """Lane i <- lane i-1; the first lane takes ``fill`` (a scalar, or a
    ``[B]`` column: the left neighbour's value)."""
    out = torch.empty_like(v)
    out[:, 0] = fill
    out[:, 1:] = v[:, :-1]
    return out


def _take(v, idx):
    """v (B, Lp), idx (B,) -> v[b, idx[b]]."""
    return v.gather(1, idx.clamp(0, v.shape[1] - 1).long()[:, None])[:, 0]


class Recurrence:
    """What every diagonal of one call shares: the series, the mode and the
    border run costs."""

    def __init__(self, gap_series, mode, traceback, D):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        k = len(gap_series)
        if not 1 <= k <= 15:
            raise ValueError("gap series must have 1 to 15 levels")
        self.k = k
        self.g = [float(np.float32(x)) for x in gap_series]
        self.collapsed = k == 2
        self.kc = 1 if self.collapsed else k
        self.track_stay = self.collapsed and traceback
        self.mode = mode
        self.local = mode == "local"
        self.semi = mode == "semiglobal"
        self.traceback = traceback
        self.border_m = 0.0 if self.local else NEG
        self.cum = _gap_prefix(gap_series, D + 1)
        self.codes_x = [1] if self.collapsed else [1 + l for l in range(k)]
        self.codes_y = [1 + k] if self.collapsed else [1 + k + l for l in range(k)]


def carries_d1(rec: Recurrence, lane, B):
    """The carries at d = 1 of the lanes ``lane`` (global lane indices,
    ``[1, w]``): cells (0, 1) on lane 0 and (1, 0) on lane 1."""
    dev = lane.device
    w = lane.shape[1]
    zeros = torch.zeros((B, w), dtype=torch.float32, device=dev)
    negs = torch.full((B, w), NEG, dtype=torch.float32, device=dev)
    izeros = torch.zeros((B, w), dtype=torch.int32, device=dev)
    kc = rec.kc
    m1 = torch.where((lane == 0) | (lane == 1), rec.border_m, negs)
    lm1 = zeros
    ix1 = [negs] * kc
    iy1 = [negs] * kc
    lix1 = [zeros] * kc
    liy1 = [zeros] * kc
    if not rec.local:
        bval = 0.0 if rec.semi else -float(rec.cum[1])
        ix1[0] = torch.where(lane == 1, bval, negs)
        iy1[0] = torch.where(lane == 0, bval, negs)
        lix1[0] = torch.where(lane == 1, 1.0, zeros)
        liy1[0] = torch.where(lane == 0, 1.0, zeros)
    # best-state rows: r2 = diagonal 0 (cell (0,0), M = 0), r1 = diagonal 1
    r2v = torch.where(lane == 0, 0.0, negs)
    r1v, r1l, r1c = _priority_select(m1, ix1, iy1, lm1, lix1, liy1, rec.codes_x, rec.codes_y)
    return dict(m1=m1, lm1=lm1, ix1=ix1, iy1=iy1, lix1=lix1, liy1=liy1, r1v=r1v, r1l=r1l,
                r1c=r1c, r2v=r2v, r2l=zeros, r2c=izeros, psx=izeros, psy=izeros)


def edge_of(c):
    """The values the last lane of a range hands to the next lane: its M,
    best(d-2), their lengths and code, its x stay bit and Ix levels (the
    NX values of ``csrc/wavefront.cuh``), each a ``[B]`` column."""
    return dict(m1=c["m1"][:, -1], r2v=c["r2v"][:, -1], r2l=c["r2l"][:, -1],
                r2c=c["r2c"][:, -1], lm1=c["lm1"][:, -1], psx=c["psx"][:, -1],
                ix1=[v[:, -1] for v in c["ix1"]], lix1=[v[:, -1] for v in c["lix1"]])


def diagonal_step(rec: Recurrence, c, left, d, lane0, hrow):
    """Diagonal ``d`` over the lanes ``lane0 .. lane0 + w - 1`` whose
    carries (at d - 1) are ``c``; ``left`` is :func:`edge_of` the lane
    before ``lane0`` (``None`` at lane 0: the border fill) and ``hrow`` the
    lanes' scores ``hs[d, :, lane0:lane0 + w]``.  Returns the carries at d
    and the cell dict (best value, length and code, M value and length,
    and the traceback bits when asked for)."""
    k, kc, g = rec.k, rec.kc, rec.g
    collapsed, local = rec.collapsed, rec.local
    i32 = torch.int32
    w = hrow.shape[1]
    m1, lm1, ix1, iy1, lix1, liy1 = (c[n] for n in ("m1", "lm1", "ix1", "iy1", "lix1", "liy1"))

    def fill(name, default, level=None):
        if left is None:
            return default
        return left[name] if level is None else left[name][level]

    m1s = _shift(m1, fill("m1", NEG))
    b2vs = _shift(c["r2v"], fill("r2v", NEG))
    lm1s = _shift(lm1, fill("lm1", 0.0))
    b2ls = _shift(c["r2l"], fill("r2l", 0.0))
    b2cs = _shift(c["r2c"], fill("r2c", 0))
    ix1s = [_shift(v, fill("ix1", NEG, l)) for l, v in enumerate(ix1)]
    lix1s = [_shift(v, fill("lix1", 0.0, l)) for l, v in enumerate(lix1)]

    # ---- gap states ----
    nix = [None] * kc
    niy = [None] * kc
    nlix = [None] * kc
    nliy = [None] * kc
    if collapsed:
        # k = 2 collapse (praline_tpu/kernels/scan.py:246-260): one
        # max-of-levels row per side; sx/sy are the chosen level minus
        # one and the next diagonal's stay bits.
        open_x = m1s - g[0]
        ext_x = ix1s[0] - g[1]
        sx = ext_x > open_x
        nix[0] = torch.where(sx, ext_x, open_x)
        nlix[0] = torch.where(sx, lix1s[0], lm1s) + 1.0
        open_y = m1 - g[0]
        ext_y = iy1[0] - g[1]
        sy = ext_y > open_y
        niy[0] = torch.where(sy, ext_y, open_y)
        nliy[0] = torch.where(sy, liy1[0], lm1) + 1.0
    elif k == 1:
        stay_x = ix1s[0] > m1s
        nix[0] = torch.where(stay_x, ix1s[0], m1s) - g[0]
        nlix[0] = torch.where(stay_x, lix1s[0], lm1s) + 1.0
        stay_y = iy1[0] > m1
        niy[0] = torch.where(stay_y, iy1[0], m1) - g[0]
        nliy[0] = torch.where(stay_y, liy1[0], lm1) + 1.0
    else:
        nix[0] = m1s - g[0]
        nlix[0] = lm1s + 1.0
        niy[0] = m1 - g[0]
        nliy[0] = lm1 + 1.0
        for l in range(1, k - 1):
            nix[l] = ix1s[l - 1] - g[l]
            nlix[l] = lix1s[l - 1] + 1.0
            niy[l] = iy1[l - 1] - g[l]
            nliy[l] = liy1[l - 1] + 1.0
        stay_x = ix1s[k - 1] > ix1s[k - 2]
        nix[k - 1] = torch.where(stay_x, ix1s[k - 1], ix1s[k - 2]) - g[k - 1]
        nlix[k - 1] = torch.where(stay_x, lix1s[k - 1], lix1s[k - 2]) + 1.0
        stay_y = iy1[k - 1] > iy1[k - 2]
        niy[k - 1] = torch.where(stay_y, iy1[k - 1], iy1[k - 2]) - g[k - 1]
        nliy[k - 1] = torch.where(stay_y, liy1[k - 1], liy1[k - 2]) + 1.0

    # ---- M state ----
    nm = hrow + b2vs
    nlm = b2ls + 1.0
    mcode = b2cs
    if local:
        clamp = nm < 0.0
        nm = torch.where(clamp, 0.0, nm)
        mcode = torch.where(clamp, PTR_NONE, mcode)
        # the length restarts at any zero-valued M cell
        nlm = torch.where(nm <= 0.0, 0.0, nlm)

    # ---- borders: lane 0 = cell (0, d), lane d = cell (d, 0) ----
    # Only two lanes change, so they are written in place (every tensor
    # written here was created in this step).
    def border(v, at0_val, atd_val):
        if lane0 == 0:
            v[:, 0] = at0_val
        if lane0 <= d < lane0 + w:
            v[:, d - lane0] = atd_val

    border(nm, rec.border_m, rec.border_m)
    border(nlm, 0.0, 0.0)
    bx = 0.0 if rec.semi else -float(rec.cum[d])
    lvl_d = min(d, k)  # border run level (1-based)
    for l in range(kc):
        if local:
            border(nix[l], NEG, NEG)
            border(niy[l], NEG, NEG)
            border(nlix[l], 0.0, 0.0)
            border(nliy[l], 0.0, 0.0)
            continue
        on_lvl = collapsed or lvl_d == l + 1
        bval = bx if on_lvl else NEG
        border(nix[l], NEG, bval)
        border(niy[l], bval, NEG)
        border(nlix[l], 0.0, float(d))
        border(nliy[l], float(d), 0.0)

    # ---- best state, for the d+2 step and for terminals ----
    psx, psy = c["psx"], c["psy"]
    if collapsed:
        # a (d, 0) border cell is a level-k run; (0, d) carries no Ix
        if local:
            border(sx, False, False)
            border(sy, False, False)
        else:
            border(sx, False, True)
            border(sy, True, False)
        sxi = sx.to(i32)
        syi = sy.to(i32)
        bv, bl, bc = _priority_select(nm, nix, niy, nlm, nlix, nliy, [1 + sxi], [1 + k + syi])
    else:
        bv, bl, bc = _priority_select(nm, nix, niy, nlm, nlix, nliy, rec.codes_x, rec.codes_y)

    cell = dict(bv=bv, bl=bl, bc=bc, nm=nm, nlm=nlm)
    if rec.traceback:
        bits = mcode.to(torch.uint8)
        if local:
            bits = bits | ((nm <= 0.0).to(torch.uint8) << 7)
        if collapsed:
            # bit 5 = previous diagonal's x-stay shifted one lane
            # (cell (i-1, j)); bit 6 = previous y-stay on the same lane
            bits = bits | (_shift(psx, fill("psx", 0)).to(torch.uint8) << 5)
            bits = bits | (psy.to(torch.uint8) << 6)
        else:
            bits = bits | (stay_x.to(torch.uint8) << 5)
            bits = bits | (stay_y.to(torch.uint8) << 6)
        cell["bits"] = bits

    if rec.track_stay:
        psx, psy = sxi, syi
    carries = dict(m1=nm, lm1=nlm, ix1=nix, iy1=niy, lix1=nlix, liy1=nliy,
                   r1v=bv, r1l=bl, r1c=bc, r2v=c["r1v"], r2l=c["r1l"], r2c=c["r1c"],
                   psx=psx, psy=psy)
    return carries, cell


class Terminals:
    """Per-problem terminal trackers, fed one diagonal of a lane range at a
    time (any order of ranges gives the same result: every candidate cell
    is unique and the tie rules are a total order)."""

    def __init__(self, rec: Recurrence, lx, ly):
        B = lx.shape[0]
        dev = lx.device
        f32, i32 = torch.float32, torch.int32
        self.rec, self.lx, self.ly = rec, lx, ly
        self.tval = torch.full((B,), NEG, dtype=f32, device=dev)
        self.tlen = torch.zeros((B,), dtype=f32, device=dev)
        self.ti = torch.zeros((B,), dtype=i32, device=dev)
        self.tj = torch.zeros((B,), dtype=i32, device=dev)
        self.tcode = torch.zeros((B,), dtype=i32, device=dev)
        if rec.semi:
            # diagonal-1 border cells are candidates when a side has length 1;
            # (1, 0) is preferred over (0, 1) (larger i).
            k = rec.k
            for pick, ci, cj, cc in ((ly == 1, 0, 1, 1 + k), (lx == 1, 1, 0, 1)):
                self._put(pick, 0.0, 1.0, ci, cj, cc)

    def _put(self, repl, v, ln, i, j, code=None):
        self.tval = torch.where(repl, v, self.tval)
        self.tlen = torch.where(repl, ln, self.tlen)
        self.ti = torch.where(repl, i, self.ti)
        self.tj = torch.where(repl, j, self.tj)
        if code is not None:
            self.tcode = torch.where(repl, code, self.tcode)

    def add(self, d, lane0, lane, cell, active=None):
        """Diagonal ``d``'s cells on the lanes ``lane`` (``[1, w]``, the
        global indices ``lane0 ..``) of the problems where ``active``
        (``[B]`` bool; all where None)."""
        lx, ly = self.lx, self.ly
        if active is not None:
            lx = torch.where(active, lx, -1)  # no lane holds a candidate
        w = lane.shape[1]
        bv, bl, bc = cell["bv"], cell["bl"], cell["bc"]
        mode = self.rec.mode
        if mode == "global":
            pick = ((lx + ly) == d) & (lx >= lane0) & (lx < lane0 + w)
            at = lx - lane0
            self._put(pick, _take(bv, at), _take(bl, at), lx, ly, _take(bc, at))
        elif mode == "semiglobal":
            # candidate A: last-column cell (d - ly, ly); then candidate B:
            # last-row cell (lx, d - lx).  Ties keep larger i, then larger j.
            for ci, cj in ((d - ly, ly), (lx, d - lx)):
                ok = (ci >= 0) & (ci <= lx) & (cj >= 0) & (cj <= ly)
                ok = ok & (ci >= lane0) & (ci < lane0 + w)
                at = ci - lane0
                cv = _take(bv, at)
                better = cv > self.tval
                tie = (cv == self.tval) & ((ci > self.ti) | ((ci == self.ti) & (cj > self.tj)))
                self._put(ok & (better | tie), cv, _take(bl, at), ci, cj, _take(bc, at))
        else:  # local: running argmax over interior M cells
            valid = (lane >= 1) & (lane <= lx[:, None]) & (d - lane >= 1) & (
                d - lane <= ly[:, None]
            )
            mv = torch.where(valid, cell["nm"], NEG)
            step_best, _ = mv.max(dim=1)
            # first maximal lane = smallest i (the pinned tie-break)
            arg = (mv == step_best[:, None]).to(torch.uint8).argmax(dim=1).to(torch.int32)
            step_arg = arg + lane0
            cj = d - step_arg
            better = step_best > self.tval
            tie = (step_best == self.tval) & (
                (step_arg < self.ti) | ((step_arg == self.ti) & (cj < self.tj)))
            # a range without an interior cell has no candidate
            repl = (better | tie) & (step_best > NEG)
            self._put(repl, step_best, _take(cell["nlm"], arg), step_arg, cj)

    def result(self):
        return {"score": self.tval, "length": self.tlen, "ti": self.ti, "tj": self.tj,
                "tcode": self.tcode}


def wavefront_dp(hs, lx, ly, gap_series=(11, 1), mode="global", traceback=False):
    """Run the batched DP over skewed scores ``hs f32[D, B, Lp]``.

    Returns a dict of per-problem terminals: ``score`` f32[B], ``length``
    f32[B] (emitted path columns; semiglobal excludes the free trailing
    gaps, which the caller adds), ``ti``/``tj`` int32[B] terminal cell,
    ``tcode`` int32[B] terminal state code, and with ``traceback`` the
    direction bytes ``tb`` uint8[D-2, B, Lp].
    """
    D, B, Lp = hs.shape
    rec = Recurrence(gap_series, mode, traceback, D)
    dev = hs.device
    lx = lx.to(dev, torch.int32)
    ly = ly.to(dev, torch.int32)
    lane = torch.arange(Lp, device=dev, dtype=torch.int32)[None, :]
    c = carries_d1(rec, lane, B)
    term = Terminals(rec, lx, ly)
    tb = torch.empty((max(D - 2, 0), B, Lp), dtype=torch.uint8, device=dev) if traceback else None
    for d in range(2, D):
        c, cell = diagonal_step(rec, c, None, d, 0, hs[d])
        term.add(d, 0, lane, cell)
        if traceback:
            tb[d - 2] = cell["bits"]
    out = term.result()
    if traceback:
        out["tb"] = tb
    return out


# ---- checkpointed traceback -------------------------------------------------


def default_ckpt_interval(D: int) -> int:
    """Diagonals a block of the checkpointed traceback: about 8 sqrt(D),
    rounded up to 64 (``praline_tpu/kernels/scan.py:215``), which balances
    the O(D / R) carry snapshots against the O(R) block of direction bytes;
    a multiple of the Hopper walk's box depth."""
    return max(64, -(-int(8 * np.sqrt(D)) // 64) * 64)


def pack_carries(c) -> torch.Tensor:
    """The carries ``c`` of a lane range as ``f32[B, NS, w]`` in
    ``csrc/wavefront.cuh`` ``Carries::store``'s order (codes and stay bits
    as the bits of their int32): M, best(d-2) value, length and code, M
    length, x stay, the Ix levels and their lengths, best(d-1) value,
    length and code, y stay, the Iy levels and their lengths."""
    def bits(t):
        return t.to(torch.int32).view(torch.float32)

    return torch.stack([c["m1"], c["r2v"], c["r2l"], bits(c["r2c"]), c["lm1"], bits(c["psx"]),
                        *c["ix1"], *c["lix1"], c["r1v"], c["r1l"], bits(c["r1c"]),
                        bits(c["psy"]), *c["iy1"], *c["liy1"]], dim=1)


def unpack_carries(rec: Recurrence, snap: torch.Tensor):
    """The carries dict of :func:`pack_carries`'s ``f32[B, NS, w]``."""
    kc = rec.kc
    rows = [snap[:, v].contiguous() for v in range(snap.shape[1])]

    def code(v):
        return v.view(torch.int32)

    m1, r2v, r2l, r2c, lm1, psx = rows[:6]
    ix1, lix1 = rows[6:6 + kc], rows[6 + kc:6 + 2 * kc]
    r1v, r1l, r1c, psy = rows[6 + 2 * kc:10 + 2 * kc]
    iy1, liy1 = rows[10 + 2 * kc:10 + 3 * kc], rows[10 + 3 * kc:10 + 4 * kc]
    return dict(m1=m1, lm1=lm1, ix1=ix1, iy1=iy1, lix1=lix1, liy1=liy1, r1v=r1v, r1l=r1l,
                r1c=code(r1c), r2v=r2v, r2l=r2l, r2c=code(r2c), psx=code(psx), psy=code(psy))


def forward_snapshots(hs, lx, ly, gap_series, mode, interval):
    """The forward pass of the checkpointed traceback over ``hs f32[D, B,
    Lp]``: the terminal dict of :func:`wavefront_dp` and the snapshot
    ``f32[nblk, B, NS, Lp]`` of every lane's carries at the entry of each
    block of ``interval`` diagonals (block q starts at diagonal 2 + q
    interval; nblk = ceil((D - 2) / interval)).  The recurrence runs as in
    traceback mode (the stay bits a collapsed series carries) and keeps no
    direction bytes."""
    D, B, Lp = hs.shape
    rec = Recurrence(gap_series, mode, True, D)
    dev = hs.device
    lx = lx.to(dev, torch.int32)
    ly = ly.to(dev, torch.int32)
    lane = torch.arange(Lp, device=dev, dtype=torch.int32)[None, :]
    c = carries_d1(rec, lane, B)
    term = Terminals(rec, lx, ly)
    nblk = -(-(D - 2) // interval)
    snap = torch.empty((nblk, B, 10 + 4 * rec.kc, Lp), dtype=torch.float32, device=dev)
    for d in range(2, D):
        if (d - 2) % interval == 0:
            snap[(d - 2) // interval] = pack_carries(c)
        c, cell = diagonal_step(rec, c, None, d, 0, hs[d])
        term.add(d, 0, lane, cell)
    return term.result(), snap


def resume_block(hs, snap, block, interval, gap_series, mode, out=None):
    """Block ``block``'s direction bytes ``u8[interval, B, Lp]`` (row r =
    diagonal 2 + block interval + r; rows past D - 1 are 0), re-derived from
    snapshot ``block`` of :func:`forward_snapshots`: the rows of the
    traceback pass's ``tb``, byte for byte.  ``out``, where given, is the
    tensor written."""
    D, B, Lp = hs.shape
    rec = Recurrence(gap_series, mode, True, D)
    c = unpack_carries(rec, snap[block])
    d0 = 2 + block * interval
    if out is None:
        out = torch.empty((interval, B, Lp), dtype=torch.uint8, device=hs.device)
    out.zero_()
    for d in range(d0, min(d0 + interval, D)):
        c, cell = diagonal_step(rec, c, None, d, 0, hs[d])
        out[d - d0] = cell["bits"]
    return out


def wavefront_dp_checkpointed(cx, inv_x, cy, inv_y, s, lx, ly, gap_series=(11, 1),
                              mode="global", interval=None):
    """Giant-problem traceback in O(L^1.5) memory: the plain version of
    ``praline_tpu/kernels/scan.py::wavefront_dp_checkpointed`` (``:173``),
    and the parity anchor of the Hopper route (``kernels/tiled_dp.py``'s
    forward and resume launches, ``kernels/replay.py::replay_block``).

    It is the CPU route's own composition of the plain pieces:
    :func:`forward_snapshots` keeps the carries at the entry of every block
    of R = ``interval`` diagonals (default :func:`default_ckpt_interval`);
    then, from the last block to the first, :func:`resume_block` re-derives
    the block's direction bytes and ``replay_block_plain`` walks them,
    appending to the tape.  Returns the terminal dict of :func:`wavefront_dp`
    plus ``moves uint8[B, D - 1]`` and ``nmoves int32[B]`` (the
    ``kernels/replay.py`` move-tape contract, terminal to origin), in all
    three modes (local's stop rule rides bit 7)."""
    from .replay import replay_block_plain, walk_state
    from .scores import skewed_pair_scores

    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    hs = skewed_pair_scores(cx, inv_x, cy, inv_y, s)
    D, B, _ = hs.shape
    R = default_ckpt_interval(D) if interval is None else int(interval)
    out, snap = forward_snapshots(hs, lx, ly, gap_series, mode, R)
    state = walk_state(out["ti"], out["tj"], out["tcode"], len(gap_series))
    moves = torch.zeros((B, D - 1), dtype=torch.uint8, device=hs.device)
    for q in range(snap.shape[0] - 1, -1, -1):
        bits = resume_block(hs, snap, q, R, gap_series, mode)
        replay_block_plain(bits, state, moves, q, gap_series, mode)
    out["moves"] = moves
    out["nmoves"] = state[5].clone()
    return out


# ---- one superstep of the ring (dist/ring.py) ----------------------------------


def edge_values(k: int) -> int:
    """f32 values one lane hands to the next at ``k`` gap levels
    (``csrc/wavefront.cuh`` ``Carries::NX``; k = 2 collapses to one level)."""
    return 6 + 2 * (1 if k == 2 else k)


def pack_edge(e) -> torch.Tensor:
    """:func:`edge_of`'s values as ``f32[NX, B]`` in ``Carries::export_x``'s
    order (codes and the stay bit as the bits of their int32): M, best(d-2)
    value, length and code, M length, x stay, the Ix levels and their
    lengths."""
    def bits(t):
        return t.to(torch.int32).view(torch.float32)

    return torch.stack([e["m1"], e["r2v"], e["r2l"], bits(e["r2c"]), e["lm1"], bits(e["psx"]),
                        *e["ix1"], *e["lix1"]])


def unpack_edge(rec: Recurrence, x: torch.Tensor):
    """The edge dict of :func:`pack_edge`'s ``f32[NX, B]``."""
    kc = rec.kc
    rows = [x[v].contiguous() for v in range(x.shape[0])]
    return dict(m1=rows[0], r2v=rows[1], r2l=rows[2], r2c=rows[3].view(torch.int32),
                lm1=rows[4], psx=rows[5].view(torch.int32), ix1=rows[6:6 + kc],
                lix1=rows[6 + kc:6 + 2 * kc])


CANDIDATE = ("score", "length", "ti", "tj", "tcode")


def pack_candidate(t) -> torch.Tensor:
    """A terminal dict (:meth:`Terminals.result`) as one ``f32[5, B]``: score,
    length, then ti, tj and tcode as the bits of their int32 (the ring's
    per-rank candidate, ``csrc/tiled_ring.cu``)."""
    return torch.stack([t["score"], t["length"],
                        *(t[k].to(torch.int32).view(torch.float32) for k in CANDIDATE[2:])])


def unpack_candidate(c: torch.Tensor):
    """The terminal dict of :func:`pack_candidate`'s ``f32[5, B]``."""
    rows = [c[v].contiguous() for v in range(5)]
    return {"score": rows[0], "length": rows[1], "ti": rows[2].view(torch.int32),
            "tj": rows[3].view(torch.int32), "tcode": rows[4].view(torch.int32)}


@dataclasses.dataclass
class RingRows:
    """One rank's lanes of a ring's rows source: global lanes ``base ..
    base + Lpn - 1`` of a problem batch with ``Lx`` x columns.  ``cx`` and
    ``inv_x`` are lane-indexed: row l holds the x column of global lane base
    + l (x position base + l - 1), zero counts and inverse 1 at lane 0 and
    past Lx (the pad lanes of the last ranks), so those lanes score +0 as
    in the JAX package's padded layout; ``cy``, ``inv_y`` and ``s`` are
    whole.  ``scratch`` holds what the card's launches prepare once (the
    prep kernel's T and Cy rows)."""

    cx: torch.Tensor  # f32[B, Lpn, A]
    inv_x: torch.Tensor  # f32[B, Lpn]
    cy: torch.Tensor  # f32[B, Ly, A]
    inv_y: torch.Tensor  # f32[B, Ly]
    s: torch.Tensor  # f32[A, A]
    base: int
    Lx: int
    scratch: dict = dataclasses.field(default_factory=dict)

    @property
    def B(self) -> int:
        return self.cx.shape[0]

    @property
    def Lpn(self) -> int:
        return self.cx.shape[1]

    @property
    def Ly(self) -> int:
        return self.cy.shape[1]

    @property
    def D(self) -> int:
        return self.Lx + self.Ly + 1

    @property
    def device(self) -> torch.device:
        return self.cx.device


def ring_rows(cx, inv_x, cy, inv_y, s, base: int, Lpn: int, device=None) -> RingRows:
    """The :class:`RingRows` of the rank whose lanes start at ``base``, from
    the whole operands (``cx f32[B, Lx, A]`` ..., as the rows source
    takes them), on ``device`` (default: the operands')."""
    dev = cx.device if device is None else torch.device(device)
    B, Lx, A = cx.shape
    lanes_cx = torch.zeros((B, Lpn, A), dtype=torch.float32, device=dev)
    lanes_iv = torch.ones((B, Lpn), dtype=torch.float32, device=dev)
    lo, hi = max(base, 1), min(base + Lpn - 1, Lx)  # the lanes with an x column
    if lo <= hi:
        lanes_cx[:, lo - base:hi - base + 1] = cx[:, lo - 1:hi].to(dev, torch.float32)
        lanes_iv[:, lo - base:hi - base + 1] = inv_x[:, lo - 1:hi].to(dev, torch.float32)

    def whole(t):
        return t.to(dev, torch.float32).contiguous()

    return RingRows(lanes_cx, lanes_iv, whole(cy), whole(inv_y), whole(s), base, Lx)


def ring_scores(rows: RingRows, d0: int, nd: int) -> torch.Tensor:
    """The skewed scores ``f32[nd, B, Lpn]`` of diagonals d0 .. d0 + nd - 1
    on the rank's lanes, as the rows source produces them: ``T = Cx @ S``
    on the rank's lanes, then ``h = T[i-1] . Cy[j-1]`` (integers below
    2**24, so exact in any order; +0 where it is zero) and ``(h * inv_x) *
    inv_y``; +0 outside the cells, bit for bit ``skewed_pair_scores``'s
    rows."""
    dev = rows.device
    t = rows.scratch.get("T")
    if t is None:
        t = rows.scratch["T"] = torch.matmul(rows.cx, rows.s)
    lane = rows.base + torch.arange(rows.Lpn, device=dev)
    d = d0 + torch.arange(nd, device=dev)
    j = d[:, None] - lane[None, :] - 1
    valid = (lane[None, :] >= 1) & (j >= 0) & (j < rows.Ly)
    jc = j.clamp(0, rows.Ly - 1)
    h = (t[:, None] * rows.cy[:, jc]).sum(-1) + 0.0  # (B, nd, Lpn)
    h = (h * rows.inv_x[:, None]) * rows.inv_y[:, jc]
    return torch.where(valid, h, 0.0).permute(1, 0, 2)


def ring_carries(rows: RingRows, gap_series, mode) -> torch.Tensor:
    """The rank's carries at d = 1, packed (:func:`pack_carries`)."""
    rec = Recurrence(gap_series, mode, True, rows.D)
    lane = rows.base + torch.arange(rows.Lpn, device=rows.device, dtype=torch.int32)[None, :]
    return pack_carries(carries_d1(rec, lane, rows.B))


def ring_candidate(lx, ly, gap_series, mode) -> torch.Tensor:
    """A rank's candidate before the first diagonal (:func:`pack_candidate`
    of :class:`Terminals`' start: semiglobal's diagonal-1 border cells)."""
    rec = Recurrence(gap_series, mode, False, 2)
    return pack_candidate(Terminals(rec, lx.to(torch.int32), ly.to(torch.int32)).result())


def ring_superstep_plain(rows: RingRows, lx, ly, gap_series, mode, traceback, d0: int, K: int,
                         carries, heads, tails, cand, *, tb=None, tb_row0: int = 0,
                         carries_out=None, cand_out=None):
    """One superstep of the ring on one rank: diagonals d0 .. min(d0 + K -
    1, D - 1) (a chunk; ``praline_tpu/kernels/scan.py:699-731``) on the
    rank's lanes, the plain version of ``csrc/tiled_ring.cu``.

    ``carries f32[B, NS, Lpn]`` are the lanes' carries at d0 - 1
    (:func:`pack_carries`'s order, the stay bits of a collapsed series
    tracked in every mode, as the card does); ``heads f32[K, NX, B]`` the
    left rank's values before each step s (:func:`pack_edge` of its last
    lane), None on the rank with lane 0; ``cand f32[5, B]`` the rank's
    terminal candidate (:func:`pack_candidate`).  Writes the carries at
    the chunk's last diagonal into ``carries_out`` (default: in place),
    ``tails[s]`` (this rank's last lane before step s), the candidate with
    the chunk's cells into ``cand_out`` (default: in place; the modes'
    rules of :class:`Terminals` on global lanes) and, where ``tb`` is
    given, each diagonal d's bytes at ``tb[d - 2 - tb_row0]``."""
    D, base = rows.D, rows.base
    d1 = min(d0 + K - 1, D - 1)
    if not 2 <= d0 <= d1:
        raise ValueError(f"chunk at diagonal {d0} is outside 2 .. {D - 1}")
    if (heads is None) != (base == 0):
        raise ValueError("the heads come from the left rank: none on lane 0's rank, "
                         "required on the others")
    rec = Recurrence(gap_series, mode, True, D)
    dev = rows.device
    lx = lx.to(dev, torch.int32)
    ly = ly.to(dev, torch.int32)
    c = unpack_carries(rec, carries)
    lane = base + torch.arange(rows.Lpn, device=dev, dtype=torch.int32)[None, :]
    term = Terminals(rec, lx, ly)
    prev = unpack_candidate(cand)
    term.tval, term.tlen, term.ti, term.tj, term.tcode = (prev[k] for k in CANDIDATE)
    hs = ring_scores(rows, d0, d1 - d0 + 1)
    for d in range(d0, d1 + 1):
        s = d - d0
        tails[s] = pack_edge(edge_of(c))
        left = None if heads is None else unpack_edge(rec, heads[s])
        c, cell = diagonal_step(rec, c, left, d, base, hs[s])
        term.add(d, base, lane, cell)
        if tb is not None and traceback:
            tb[d - 2 - tb_row0] = cell["bits"]
    (carries if carries_out is None else carries_out).copy_(pack_carries(c))
    (cand if cand_out is None else cand_out).copy_(pack_candidate(term.result()))
