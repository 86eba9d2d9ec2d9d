"""Plain batched anti-diagonal wavefront DP: the reference for the Hopper DP.

Counterpart of ``praline_tpu/kernels/scan.py::wavefront_dp`` (the
single-device, materialized-``hs`` form of ``_wavefront``), written as a
torch loop over anti-diagonals.  It is the parity anchor of the CUDA kernel
in ``kernels/wavefront.py`` and the path every CPU run takes.

Layout: diagonal vectors are indexed by lane ``i`` (rows consumed of x);
lane ``i`` of diagonal ``d`` holds cell ``(i, d - i)``.  Per-problem true
lengths ``lx, ly`` are at most the bucket shape; padded cells compute
values that only flow to other padded cells, and terminals are read at the
true lengths.

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
    """Lane i <- lane i-1, ``fill`` at lane 0."""
    out = torch.empty_like(v)
    out[:, 0] = fill
    out[:, 1:] = v[:, :-1]
    return out


def _take(v, idx):
    """v (B, Lp), idx (B,) -> v[b, idx[b]]."""
    return v.gather(1, idx.clamp(0, v.shape[1] - 1).long()[:, None])[:, 0]


def wavefront_dp(hs, lx, ly, gap_series=(11, 1), mode="global", traceback=False):
    """Run the batched DP over skewed scores ``hs f32[D, B, Lp]``.

    Returns a dict of per-problem terminals: ``score`` f32[B], ``length``
    f32[B] (emitted path columns; semiglobal excludes the free trailing
    gaps, which the caller adds), ``ti``/``tj`` int32[B] terminal cell,
    ``tcode`` int32[B] terminal state code, and with ``traceback`` the
    direction bytes ``tb`` uint8[D-2, B, Lp].
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    k = len(gap_series)
    if not 1 <= k <= 15:
        raise ValueError("gap series must have 1 to 15 levels")
    D, B, Lp = hs.shape
    dev = hs.device
    f32, i32 = torch.float32, torch.int32
    lx = lx.to(dev, i32)
    ly = ly.to(dev, i32)
    g = [float(np.float32(x)) for x in gap_series]
    collapsed = k == 2
    kc = 1 if collapsed else k
    track_stay = collapsed and traceback
    local = mode == "local"
    semi = mode == "semiglobal"

    cum = _gap_prefix(gap_series, D + 1)
    lane = torch.arange(Lp, device=dev, dtype=i32)[None, :]
    zeros = torch.zeros((B, Lp), dtype=f32, device=dev)
    negs = torch.full((B, Lp), NEG, dtype=f32, device=dev)
    izeros = torch.zeros((B, Lp), dtype=i32, device=dev)

    # ---- carries at d = 1: cells (0, 1) on lane 0 and (1, 0) on lane 1 ----
    border_m = 0.0 if local else NEG
    m1 = torch.where((lane == 0) | (lane == 1), border_m, negs)
    lm1 = zeros
    ix1 = [negs] * kc
    iy1 = [negs] * kc
    lix1 = [zeros] * kc
    liy1 = [zeros] * kc
    if not local:
        bval = 0.0 if semi else -float(cum[1])
        ix1[0] = torch.where(lane == 1, bval, negs)
        iy1[0] = torch.where(lane == 0, bval, negs)
        lix1[0] = torch.where(lane == 1, 1.0, zeros)
        liy1[0] = torch.where(lane == 0, 1.0, zeros)
    # best-state rows: r2 = diagonal 0 (cell (0,0), M = 0), r1 = diagonal 1
    r2v = torch.where(lane == 0, 0.0, negs)
    r2l = zeros
    r2c = izeros
    codes_x = [1] if collapsed else [1 + l for l in range(k)]
    codes_y = [1 + k] if collapsed else [1 + k + l for l in range(k)]
    r1v, r1l, r1c = _priority_select(m1, ix1, iy1, lm1, lix1, liy1, codes_x, codes_y)
    psx = psy = izeros

    # ---- terminal trackers ----
    tval = torch.full((B,), NEG, dtype=f32, device=dev)
    tlen = torch.zeros((B,), dtype=f32, device=dev)
    ti = torch.zeros((B,), dtype=i32, device=dev)
    tj = torch.zeros((B,), dtype=i32, device=dev)
    tcode = torch.zeros((B,), dtype=i32, device=dev)
    if semi:
        # diagonal-1 border cells are candidates when a side has length 1;
        # (1, 0) is preferred over (0, 1) (larger i).
        for pick, ci, cj, cc in ((ly == 1, 0, 1, 1 + k), (lx == 1, 1, 0, 1)):
            tval = torch.where(pick, 0.0, tval)
            tlen = torch.where(pick, 1.0, tlen)
            ti = torch.where(pick, ci, ti)
            tj = torch.where(pick, cj, tj)
            tcode = torch.where(pick, cc, tcode)

    tb = torch.empty((max(D - 2, 0), B, Lp), dtype=torch.uint8, device=dev) if traceback else None

    for d in range(2, D):
        hrow = hs[d]
        m1s = _shift(m1, NEG)
        b2vs = _shift(r2v, NEG)
        lm1s = _shift(lm1, 0.0)
        b2ls = _shift(r2l, 0.0)
        b2cs = _shift(r2c, 0)
        ix1s = [_shift(v, NEG) for v in ix1]
        lix1s = [_shift(v, 0.0) for v in lix1]

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
        # Only two lanes change, so they are written in place (every
        # tensor written here was created in this step).
        def border(v, at0_val, atd_val):
            v[:, 0] = at0_val
            if d < Lp:
                v[:, d] = atd_val

        border(nm, border_m, border_m)
        border(nlm, 0.0, 0.0)
        bx = 0.0 if semi else -float(cum[d])
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
            bv, bl, bc = _priority_select(
                nm, nix, niy, nlm, nlix, nliy, [1 + sxi], [1 + k + syi]
            )
        else:
            bv, bl, bc = _priority_select(nm, nix, niy, nlm, nlix, nliy, codes_x, codes_y)

        # ---- terminal tracking ----
        if mode == "global":
            pick = (lx + ly) == d
            tval = torch.where(pick, _take(bv, lx), tval)
            tlen = torch.where(pick, _take(bl, lx), tlen)
            tcode = torch.where(pick, _take(bc, lx), tcode)
            ti = torch.where(pick, lx, ti)
            tj = torch.where(pick, ly, tj)
        elif semi:
            # candidate A: last-column cell (d - ly, ly); then candidate B:
            # last-row cell (lx, d - lx).  Ties keep larger i, then larger j.
            for ci, cj in ((d - ly, ly), (lx, d - lx)):
                ok = (ci >= 0) & (ci <= lx) & (cj >= 0) & (cj <= ly)
                cv, cl, cc = _take(bv, ci), _take(bl, ci), _take(bc, ci)
                better = cv > tval
                tie = (cv == tval) & ((ci > ti) | ((ci == ti) & (cj > tj)))
                repl = ok & (better | tie)
                tval = torch.where(repl, cv, tval)
                tlen = torch.where(repl, cl, tlen)
                tcode = torch.where(repl, cc, tcode)
                ti = torch.where(repl, ci, ti)
                tj = torch.where(repl, cj, tj)
        else:  # local: running argmax over interior M cells
            valid = (lane >= 1) & (lane <= lx[:, None]) & (d - lane >= 1) & (
                d - lane <= ly[:, None]
            )
            mv = torch.where(valid, nm, NEG)
            step_best, _ = mv.max(dim=1)
            # first maximal lane = smallest i (the pinned tie-break)
            step_arg = (mv == step_best[:, None]).to(torch.uint8).argmax(dim=1).to(i32)
            step_len = _take(nlm, step_arg)
            cj = d - step_arg
            better = step_best > tval
            tie = (step_best == tval) & ((step_arg < ti) | ((step_arg == ti) & (cj < tj)))
            repl = better | tie
            tval = torch.where(repl, step_best, tval)
            tlen = torch.where(repl, step_len, tlen)
            ti = torch.where(repl, step_arg, ti)
            tj = torch.where(repl, cj, tj)

        if traceback:
            bits = mcode.to(torch.uint8)
            if local:
                bits = bits | ((nm <= 0.0).to(torch.uint8) << 7)
            if collapsed:
                # bit 5 = previous diagonal's x-stay shifted one lane
                # (cell (i-1, j)); bit 6 = previous y-stay on the same lane
                bits = bits | (_shift(psx, 0).to(torch.uint8) << 5)
                bits = bits | (psy.to(torch.uint8) << 6)
            else:
                bits = bits | (stay_x.to(torch.uint8) << 5)
                bits = bits | (stay_y.to(torch.uint8) << 6)
            tb[d - 2] = bits

        m1, ix1, iy1, lm1, lix1, liy1 = nm, nix, niy, nlm, nlix, nliy
        r2v, r2l, r2c = r1v, r1l, r1c
        r1v, r1l, r1c = bv, bl, bc
        if track_stay:
            psx, psy = sxi, syi

    out = {"score": tval, "length": tlen, "ti": ti, "tj": tj, "tcode": tcode}
    if traceback:
        out["tb"] = tb
    return out
