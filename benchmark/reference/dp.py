"""The plain pairwise DP of PRALINE's gap-series model, batched in PyTorch.

The benchmark's own statement of the recurrence that decides ``correct``:
plain ``torch`` operations over anti-diagonals, a batch of problems at a
time, on whatever device the tensors live on.  It imports nothing of the
program.  Semantics (those of the port's documentation, SURVEY.md §8):

* Gap series ``G = (g1..gk)``: the m-th consecutive gap column costs
  ``G[min(m, k) - 1]``.  States: ``M`` and ``k`` gap levels a direction
  (``X``: a gap in y, consuming x; ``Y`` the mirror).  Level 1 enters from
  ``M``; level l < k from level l - 1; level k from level k - 1 or itself,
  ties to the lower level (with k == 1: from ``M`` or itself, ties to ``M``).
* ``M`` takes the strictly best of ``M``, ``X1..Xk``, ``Y1..Yk`` at the
  diagonal predecessor, in that order of preference, plus the cell's score.
* Global mode only: borders carry the cumulative gap cost and the terminal
  is ``(lx, ly)``, its state the strictly best in the same order.  The
  length of a result is the number of columns of its traceback path.

Cells are computed in ``dtype`` (float32 for the reference; the control
passes bfloat16).  Lanes are the x index ``i`` of diagonal ``d = i + j``;
every state array carries one pad lane in front so that the predecessor at
``i - 1`` is a view.  Lanes past a problem's true lengths compute garbage
that no cell of that problem reads.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -1.0e30
GAP = -1


def _scores_on_diagonal(source, d: int, lanes: torch.Tensor) -> torch.Tensor:
    """The cell scores of diagonal ``d`` at lanes ``i = 0..Lx``: ``h[i-1, d-i-1]``
    (lanes outside a problem read a clamped, meaningless score)."""
    kind = source[0]
    if kind == "tokens":  # ("tokens", x_pad[B, Lx+1] = x[i-1]*A, y[B, Ly], S_flat)
        _, xa, y, s_flat = source
        col = (d - 1 - lanes).clamp_(0, y.shape[1] - 1)
        return s_flat[xa + y.gather(1, col.expand(y.shape[0], -1))]
    _, h_flat, base, ncell = source  # ("dense", h[B, Lx*Ly], (i-1)*Ly - 1 - i, Lx*Ly)
    idx = (base + d).clamp_(0, ncell - 1)
    return h_flat.gather(1, idx.expand(h_flat.shape[0], -1))


def _run(source, lx: torch.Tensor, ly: torch.Tensor, Lx: int, Ly: int, gap_series,
         dtype, traceback: bool):
    """The recurrence over every diagonal.  Returns the states at each
    problem's terminal ``(lx, ly)`` (``[2k+1, B]`` values, lengths or None)
    and, with ``traceback``, the pointers ``[B, Lx+Ly+1, Lx+1]`` (uint8:
    M's predecessor code, the X and Y top levels' stay flags)."""
    dev = lx.device
    B, k = lx.shape[0], len(gap_series)
    S = 2 * k + 1  # state order: M, X1..Xk, Y1..Yk
    g = [torch.tensor(float(v), dtype=dtype, device=dev) for v in gap_series]
    W = Lx + 2  # pad lane, lanes 0..Lx
    bufs = [torch.full((S, B, W), NEG, dtype=dtype, device=dev) for _ in range(3)]
    lens = None if traceback else [torch.zeros((S, B, W), dtype=torch.int32, device=dev)
                                   for _ in range(3)]
    lanes = torch.arange(Lx + 1, device=dev)
    bufs[0][0, :, 1] = 0.0  # diagonal 0 (diagonal -1 is bufs[2], all NEG): M(0, 0) = 0
    term_d = (lx + ly).long()
    at = (lx.long() + 1).view(1, B, 1).expand(S, B, 1)
    term_v = torch.full((S, B), NEG, dtype=dtype, device=dev)
    term_l = None if traceback else torch.zeros((S, B), dtype=torch.int32, device=dev)
    ends = set(term_d.tolist())
    D = Lx + Ly
    if traceback:
        ptr = torch.zeros((B, D + 1, Lx + 1), dtype=torch.uint8, device=dev)
        stay_x = torch.zeros((B, D + 1, Lx + 1), dtype=torch.bool, device=dev)
        stay_y = torch.zeros((B, D + 1, Lx + 1), dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    for d in range(1, D + 1):
        p2, p1, cur = bufs[(d - 2) % 3], bufs[(d - 1) % 3], bufs[d % 3]
        up, left, diag = p1[:, :, :-1], p1[:, :, 1:], p2[:, :, :-1]
        out = cur[:, :, 1:]
        if lens is not None:
            lp2, lp1, lcur = lens[(d - 2) % 3], lens[(d - 1) % 3], lens[d % 3]
            lup, lleft, ldiag, lout = lp1[:, :, :-1], lp1[:, :, 1:], lp2[:, :, :-1], lcur[:, :, 1:]
        for side, src, lsrc, off in (("x", up, None if lens is None else lup, 1),
                                     ("y", left, None if lens is None else lleft, 1 + k)):
            # level 1 .. k - 1: a chain from M, then from the level below
            for lvl in range(k - 1):
                prev = 0 if lvl == 0 else off + lvl - 1
                torch.sub(src[prev], g[lvl], out=out[off + lvl])
                if lens is not None:
                    torch.add(lsrc[prev], one, out=lout[off + lvl])
            lo = 0 if k == 1 else off + k - 2
            a, b = src[lo], src[off + k - 1]
            stay = b > a
            torch.sub(torch.where(stay, b, a), g[k - 1], out=out[off + k - 1])
            if lens is not None:
                torch.add(torch.where(stay, lsrc[off + k - 1], lsrc[lo]), one,
                          out=lout[off + k - 1])
            if traceback:
                (stay_x if side == "x" else stay_y)[:, d] = stay
        best = diag[0].clone()
        lbest = None if lens is None else ldiag[0].clone()
        code = torch.zeros_like(best, dtype=torch.uint8) if traceback else None
        for s in range(1, S):
            v = diag[s]
            gt = v > best
            best = torch.where(gt, v, best)
            if lens is not None:
                lbest = torch.where(gt, ldiag[s], lbest)
            if traceback:
                code.masked_fill_(gt, s)
        h = _scores_on_diagonal(source, d, lanes).to(dtype)
        torch.add(h, best, out=out[0])
        if lens is not None:
            torch.add(lbest, one, out=lout[0])
        if traceback:
            ptr[:, d] = code
        if d in ends:
            done = term_d == d
            term_v = torch.where(done, cur.gather(2, at).squeeze(2), term_v)
            if lens is not None:
                term_l = torch.where(done, lens[d % 3].gather(2, at).squeeze(2), term_l)
    pointers = (ptr, stay_x, stay_y) if traceback else None
    return term_v, term_l, pointers


def _terminal(term_v: torch.Tensor) -> torch.Tensor:
    """Index of the strictly best state a problem ends in, in the order
    M, X1..Xk, Y1..Yk."""
    best = term_v[0].clone()
    which = torch.zeros_like(best, dtype=torch.long)
    for s in range(1, term_v.shape[0]):
        gt = term_v[s] > best
        best = torch.where(gt, term_v[s], best)
        which = torch.where(gt, torch.full_like(which, s), which)
    return which


def _check_mode(mode: str) -> None:
    if mode != "global":
        raise ValueError(f"the reference DP states global mode only, not {mode!r}")


def token_source(tokens: list[np.ndarray], px: np.ndarray, py: np.ndarray, S: np.ndarray,
                 device, dtype):
    """Pairs ``(tokens[px[b]], tokens[py[b]])`` of residue tokens scored by the
    matrix ``S``: ``h = S[x_i, y_j]``."""
    A = S.shape[0]
    L = max(len(t) for t in tokens)
    T = np.zeros((len(tokens), L + 1), dtype=np.int64)
    for n, t in enumerate(tokens):
        T[n, 1:len(t) + 1] = t
    T = torch.as_tensor(T, device=device)
    px = torch.as_tensor(np.asarray(px, np.int64), device=device)
    py = torch.as_tensor(np.asarray(py, np.int64), device=device)
    Lx = max(len(tokens[i]) for i in set(px.tolist()))
    Ly = max(len(tokens[i]) for i in set(py.tolist()))
    s_flat = torch.as_tensor(np.asarray(S, np.float32).reshape(-1), device=device).to(dtype)
    return (("tokens", T[px, :Lx + 1] * A, T[py, 1:Ly + 1], s_flat), Lx, Ly)


def dense_source(h: list[torch.Tensor], device, dtype):
    """Problems given as score matrices ``h[lx, ly]``."""
    B = len(h)
    Lx, Ly = max(t.shape[0] for t in h), max(t.shape[1] for t in h)
    flat = torch.zeros((B, Lx, Ly), dtype=dtype, device=device)
    for b, t in enumerate(h):
        flat[b, :t.shape[0], :t.shape[1]] = t.to(device=device, dtype=dtype)
    i = torch.arange(Lx + 1, device=device)
    return (("dense", flat.view(B, Lx * Ly), (i - 1) * Ly - 1 - i, Lx * Ly), Lx, Ly)


def scores_and_lengths(source, lx, ly, gap_series, mode="global", dtype=torch.float32):
    """Scores (float64) and alignment lengths (int64) of a batch of problems,
    no traceback: each state carries the length of the path its traceback
    would take.  ``source`` is ``(source, Lx, Ly)`` from :func:`token_source`."""
    _check_mode(mode)
    src, Lx, Ly = source
    dev = src[1].device
    lx_t = torch.as_tensor(np.asarray(lx), device=dev)
    ly_t = torch.as_tensor(np.asarray(ly), device=dev)
    term_v, term_l, _ = _run(src, lx_t, ly_t, Lx, Ly, gap_series, dtype, False)
    which = _terminal(term_v).unsqueeze(0)
    score = term_v.gather(0, which).squeeze(0).double().cpu().numpy()
    length = term_l.gather(0, which).squeeze(0).long().cpu().numpy()
    return score, length


def paths(source, lx, ly, gap_series, mode="global", dtype=torch.float32):
    """Full-coverage traceback paths ``(cols_x, cols_y)`` of a batch of
    problems (0-based column indices, :data:`GAP` for a gap)."""
    _check_mode(mode)
    src, Lx, Ly = source
    dev = src[1].device
    lx = np.asarray(lx, dtype=np.int64)
    ly = np.asarray(ly, dtype=np.int64)
    term_v, _, (ptr, stay_x, stay_y) = _run(
        src, torch.as_tensor(lx, device=dev), torch.as_tensor(ly, device=dev), Lx, Ly,
        gap_series, dtype, True)
    which = _terminal(term_v).cpu().numpy()
    ptr, stay_x, stay_y = ptr.cpu().numpy(), stay_x.cpu().numpy(), stay_y.cpu().numpy()
    k = len(gap_series)
    return [_walk(ptr[b], stay_x[b], stay_y[b], int(which[b]), int(lx[b]), int(ly[b]), k)
            for b in range(len(lx))]


def _walk(ptr, stay_x, stay_y, state: int, i: int, j: int, k: int):
    """One problem's traceback from its terminal state (code: 0 M, 1..k X
    levels, k+1..2k Y levels), pointers indexed ``[i + j, i]``."""
    rx: list[int] = []
    ry: list[int] = []
    kind, lvl = ("M", 0) if state == 0 else (("X", state) if state <= k else ("Y", state - k))
    while i > 0 or j > 0:
        if kind == "M":
            rx.append(i - 1)
            ry.append(j - 1)
            code = int(ptr[i + j, i])
            i -= 1
            j -= 1
            kind, lvl = ("M", 0) if code == 0 else (("X", code) if code <= k else ("Y", code - k))
        elif kind == "X":
            rx.append(i - 1)
            ry.append(GAP)
            if j == 0:  # border run: straight to the origin
                i -= 1
                lvl = min(i, k)
                continue
            stay = bool(stay_x[i + j, i])
            i -= 1
            if lvl == k:
                if k == 1:
                    kind = "X" if stay else "M"
                else:
                    lvl = k if stay else k - 1
            elif lvl == 1:
                kind = "M"
            else:
                lvl -= 1
        else:
            rx.append(GAP)
            ry.append(j - 1)
            if i == 0:
                j -= 1
                lvl = min(j, k)
                continue
            stay = bool(stay_y[i + j, i])
            j -= 1
            if lvl == k:
                if k == 1:
                    kind = "Y" if stay else "M"
                else:
                    lvl = k if stay else k - 1
            elif lvl == 1:
                kind = "M"
            else:
                lvl -= 1
    return np.asarray(rx[::-1], dtype=np.int32), np.asarray(ry[::-1], dtype=np.int32)
