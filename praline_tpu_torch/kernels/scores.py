"""Plain skewed pair scores (the reference for the Hopper producer) and
their multi-track composite.

Counterpart of ``praline_tpu/kernels/scores.py::skewed_pair_scores``.  The
column-pair score matrix is produced in integer count space and scaled in
the pinned order (``praline_tpu/oracle/score.py:59-68``)::

    H_int = (Cx @ S) @ Cy^T            exact: integer operands, sums < 2**24
    H     = (H_int * inv_x) * inv_y    two separately rounded multiplies

then skewed so that anti-diagonal ``d`` of the DP grid is the row
``hs[d]``: ``hs[d, b, i] = H[b, i-1, d-i-1]`` for interior cells and zero
elsewhere, shape ``f32[D = Lx+Ly+1, B, Lx+1]``.  Because every partial sum
is an exactly representable integer, any summation order (CPU BLAS, the
card's f32 GEMM, the CUDA kernel's own loop) gives the same bits.
"""

from __future__ import annotations

import torch


def skewed_pair_scores(cx, inv_x, cy, inv_y, s) -> torch.Tensor:
    """``f32[D, B, Lx+1]`` skewed scores of a batch of profile pairs.

    ``cx f32[B, Lx, A]``, ``inv_x f32[B, Lx]``, ``cy f32[B, Ly, A]``,
    ``inv_y f32[B, Ly]``, ``s f32[A, A]``, all on one device.
    """
    t = torch.matmul(cx, s)
    h_int = torch.matmul(t, cy.transpose(1, 2))
    h = (h_int * inv_x[:, :, None]) * inv_y[:, None, :]
    return skew(h, cx.shape[1], cy.shape[1])


def skew(h, Lx: int, Ly: int) -> torch.Tensor:
    """``f32[B, Lx, Ly]`` column-pair scores as ``f32[D, B, Lx+1]``:
    ``hs[d, b, i] = h[b, i-1, d-i-1]`` for interior cells, +0 elsewhere."""
    D = Lx + Ly + 1
    dev = h.device
    d_idx = torch.arange(D, device=dev)[:, None]
    i_idx = torch.arange(Lx + 1, device=dev)[None, :]
    j_idx = d_idx - i_idx - 1
    valid = (i_idx >= 1) & (j_idx >= 0) & (j_idx <= Ly - 1)
    i_g = (i_idx - 1).clamp(0, max(Lx - 1, 0)).expand(D, Lx + 1)
    j_g = j_idx.clamp(0, max(Ly - 1, 0))
    hs = h[:, i_g, j_g]  # (B, D, Lp)
    hs = torch.where(valid[None], hs, torch.zeros((), dtype=hs.dtype, device=dev))
    return hs.permute(1, 0, 2).contiguous()


def composite_skewed_scores(cxs, inv_xs, cys, inv_ys, ss, weights) -> torch.Tensor:
    """Multi-track composite ``f32[D, B, Lx+1]``: the weighted sum of the
    per-track skewed scores, accumulated in track order with every multiply
    and add rounded on its own (``praline_tpu/kernels/scores.py:98-122``).
    Each argument is a sequence with one entry a track; the tracks share
    ``B``, ``Lx`` and ``Ly`` and may differ in alphabet."""
    acc = None
    for cx, inv_x, cy, inv_y, s, w in zip(cxs, inv_xs, cys, inv_ys, ss, weights):
        term = skewed_pair_scores(cx, inv_x, cy, inv_y, s) * track_weight(w)
        acc = term if acc is None else acc + term
    return acc


def track_weight(w) -> torch.Tensor:
    """A track weight as the f32 the JAX package multiplies by
    (``jnp.float32(w)``), as a 0-dim CPU tensor (a scalar on any device)."""
    return torch.tensor(float(w), dtype=torch.float32)
