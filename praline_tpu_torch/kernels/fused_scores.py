"""The Hopper score producer, its two tiers and its wrapper.

Replaces the TPU kernels ``praline_tpu/kernels/fused_scores.py::
fused_skewed_scores`` (classic layout) and ``::fused_skewed_scores_strip``
(strip-packed layout).  The two differ only in how the TPU packs lanes; on
the card each tier emits the per-problem layout of
``kernels/scores.py::skewed_pair_scores`` (its plain version), which the
Hopper DP reads directly.

Two kernels compute the same bits, chosen by the caller's ``tier``:

- ``"mma"`` (``csrc/scores_mma.cu``): the pair-score tile on the integer
  tensor cores, ``T = Cx @ S`` split into s8/u8 limbs against ``Cy`` as
  u8 limbs (one where no count passes 255, two up to 65535), exact under
  :func:`tensor_core_exact` (the proof is in the source).
  The Hopper counterpart of the JAX package's provable MXU tiers
  (``praline_tpu/kernels/batch.py:999-1038``), under its own predicate.
- ``"scalar"`` (``csrc/scores.cu``): f32 chains on the CUDA cores, exact
  for every input ``oracle/score.py::check_exactness`` admits (dyadic
  counts, counts past 65535, ``|T|`` of 2**15 and more).

The batch drivers pass :func:`score_tier` of statistics cached on the
host per profile (:func:`side_stats`, :func:`matrix_stats`), so choosing a
tier never reads the device.  Bound on the H100: the write of ``hs``
(``D * (Lx+1)`` f32 a problem).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import build
from .scores import skew, skewed_pair_scores as skewed_pair_scores_plain

TIERS = ("mma", "scalar")
# Kernel launches by fused_skewed_scores per tier (not by the plain path).
launches = {tier: 0 for tier in TIERS}

MAX_ALPHABET = 32
MAX_BATCH = 65535  # grid z


def reset_launches() -> None:
    for tier in TIERS:
        launches[tier] = 0


@dataclasses.dataclass(frozen=True)
class SideStats:
    """Exactness statistics of one side's profiles (a chunk's: the largest
    over its members).  ``tmax`` is ``max |counts @ S|``, the x side's
    tensor-core operand, for one matrix (0.0 where it was not asked for)."""

    ints: bool    # every count a non-negative integer
    cmax: float   # largest count
    tot: float    # largest column total
    tmax: float = 0.0


@dataclasses.dataclass(frozen=True)
class MatrixStats:
    integral: bool
    max_s: float


def side_stats(counts, s=None) -> SideStats:
    """:class:`SideStats` of ``counts f32[..., L, A]`` (one profile or a
    stack); ``tmax`` against ``s f32[A, A]`` where it is given.  Host
    numpy, in float64: every value it takes is exact."""
    c = np.asarray(counts, dtype=np.float64)
    return SideStats(
        ints=bool(np.all((c == np.rint(c)) & (c >= 0))),
        cmax=float(c.max(initial=0.0)),
        tot=float(c.sum(axis=-1).max(initial=0.0)),
        tmax=0.0 if s is None else t_max(c, s),
    )


def t_max(counts, s) -> float:
    """Exact ``max |counts @ S|`` (host numpy, float64): the x side's
    tensor-core operand, the counterpart of the JAX package's
    ``stack_tmax`` (``praline_tpu/kernels/batch.py:977-996``)."""
    t = np.asarray(counts, dtype=np.float64) @ np.asarray(s, dtype=np.float64)
    return float(np.abs(t).max(initial=0.0))


def matrix_stats(s) -> MatrixStats:
    m = np.asarray(s, dtype=np.float64)
    return MatrixStats(integral=bool(np.all(m == np.rint(m))),
                       max_s=float(np.abs(m).max(initial=0.0)))


def tensor_core_exact(stats_x: SideStats, stats_y: SideStats, m: MatrixStats) -> bool:
    """True when ``csrc/scores_mma.cu`` returns the plain version's bits
    for these operands (the proof sits beside the kernel):

    - P1: every count is a non-negative integer and ``S`` is integral;
    - P2: every ``Cy`` count is at most 65535 (two u8 limbs,
      ``Cy = 256 * (Cy >> 8) + (Cy & 255)``);
    - P3: every ``|T| = |(Cx @ S)[i, c]|`` is at most 32767, so ``T >> 8``
      is an s8 and ``T & 255`` a u8;
    - P4: ``tot_x * max|S| < 2**31``: ``T``'s int32 partial sums;
    - P5: ``tot_x * tot_y * max|S| < 2**24``: ``|H_int|`` converts to f32
      exactly (``oracle/score.py::check_exactness``).
    """
    return (
        m.integral and stats_x.ints and stats_y.ints                       # P1
        and stats_y.cmax <= 65535                                          # P2
        and stats_x.tmax <= 32767                                          # P3
        and stats_x.tot * max(m.max_s, 1.0) < 2.0**31                      # P4
        and stats_x.tot * stats_y.tot * m.max_s < 2.0**24                  # P5
    )


def score_tier(stats_x: SideStats, stats_y: SideStats, m: MatrixStats) -> str:
    """``"mma"`` where :func:`tensor_core_exact` admits the operands, else
    ``"scalar"``."""
    return "mma" if tensor_core_exact(stats_x, stats_y, m) else "scalar"


def mma_scratch_bytes(B: int, Lx: int, Ly: int) -> int:
    """Device bytes the "mma" tier's prep writes (``csrc/score_box.cuh``
    ``MmaOperands``): two 32-byte limbs and a flag a row of either side
    (``T``'s of x, the counts' of y)."""
    return 65 * B * (Lx + Ly)


def tier_of(cx, cy, s) -> str:
    """:func:`score_tier` of operands held on the host as arrays (a bench's
    or a test's, not the batch drivers', which cache their statistics)."""
    s = np.asarray(s)
    return score_tier(side_stats(cx, s), side_stats(cy), matrix_stats(s))


def skewed_pair_scores_limbs(cx, inv_x, cy, inv_y, s) -> torch.Tensor:
    """The "mma" tier's integer arithmetic (:func:`pair_scores_limbs`),
    skewed as ``skewed_pair_scores``."""
    return skew(pair_scores_limbs(cx, inv_x, cy, inv_y, s), cx.shape[1], cy.shape[1])


def pair_scores_limbs(cx, inv_x, cy, inv_y, s) -> torch.Tensor:
    """The "mma" tier's integer arithmetic in torch int64 on the CPU, for
    operands :func:`tensor_core_exact` admits, step for step as the
    kernel's tiles (``csrc/score_box.cuh`` ``box_rows``): ``T`` exact,
    split into ``T >> 8`` and ``T & 255`` (one pass where every ``|T| <=
    127``), each limb's product with a limb of ``Cy`` recombined as ``256 *
    P_hi + P_lo``; where a count passes 255, ``Cy`` split the same way and
    ``H = T @ Cy_lo^T + 256 * (T @ Cy_hi^T)``; every value checked to stay
    inside int32 (the proof's bounds); then the f32 conversion and the
    pinned scale: ``f32[B, Lx, Ly]``.  On a slice of rows and columns it is
    the arithmetic of one box (``kernels/tiled_dp.py::visit_box_plain``)."""
    cxi, cyi = cx.to(torch.int64), cy.to(torch.int64)
    t = torch.matmul(cxi, s.to(torch.int64))
    one_pass = bool((t.abs() <= 127).all())
    hi, lo = t >> 8, t & 255
    assert one_pass or (int(hi.min()) >= -128 and int(hi.max()) <= 127)

    def int32(h):
        assert h.numel() == 0 or int(h.abs().max()) < 2**31
        return h

    def product(v):  # T @ V^T for a u8 limb V of Cy
        vt = v.transpose(1, 2)
        if one_pass:
            return int32(torch.matmul(t, vt))
        return int32(int32(int32(torch.matmul(hi, vt)) * 256) + int32(torch.matmul(lo, vt)))

    h_int = product(cyi & 255)
    if cyi.numel() and int(cyi.max()) > 255:
        assert int(cyi.max()) <= 65535
        h_int = int32(h_int + int32(product(cyi >> 8) * 256))
    assert h_int.numel() == 0 or int(h_int.abs().max()) < 2**24
    return (h_int.to(torch.float32) * inv_x[:, :, None]) * inv_y[:, None, :]


def fused_skewed_scores(cx, inv_x, cy, inv_y, s, *, tier: str, out=None) -> torch.Tensor:
    """``f32[D, B, Lx+1]`` skewed scores; bit-identical to
    ``skewed_pair_scores``.  ``tier`` is ``"mma"`` (only for operands
    :func:`tensor_core_exact` admits) or ``"scalar"``.  CPU tensors take the
    plain version on either tier; CUDA tensors launch the tier's kernel on
    the current stream (or raise).  ``out``, where given, is the tensor
    written (every element of it) and returned."""
    if tier not in TIERS:
        raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
    if cx.device.type == "cpu":
        hs = skewed_pair_scores_plain(cx, inv_x, cy, inv_y, s)
        return hs if out is None else out.copy_(hs)
    B, Lx, A = cx.shape
    Ly = cy.shape[1]
    _check(cx, (B, Lx, A), "cx")
    _check(inv_x, (B, Lx), "inv_x")
    _check(cy, (B, Ly, A), "cy")
    _check(inv_y, (B, Ly), "inv_y")
    _check(s, (A, A), "s")
    dev = cx.device
    shape = (Lx + Ly + 1, B, Lx + 1)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    _check(out, shape, "out")
    for t in (inv_x, cy, inv_y, s, out):
        if t.device != dev:
            raise ValueError("all operands and out must be on one device")
    if not (1 <= A <= MAX_ALPHABET and 1 <= B <= MAX_BATCH and Lx >= 1 and Ly >= 1):
        raise ValueError(f"shape B={B} Lx={Lx} Ly={Ly} A={A} outside the kernel's range")
    lib = build.load_library()
    ptrs = (cx.data_ptr(), inv_x.data_ptr(), cy.data_ptr(), inv_y.data_ptr(), s.data_ptr(),
            out.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if tier == "mma":
            scratch = torch.empty(mma_scratch_bytes(B, Lx, Ly), dtype=torch.uint8, device=dev)
            rc = lib.praline_skewed_scores_mma(*ptrs, scratch.data_ptr(), B, Lx, Ly, A, stream)
            build.check(rc, "praline_skewed_scores_mma")
        else:
            rc = lib.praline_skewed_scores(*ptrs, B, Lx, Ly, A, stream)
            build.check(rc, "praline_skewed_scores")
    launches[tier] += 1
    return out


def _check(t, shape, name) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
