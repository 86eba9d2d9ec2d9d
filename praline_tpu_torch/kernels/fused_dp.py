"""The Hopper fused producer + DP (``csrc/fused_dp.cu``) and its wrapper.

Replaces three JAX functions that compute one function without holding
the score matrix in device memory: the Pallas kernel
``praline_tpu/kernels/fused_dp.py::wavefront_dp_fused`` (a score band in
VMEM), the chunked route ``praline_tpu/kernels/chunked.py::
wavefront_dp_chunked`` (band chunks with carried DP state) and the
streamed scan ``praline_tpu/kernels/scan.py::wavefront_dp_streamed``.  The
contract is the plain composition ``kernels/scan.py::wavefront_dp`` over
``kernels/scores.py::skewed_pair_scores``, bit for bit: ``score``,
``length``, ``ti``, ``tj``, ``tcode`` and, with traceback, ``tb
uint8[D-2, B, Lp]``.  (The Pallas kernel's band-padded ``tb`` rows and its
``lengths=False`` zeros are not part of it.)

On the card a problem runs on a thread-block cluster of ``R`` CTAs of
``W`` lanes, one lane a thread, walking the diagonals in boxes of ``T``
with the tile edge handed from CTA to CTA in distributed shared memory
(:func:`fused_geometry`); the plain twin of that schedule is
``kernels/tiled_dp.py::wavefront_dp_tiled_plain(rows, tile_lanes=W,
steps_per_visit=T)``.  The score tier is the caller's: ``"mma"`` (each
box's scores on the int8 tensor cores into shared memory, only for
operands ``fused_scores.tensor_core_exact`` admits) or ``"scalar"`` (f32
dot products in place).  Bound on the H100: the chain of dependent
diagonals.  No ``hs`` tensor, so memory is ``O(B * (Lx + Ly) * A)`` and
``Ly`` is unbounded; lanes are bounded by the cluster: :data:`MAX_LANES_FUSED`.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import build
from .fused_scores import TIERS, mma_scratch_bytes
from .scan import MODES
from .scan import wavefront_dp as wavefront_dp_plain
from .scores import skewed_pair_scores

# Kernel launches by wavefront_dp_fused per score tier (not by the plain path).
launches = {tier: 0 for tier in TIERS}

MAX_LEVELS = 15
MAX_ALPHABET = 32
CTA_LANES = 512  # W at most: lanes (= threads) of a CTA (csrc/fused_dp.cu MAX_W)
MAX_CLUSTER = 8  # R at most: the portable cluster size (csrc/fused_dp.cu MAX_R)
BOX_STEPS = 32  # T: diagonals a box (csrc/fused_dp.cu MAX_T)
# Largest Lp = Lx + 1 the kernel takes: a cluster of MAX_CLUSTER CTAs.
MAX_LANES_FUSED = CTA_LANES * MAX_CLUSTER
# Shared memory a CTA may use on the H100.
SMEM_PER_CTA = 232_448
_CAND_BYTES = 20  # csrc/wavefront.cuh Cand


@dataclasses.dataclass(frozen=True)
class FusedGeometry:
    """A problem's cluster: ``R`` CTAs of ``W`` lanes, boxes of ``T``
    diagonals, and each CTA's dynamic shared memory on the "mma" tier
    (``smem_bytes``) and on the "scalar" tier (``smem_scalar_bytes``)."""

    W: int
    R: int
    T: int
    smem_bytes: int
    smem_scalar_bytes: int


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(W: int, T: int, k: int, tier: str) -> int:
    """Dynamic shared memory of a CTA (``csrc/fused_dp.cu`` ``Layout``):
    the cross-warp exchange, the edge ring, the candidates and, on the
    "mma" tier, the score box, the rows' limbs and inverses and two bands."""
    nx = 6 + 2 * (1 if k == 2 else k)
    nw, cols = W // 32, W + T
    total = (_round16(2 * nw * nx * 4) + _round16(2 * T * nx * 4)
             + _round16((nw + 1) * _CAND_BYTES))
    if tier == "mma":
        total += (_round16(T * (W + 4) * 4) + 2 * W * 32 + 2 * cols * 32
                  + _round16(2 * cols * 4) + _round16(W * 4))
    return total


def fused_geometry(Lp: int, k: int) -> FusedGeometry:
    """The cluster of a problem of ``Lp`` lanes at ``k`` gap levels: the
    fewest CTAs of at most :data:`CTA_LANES` lanes, of equal width rounded
    up to a warp, and boxes of :data:`BOX_STEPS` diagonals."""
    if not 1 <= Lp <= MAX_LANES_FUSED:
        raise ValueError(f"the fused CUDA DP takes 1 <= Lp <= {MAX_LANES_FUSED}, got {Lp}")
    R = -(-Lp // CTA_LANES)
    per_cta = -(-Lp // R)
    W = -(-per_cta // 32) * 32
    T = BOX_STEPS
    return FusedGeometry(W, R, T, smem_bytes(W, T, k, "mma"), smem_bytes(W, T, k, "scalar"))


def reset_launches() -> None:
    for tier in TIERS:
        launches[tier] = 0


def padded_alphabet(A: int) -> int:
    """Row width of the kernel's ``T`` and ``Cy`` scratch: ``A`` rounded up
    to whole float4 loads."""
    return -(-A // 4) * 4


def check_series(gap_series, mode) -> int:
    """The level count of ``gap_series``; raises for a series or mode no
    CUDA DP takes."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    k = len(gap_series)
    if not 1 <= k <= MAX_LEVELS:
        raise ValueError(f"gap series must have 1 to {MAX_LEVELS} levels, got {k}")
    return k


def check_rows(cx, inv_x, cy, inv_y, s, lx, ly) -> tuple[int, int, int, int]:
    """``(B, Lx, Ly, A)`` of the in-place score source; raises unless every
    operand is a contiguous tensor of its shape and type on one device."""
    if cx.dim() != 3 or cy.dim() != 3:
        raise ValueError("cx and cy must be f32[B, L, A] tensors")
    B, Lx, A = cx.shape
    Ly = cy.shape[1]
    dev = cx.device
    shapes = (("cx", cx, (B, Lx, A), torch.float32), ("inv_x", inv_x, (B, Lx), torch.float32),
              ("cy", cy, (B, Ly, A), torch.float32), ("inv_y", inv_y, (B, Ly), torch.float32),
              ("s", s, (A, A), torch.float32), ("lx", lx, (B,), torch.int32),
              ("ly", ly, (B,), torch.int32))
    for name, t, shape, dtype in shapes:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape "
                             f"{shape} on {dev}")
    if not (B >= 1 and Lx >= 1 and Ly >= 1 and 1 <= A <= MAX_ALPHABET):
        raise ValueError(f"shape B={B} Lx={Lx} Ly={Ly} A={A} outside the kernel's range")
    return B, Lx, Ly, A


def wavefront_dp_fused_plain(cx, inv_x, cy, inv_y, s, lx, ly, gap_series=(11, 1),
                             mode="global", traceback=False):
    """The plain version: ``skewed_pair_scores`` then the plain DP."""
    hs = skewed_pair_scores(cx, inv_x, cy, inv_y, s)
    return wavefront_dp_plain(hs, lx, ly, gap_series, mode, traceback)


_clusters: dict[tuple, int] = {}


def max_active_clusters(k: int, tier: str, geometry: FusedGeometry) -> int:
    """Clusters of this geometry the card holds at once
    (``cudaOccupancyMaxActiveClusters``), asked once per shape."""
    key = (k, tier, geometry.W, geometry.R, geometry.T)
    n = _clusters.get(key)
    if n is None:
        got = ctypes.c_int(0)
        rc = build.load_library().praline_fused_dp_clusters(
            k, TIERS.index(tier), geometry.W, geometry.R, geometry.T, ctypes.byref(got))
        build.check(rc, "praline_fused_dp_clusters")
        n = _clusters[key] = got.value
    return n


_OUT_KEYS = (("score", torch.float32), ("length", torch.float32), ("ti", torch.int32),
             ("tj", torch.int32), ("tcode", torch.int32))


def wavefront_dp_fused(cx, inv_x, cy, inv_y, s, lx, ly, gap_series=(11, 1),
                       mode="global", traceback=False, *, tier: str, out=None):
    """Batched DP of profile pairs ``cx f32[B, Lx, A]``, ``inv_x f32[B, Lx]``,
    ``cy f32[B, Ly, A]``, ``inv_y f32[B, Ly]`` under ``s f32[A, A]``, with
    true lengths ``lx, ly int32[B]``.  Same outputs as
    :func:`wavefront_dp_fused_plain`.  ``tier`` is ``"mma"`` (only for
    operands ``fused_scores.tensor_core_exact`` admits) or ``"scalar"``.
    ``out``, where given, is the dict of output tensors written (``score``,
    ``length``, ``ti``, ``tj``, ``tcode`` and, with traceback, ``tb``).
    CPU tensors take the plain version on either tier; CUDA tensors launch
    the tier's kernel (or raise)."""
    if tier not in TIERS:
        raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
    if cx.device.type == "cpu":
        got = wavefront_dp_fused_plain(cx, inv_x, cy, inv_y, s, lx, ly, gap_series, mode,
                                       traceback)
        if out is None:
            return got
        _check_out(out, *cx.shape[:2], cy.shape[1], traceback, cx.device)
        for key, t in out.items():
            t.copy_(got[key])
        return out
    k = check_series(gap_series, mode)
    B, Lx, Ly, A = check_rows(cx, inv_x, cy, inv_y, s, lx, ly)
    dev = cx.device
    Lp = Lx + 1
    if Lp > MAX_LANES_FUSED:
        raise NotImplementedError(
            f"the fused CUDA DP takes Lp <= {MAX_LANES_FUSED}, "
            f"got {Lp} (longer rows take kernels/tiled_dp.py)"
        )
    geo = fused_geometry(Lp, k)
    if max_active_clusters(k, tier, geo) < 1:
        raise RuntimeError(f"the card cannot hold one cluster of {geo.R} CTAs of {geo.W} "
                           f"threads at k={k} on the {tier!r} tier")
    gaps = np.ascontiguousarray(gap_series, dtype=np.float32)
    if tier == "mma":
        scratch_bytes = mma_scratch_bytes(B, Lx, Ly)
    else:
        scratch_bytes = B * (Lx + Ly) * padded_alphabet(A) * 4
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev)
    if out is None:
        out = {key: torch.empty(B, dtype=dtype, device=dev) for key, dtype in _OUT_KEYS}
        if traceback:
            out["tb"] = torch.empty((Lx + Ly - 1, B, Lp), dtype=torch.uint8, device=dev)
    _check_out(out, B, Lx, Ly, traceback, dev)
    tb = out.get("tb")
    lib = build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.praline_fused_dp(
            cx.data_ptr(), inv_x.data_ptr(), cy.data_ptr(), inv_y.data_ptr(), s.data_ptr(),
            lx.data_ptr(), ly.data_ptr(), gaps.ctypes.data_as(ctypes.c_void_p), k,
            MODES.index(mode), int(traceback), B, Lx, Ly, A, TIERS.index(tier),
            geo.W, geo.R, geo.T, scratch.data_ptr(),
            out["score"].data_ptr(), out["length"].data_ptr(),
            out["ti"].data_ptr(), out["tj"].data_ptr(), out["tcode"].data_ptr(),
            tb.data_ptr() if traceback else None, stream,
        )
    build.check(rc, "praline_fused_dp")
    launches[tier] += 1
    return out


def _check_out(out, B, Lx, Ly, traceback, dev) -> None:
    """Raise unless ``out`` holds exactly the kernel's outputs, contiguous,
    of their shapes and types on ``dev``."""
    want = {key: ((B,), dtype) for key, dtype in _OUT_KEYS}
    if traceback:
        want["tb"] = ((Lx + Ly - 1, B, Lx + 1), torch.uint8)
    if set(out) != set(want):
        raise ValueError(f"out must hold {sorted(want)}, got {sorted(out)}")
    for key, (shape, dtype) in want.items():
        t = out[key]
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"out[{key!r}] must be a contiguous {dtype} tensor of shape "
                             f"{shape} on {dev}")
