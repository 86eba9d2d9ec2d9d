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

Bound on the H100: the chain of dependent diagonals, as the two-kernel DP,
plus the per-cell dot products, read from L1/L2-resident ``T = Cx @ S``
and ``Cy`` rows.  No ``hs`` tensor, so memory is ``O(B * (Lx + Ly) * A)``
and ``Ly`` is unbounded; lanes are bounded by threads x lanes per thread:
:data:`MAX_LANES_FUSED`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .scan import MODES
from .scan import wavefront_dp as wavefront_dp_plain
from .scores import skewed_pair_scores

launches = 0  # kernel launches by wavefront_dp_fused (not by the plain path)

MAX_LEVELS = 15
MAX_ALPHABET = 32
THREADS = 1024  # threads per block (csrc/wavefront.cuh MAXT)
LANES_PER_THREAD = 4  # csrc/fused_dp.cu kMaxQ
# Largest Lp = Lx + 1 the kernel takes: one block of THREADS threads with
# LANES_PER_THREAD lanes each, for every series and mode (the deepest
# series' exchange buffer fits the static shared memory, see _XBUF_BYTES).
MAX_LANES_FUSED = THREADS * LANES_PER_THREAD
# Static shared memory of the largest instantiation (k = 15 levels, four
# lanes a thread): two buffers x lanes x 32 warps x (6 + 2 * 15) floats,
# plus the 32 terminal candidates; it has to stay under the 48 KB a block
# may declare statically.
_XBUF_BYTES = 2 * LANES_PER_THREAD * (THREADS // 32) * (6 + 2 * MAX_LEVELS) * 4 + 32 * 20
assert _XBUF_BYTES <= 48 * 1024


def reset_launches() -> None:
    global launches
    launches = 0


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


def wavefront_dp_fused(cx, inv_x, cy, inv_y, s, lx, ly, gap_series=(11, 1),
                       mode="global", traceback=False):
    """Batched DP of profile pairs ``cx f32[B, Lx, A]``, ``inv_x f32[B, Lx]``,
    ``cy f32[B, Ly, A]``, ``inv_y f32[B, Ly]`` under ``s f32[A, A]``, with
    true lengths ``lx, ly int32[B]``.  Same outputs as
    :func:`wavefront_dp_fused_plain`.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise)."""
    if cx.device.type == "cpu":
        return wavefront_dp_fused_plain(cx, inv_x, cy, inv_y, s, lx, ly, gap_series,
                                        mode, traceback)
    global launches
    k = check_series(gap_series, mode)
    B, Lx, Ly, A = check_rows(cx, inv_x, cy, inv_y, s, lx, ly)
    dev = cx.device
    Lp = Lx + 1
    if Lp > MAX_LANES_FUSED:
        raise NotImplementedError(
            f"the fused CUDA DP takes Lp <= {MAX_LANES_FUSED}, "
            f"got {Lp} (longer rows take kernels/tiled_dp.py)"
        )
    gaps = np.ascontiguousarray(gap_series, dtype=np.float32)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    AP = padded_alphabet(A)
    t_rows = torch.empty((B, Lx, AP), **f32)
    cy_rows = torch.empty((B, Ly, AP), **f32)
    out = {
        "score": torch.empty(B, **f32),
        "length": torch.empty(B, **f32),
        "ti": torch.empty(B, **i32),
        "tj": torch.empty(B, **i32),
        "tcode": torch.empty(B, **i32),
    }
    tb = torch.empty((Lx + Ly - 1, B, Lp), dtype=torch.uint8, device=dev) if traceback else None
    lib = build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.praline_fused_dp(
            cx.data_ptr(), inv_x.data_ptr(), cy.data_ptr(), inv_y.data_ptr(), s.data_ptr(),
            lx.data_ptr(), ly.data_ptr(), gaps.ctypes.data_as(ctypes.c_void_p), k,
            MODES.index(mode), int(traceback), B, Lx, Ly, A,
            t_rows.data_ptr(), cy_rows.data_ptr(),
            out["score"].data_ptr(), out["length"].data_ptr(),
            out["ti"].data_ptr(), out["tj"].data_ptr(), out["tcode"].data_ptr(),
            tb.data_ptr() if traceback else None, stream,
        )
    build.check(rc, "praline_fused_dp")
    launches += 1
    if traceback:
        out["tb"] = tb
    return out
