"""The Hopper wavefront DP (``csrc/wavefront_dp.cu``) and its wrapper.

Replaces the TPU kernels ``praline_tpu/kernels/strip.py::
wavefront_dp_strip`` and ``praline_tpu/kernels/pallas_dp.py::
wavefront_dp_pallas``: both run the M/Ix/Iy anti-diagonal recurrence, and
differ only in the TPU's lane packing.  The contract here is that of the
plain version, ``kernels/scan.py::wavefront_dp``, bit for bit: scores,
lengths, terminal cells and state codes, and the traceback bytes
``tb uint8[D-2, B, Lp]``.

Bound on the H100: the sequential chain of diagonals inside one problem
(one block barrier and about a hundred dependent instructions per
diagonal); throughput comes from one block per problem with many problems
in flight.  See the source for the lane ownership and the exchange.

Taken on the card: every mode, gap series of 1 to 15 levels, buckets up
to 2047 (``Lp <= 2048``).  Anything else raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .scan import MODES
from .scan import wavefront_dp as wavefront_dp_plain

launches = 0  # kernel launches by wavefront_dp (not by the plain path)

MAX_LEVELS = 15
MAX_LANES = 2048


def reset_launches() -> None:
    global launches
    launches = 0


def wavefront_dp(hs, lx, ly, gap_series=(11, 1), mode="global", traceback=False):
    """Batched DP over skewed scores ``hs f32[D, B, Lp]`` with per-problem
    lengths ``lx, ly int32[B]`` (``1 <= lx < Lp``, ``1 <= ly <= D - Lp``).
    Same outputs as ``kernels.scan.wavefront_dp``.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (or raise)."""
    if hs.device.type == "cpu":
        return wavefront_dp_plain(hs, lx, ly, gap_series, mode, traceback)
    global launches
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    k = len(gap_series)
    if not 1 <= k <= MAX_LEVELS:
        raise ValueError(f"gap series must have 1 to {MAX_LEVELS} levels, got {k}")
    if hs.dtype != torch.float32 or hs.dim() != 3 or not hs.is_contiguous():
        raise ValueError("hs must be a contiguous f32[D, B, Lp] tensor")
    D, B, Lp = hs.shape
    if Lp > MAX_LANES:
        raise NotImplementedError(
            f"the CUDA DP takes Lp <= {MAX_LANES} (bucket 2047), got {Lp} "
            "(long-length routes: ROADMAP.md, port queue)"
        )
    if Lp < 2 or D < Lp + 1 or B < 1:
        raise ValueError(f"bad hs shape {tuple(hs.shape)}")
    dev = hs.device
    for name, t in (("lx", lx), ("ly", ly)):
        if t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != (B,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32[{B}] tensor on {dev}")
    gaps = np.ascontiguousarray(gap_series, dtype=np.float32)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = {
        "score": torch.empty(B, **f32),
        "length": torch.empty(B, **f32),
        "ti": torch.empty(B, **i32),
        "tj": torch.empty(B, **i32),
        "tcode": torch.empty(B, **i32),
    }
    tb = torch.empty((D - 2, B, Lp), dtype=torch.uint8, device=dev) if traceback else None
    lib = build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.praline_wavefront_dp(
            hs.data_ptr(), lx.data_ptr(), ly.data_ptr(),
            gaps.ctypes.data_as(ctypes.c_void_p), k, MODES.index(mode),
            int(traceback), D, B, Lp,
            out["score"].data_ptr(), out["length"].data_ptr(),
            out["ti"].data_ptr(), out["tj"].data_ptr(), out["tcode"].data_ptr(),
            tb.data_ptr() if traceback else None, stream,
        )
    build.check(rc, "praline_wavefront_dp")
    launches += 1
    if traceback:
        out["tb"] = tb
    return out
