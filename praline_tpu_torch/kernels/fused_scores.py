"""The Hopper score producer (``csrc/scores.cu``) and its wrapper.

Replaces the TPU kernels ``praline_tpu/kernels/fused_scores.py::
fused_skewed_scores`` (classic layout) and ``::fused_skewed_scores_strip``
(strip-packed layout).  The two differ only in how the TPU packs lanes; on
the card one kernel emits the per-problem layout of
``kernels/scores.py::skewed_pair_scores`` (its plain version), which the
Hopper DP reads directly.

Bound on the H100: the write of ``hs`` (``D * (Lx+1)`` f32 per problem).
The kernel computes ``T = Cx @ S`` and the skewed ``H`` tile in its own
body (registers and shared memory), so ``hs`` is the only device-memory
stream, stored one diagonal's consecutive lanes at a time.  See the source
for the tiling.
"""

from __future__ import annotations

import torch

from . import build
from .scores import skewed_pair_scores as skewed_pair_scores_plain

launches = 0  # kernel launches by fused_skewed_scores (not by the plain path)

MAX_ALPHABET = 32
MAX_BATCH = 65535  # grid z


def reset_launches() -> None:
    global launches
    launches = 0


def fused_skewed_scores(cx, inv_x, cy, inv_y, s) -> torch.Tensor:
    """``f32[D, B, Lx+1]`` skewed scores; bit-identical to
    ``skewed_pair_scores``.  CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream (or raise)."""
    if cx.device.type == "cpu":
        return skewed_pair_scores_plain(cx, inv_x, cy, inv_y, s)
    global launches
    B, Lx, A = cx.shape
    Ly = cy.shape[1]
    _check(cx, (B, Lx, A), "cx")
    _check(inv_x, (B, Lx), "inv_x")
    _check(cy, (B, Ly, A), "cy")
    _check(inv_y, (B, Ly), "inv_y")
    _check(s, (A, A), "s")
    dev = cx.device
    for t in (inv_x, cy, inv_y, s):
        if t.device != dev:
            raise ValueError("all operands must be on one device")
    if not (1 <= A <= MAX_ALPHABET and 1 <= B <= MAX_BATCH and Lx >= 1 and Ly >= 1):
        raise ValueError(f"shape B={B} Lx={Lx} Ly={Ly} A={A} outside the kernel's range")
    hs = torch.empty((Lx + Ly + 1, B, Lx + 1), dtype=torch.float32, device=dev)
    lib = build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.praline_skewed_scores(
            cx.data_ptr(), inv_x.data_ptr(), cy.data_ptr(), inv_y.data_ptr(),
            s.data_ptr(), hs.data_ptr(), B, Lx, Ly, A, stream,
        )
    build.check(rc, "praline_skewed_scores")
    launches += 1
    return hs


def _check(t, shape, name) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
