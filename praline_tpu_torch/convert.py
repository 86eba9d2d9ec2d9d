"""State carried across from the JAX package's numpy containers.

The port reuses ``praline_tpu.types`` (Profile, ScoreMatrix, ...) as its
host data model; these helpers turn them into the tensors the kernels take.
``profiles_to_stack`` is the counterpart of ``ProfileArena.stack``
(``praline_tpu/kernels/batch.py:914-974``) for a plain list of profiles.
"""

from __future__ import annotations

import numpy as np
import torch

from praline_tpu.oracle.score import column_inverses
from praline_tpu.types import Profile, ScoreMatrix


def matrix_to_torch(matrix: ScoreMatrix, device) -> torch.Tensor:
    """``f32[A, A]`` substitution matrix on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(matrix.as_f32())).to(device)


def profiles_to_stack(profiles: list[Profile], bucket: int, device):
    """Padded stacks of a list of profiles, all no longer than ``bucket``.

    Returns ``(counts f32[B, bucket, A], inv f32[B, bucket], lens int32[B])``;
    padded rows hold zero counts and inverse 1.0, exactly as the JAX
    package pads them.
    """
    if not profiles:
        raise ValueError("no profiles")
    A = profiles[0].counts.shape[1]
    B = len(profiles)
    counts = np.zeros((B, bucket, A), dtype=np.float32)
    inv = np.ones((B, bucket), dtype=np.float32)
    lens = np.zeros(B, dtype=np.int32)
    for b, p in enumerate(profiles):
        if p.length > bucket:
            raise ValueError(f"profile of length {p.length} exceeds bucket {bucket}")
        counts[b, : p.length] = p.counts
        inv[b, : p.length] = column_inverses(p)
        lens[b] = p.length
    return (
        torch.from_numpy(counts).to(device),
        torch.from_numpy(inv).to(device),
        torch.from_numpy(lens).to(device),
    )


def operands_from_numpy(cx, inv_x, cy, inv_y, s, lx, ly, device):
    """One set of numpy operands as contiguous tensors on ``device``:
    f32 counts, inverses and matrix; int32 lengths."""
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
    return f32(cx), f32(inv_x), f32(cy), f32(inv_y), f32(s), i32(lx), i32(ly)
