"""State carried across from the JAX package's numpy containers.

The port's host data model is ``praline_tpu_torch.types`` (Profile,
ScoreMatrix, ...); these helpers turn it into the tensors the kernels take,
and build it from the plain arrays a JAX package object holds.
``profiles_to_stack`` is the counterpart of ``ProfileArena.stack``
(``praline_tpu/kernels/batch.py:914-974``) for a plain list of profiles.
"""

from __future__ import annotations

import numpy as np
import torch

from .oracle.score import column_inverses
from .types import ALPHABETS, Alphabet, Profile, ScoreMatrix, Sequence


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


def alphabet_from_letters(letters) -> Alphabet:
    """The port's alphabet whose symbols, in order, are ``letters``."""
    symbols = tuple(letters)
    for alphabet in ALPHABETS.values():
        if alphabet.symbols == symbols:
            return alphabet
    raise ValueError(f"no alphabet of the port has the symbols {''.join(symbols)!r}")


def sequence_from_arrays(name: str, tokens, letters) -> Sequence:
    """The port's ``Sequence`` of ``int32[L]`` ``tokens`` over ``letters``."""
    return Sequence(name, np.asarray(tokens, dtype=np.int32), alphabet_from_letters(letters))


def profile_from_arrays(counts, gaps, letters) -> Profile:
    """The port's ``Profile`` of ``f32[L, A]`` counts and ``f32[L]`` gap
    counts over ``letters``."""
    return Profile(np.asarray(counts, dtype=np.float32), np.asarray(gaps, dtype=np.float32),
                   alphabet_from_letters(letters))


def matrix_from_arrays(name: str, scores, letters) -> ScoreMatrix:
    """The port's ``ScoreMatrix`` of ``int32[A, A]`` ``scores`` over ``letters``."""
    return ScoreMatrix(name, np.asarray(scores, dtype=np.int32), alphabet_from_letters(letters))
