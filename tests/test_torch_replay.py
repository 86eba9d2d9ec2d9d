"""The port's traceback replay against the JAX package's, on the same bytes.

One seeded ``tb`` tensor from the JAX scan feeds both ``replay_moves``
implementations (the port's plain walk, which CPU tensors take); the move
tapes, their counts and the decoded
``AlignResult`` paths must be identical, and the paths must equal the
oracle's.  Tolerance 0.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from praline_tpu import ALPHABET_AA, Profile, builtin_score_matrix
from praline_tpu.kernels.replay import moves_to_result as jax_decode
from praline_tpu.kernels.replay import replay_moves as jax_replay
from praline_tpu.kernels.scan import wavefront_dp as jax_dp
from praline_tpu.kernels.scores import skewed_pair_scores as jax_skewed
from praline_tpu.oracle import align_profiles
from praline_tpu_torch.kernels import replay as replay_mod
from praline_tpu_torch.kernels.replay import moves_to_result, replay_moves

torch.set_num_threads(1)

B62 = builtin_score_matrix("blosum62")
A = ALPHABET_AA.size


def same_result(a, b):
    return (
        a.score == b.score and a.mode == b.mode and a.x_range == b.x_range
        and a.y_range == b.y_range and np.array_equal(a.cols_x, b.cols_x)
        and np.array_equal(a.cols_y, b.cols_y)
    )


@pytest.mark.parametrize("mode", ["global", "semiglobal", "local"])
@pytest.mark.parametrize("gap_series", [(11, 1), (13, 7, 1), (5,)])
def test_replay_matches_jax_and_oracle(mode, gap_series):
    rng = np.random.default_rng(zlib.crc32(repr((mode, gap_series)).encode()))
    B, bx, by = 8, 31, 63
    cx = np.zeros((B, bx, A), np.float32)
    cy = np.zeros((B, by, A), np.float32)
    lx = rng.integers(1, bx + 1, size=B).astype(np.int32)
    ly = rng.integers(1, by + 1, size=B).astype(np.int32)
    lx[0], ly[0] = 1, 1
    for b in range(B):  # one-hot sequences, zero-padded
        cx[b, np.arange(lx[b]), rng.integers(0, 20, lx[b])] = 1.0
        cy[b, np.arange(ly[b]), rng.integers(0, 20, ly[b])] = 1.0
    ones_x = np.ones((B, bx), np.float32)
    ones_y = np.ones((B, by), np.float32)
    hs = jax_skewed(cx, ones_x, cy, ones_y, B62.as_f32())
    out = jax_dp(hs, jnp.asarray(lx), jnp.asarray(ly), gap_series=gap_series,
                 mode=mode, traceback=True)
    tb = np.array(out["tb"])
    ti, tj, tcode = (np.array(out[k]) for k in ("ti", "tj", "tcode"))
    steps = bx + by

    want_moves, want_n = jax_replay(out["tb"], out["ti"], out["tj"], out["tcode"],
                                    gap_series=gap_series, mode=mode, steps=steps)
    before = replay_mod.launches
    moves, n = replay_moves(torch.from_numpy(tb), torch.from_numpy(ti), torch.from_numpy(tj),
                            torch.from_numpy(tcode), gap_series, mode, steps=steps)
    assert replay_mod.launches == before  # the CPU takes the plain walk
    assert np.array_equal(moves.numpy(), np.asarray(want_moves))
    assert np.array_equal(n.numpy(), np.asarray(want_n))

    score = np.asarray(out["score"])
    for b in range(B):
        args = (int(n[b]), float(score[b]), int(ti[b]), int(tj[b]), int(lx[b]), int(ly[b]), mode)
        got = moves_to_result(moves.numpy()[b], *args)
        assert same_result(got, jax_decode(np.asarray(want_moves)[b], *args))
        px = Profile(cx[b, : lx[b]], np.zeros(lx[b], np.float32), ALPHABET_AA)
        py = Profile(cy[b, : ly[b]], np.zeros(ly[b], np.float32), ALPHABET_AA)
        assert same_result(got, align_profiles(px, py, B62, gap_series, mode)), b
