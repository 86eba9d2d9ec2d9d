"""The port's score producer against the JAX package's, bit for bit.

Seeded numpy operands go through the plain PyTorch producer and through
``praline_tpu.kernels.scores.skewed_pair_scores``, the Pallas producers
``fused_skewed_scores`` / ``fused_skewed_scores_strip`` (interpret mode, as
the JAX package's own tests run them on the CPU) and the oracle's
``pair_score_matrix``.  Tolerance 0: the contract is exact integer scoring
with a pinned multiply order.  The CUDA kernel is held against the plain
version in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from praline_tpu import ALPHABET_AA, Profile, builtin_score_matrix
from praline_tpu.kernels.fused_scores import fused_skewed_scores as jax_fused
from praline_tpu.kernels.fused_scores import fused_skewed_scores_strip as jax_strip
from praline_tpu.kernels.scores import skewed_pair_scores as jax_skewed
from praline_tpu.kernels.strip import strip_stride
from praline_tpu.oracle import pair_score_matrix
from praline_tpu.oracle.score import EXACT_DOT_LIMIT
from praline_tpu_torch.convert import operands_from_numpy
from praline_tpu_torch.kernels import fused_scores
from praline_tpu_torch.kernels.scores import skewed_pair_scores

torch.set_num_threads(1)

B62 = builtin_score_matrix("blosum62")
A = ALPHABET_AA.size


def make_operands(rng, B, bx, by, hi=3, frac=False, totals=None):
    """Ragged count profiles padded to (bx, by) buckets, as the stacks pad
    them (zero counts, inverse 1.0 past each length)."""
    lx = rng.integers(1, bx + 1, size=B).astype(np.int32)
    ly = rng.integers(1, by + 1, size=B).astype(np.int32)
    side = []
    for L, lens, tot in ((bx, lx, totals and totals[0]), (by, ly, totals and totals[1])):
        c = rng.integers(0, hi, size=(B, L, A)).astype(np.float32)
        if frac:  # dyadic fractions stay exactly representable
            c = c * np.float32(0.25)
        c[:, :, 0] += 1
        if tot is not None:  # every column total exactly `tot`
            c[:, :, 0] += tot - c.sum(axis=2)
        for b in range(B):
            c[b, lens[b]:] = 0.0
        inv = np.ones((B, L), np.float32)
        live = c.sum(axis=2) > 0
        inv[live] = np.float32(1.0) / c.sum(axis=2, dtype=np.float32)[live]
        side += [c, inv]
    return side[0], side[1], side[2], side[3], lx, ly


def port_hs(cx, inv_x, cy, inv_y, s=B62.as_f32()):
    ops = operands_from_numpy(cx, inv_x, cy, inv_y, s, [1], [1], "cpu")
    return skewed_pair_scores(*ops[:5]).numpy()


@pytest.mark.parametrize("bx,by", [(31, 63), (63, 31), (31, 31)])
def test_plain_matches_jax_skewed(bx, by):
    rng = np.random.default_rng(bx * 100 + by)
    cx, ivx, cy, ivy, _, _ = make_operands(rng, 8, bx, by)
    want = np.asarray(jax_skewed(cx, ivx, cy, ivy, B62.as_f32()))
    got = port_hs(cx, ivx, cy, ivy)
    assert got.shape == want.shape == (bx + by + 1, 8, bx + 1)
    assert np.array_equal(got, want)


def test_plain_matches_pallas_classic_producer():
    """K3 (interpret mode): row t of the body layout is diagonal t + 2."""
    rng = np.random.default_rng(3)
    cx, ivx, cy, ivy, _, _ = make_operands(rng, 4, 31, 63)
    got = port_hs(cx, ivx, cy, ivy)
    body = np.asarray(jax_fused(cx, ivx, cy, ivy, B62.as_f32(), interpret=True))
    D, _, Lp = got.shape
    assert np.array_equal(got[2:], body[: D - 2, :, :Lp])


def test_plain_matches_pallas_strip_producer():
    """K1 (interpret mode): strip row r*K + d, slot p // R holds problem p's
    diagonal d; lanes outside the problem may hold a neighbour's values, so
    interior cells are compared."""
    rng = np.random.default_rng(4)
    B, bx, by, R = 8, 31, 31, 4
    K = strip_stride(bx, by)
    cx, ivx, cy, ivy, _, _ = make_operands(rng, B, bx, by)
    got = port_hs(cx, ivx, cy, ivy)
    strip = np.asarray(jax_strip(cx, ivx, cy, ivy, B62.as_f32(), K=K, R=R, interpret=True))
    i = np.arange(bx + 1)
    for p in range(B):
        slot, r = divmod(p, R)
        for d in range(2, bx + by + 1):
            interior = (i >= 1) & (d - i >= 1) & (d - i <= by)
            assert np.array_equal(
                strip[r * K + d, slot, : bx + 1][interior], got[d, p][interior]
            ), (p, d)


@pytest.mark.parametrize("case", ["integer", "fractional", "at_2^24_bound"])
def test_plain_matches_oracle_pair_scores(case):
    rng = np.random.default_rng(5)
    if case == "at_2^24_bound":
        # column totals 1200 x 1270 x max|S| 11 sits just under 2**24
        tot = (1200.0, 1270.0)
        assert tot[0] * tot[1] * np.abs(B62.scores).max() < EXACT_DOT_LIMIT
        ops = make_operands(rng, 4, 31, 63, hi=20, totals=tot)
    else:
        ops = make_operands(rng, 4, 31, 63, frac=case == "fractional")
    cx, ivx, cy, ivy, lx, ly = ops
    got = port_hs(cx, ivx, cy, ivy)
    want_jax = np.asarray(jax_skewed(cx, ivx, cy, ivy, B62.as_f32()))
    assert np.array_equal(got, want_jax)
    for b in range(4):
        px = Profile(cx[b, : lx[b]], np.zeros(lx[b], np.float32), ALPHABET_AA)
        py = Profile(cy[b, : ly[b]], np.zeros(ly[b], np.float32), ALPHABET_AA)
        h = pair_score_matrix(px, py, B62)
        i, j = np.meshgrid(np.arange(1, lx[b] + 1), np.arange(ly[b]), indexing="ij")
        assert np.array_equal(got[i + j + 1, b, i], h)


def test_wrapper_takes_plain_path_on_cpu():
    rng = np.random.default_rng(6)
    cx, ivx, cy, ivy, _, _ = make_operands(rng, 2, 31, 31)
    ops = operands_from_numpy(cx, ivx, cy, ivy, B62.as_f32(), [1], [1], "cpu")
    before = fused_scores.launches
    got = fused_scores.fused_skewed_scores(*ops[:5])
    assert fused_scores.launches == before  # no kernel launch on the CPU
    assert torch.equal(got, skewed_pair_scores(*ops[:5]))

