"""The Hopper kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (a CUDA kernel has no CPU mode) and
skips without one.  The file imports no JAX, so it also runs on a machine
that has only PyTorch: there the repository's ``tests/conftest.py`` (which
pins JAX to the CPU) must be left out::

    python -m pytest --noconftest -p no:cacheprovider -m requires_cuda tests/test_torch_cuda.py

Tolerance 0: producer, DP, walk and batched aligner are bit-exact by contract.
"""

import zlib

import numpy as np
import pytest
import torch

from praline_tpu import ALPHABET_AA, Profile, builtin_score_matrix
from praline_tpu_torch.convert import operands_from_numpy
from praline_tpu_torch.kernels import batch, fused_scores, replay, wavefront
from praline_tpu_torch.kernels.scan import wavefront_dp as plain_dp
from praline_tpu_torch.kernels.scores import skewed_pair_scores as plain_scores

pytestmark = pytest.mark.requires_cuda

B62 = builtin_score_matrix("blosum62")
A = ALPHABET_AA.size
MODES = ["global", "semiglobal", "local"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def operands(seed, B, bx, by, device):
    rng = np.random.default_rng(seed)
    lx = rng.integers(1, bx + 1, size=B).astype(np.int32)
    ly = rng.integers(1, by + 1, size=B).astype(np.int32)
    side = []
    for L, lens in ((bx, lx), (by, ly)):
        c = rng.integers(0, 2, size=(B, L, A)).astype(np.float32)
        c[:, :, 0] += 1
        for b in range(B):
            c[b, lens[b]:] = 0.0
        inv = np.ones((B, L), np.float32)
        live = c.sum(axis=2) > 0
        inv[live] = np.float32(1.0) / c.sum(axis=2, dtype=np.float32)[live]
        side += [c, inv]
    return operands_from_numpy(*side, B62.as_f32(), lx, ly, device)


@pytest.mark.parametrize("bx,by", [(31, 63), (200, 100), (1023, 1023)])
def test_producer_matches_plain(cuda, bx, by):
    cx, ivx, cy, ivy, s, _, _ = operands(bx + by, 16, bx, by, cuda)
    before = fused_scores.launches
    got = fused_scores.fused_skewed_scores(cx, ivx, cy, ivy, s)
    torch.cuda.synchronize()
    assert fused_scores.launches == before + 1
    assert torch.equal(got, plain_scores(cx, ivx, cy, ivy, s))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gap_series", [(11, 1), (13, 7, 1), (5,), (4, 3, 2, 1), (9, 7, 5, 3, 2, 1)])
@pytest.mark.parametrize("traceback", [False, True])
def test_dp_matches_plain(cuda, mode, gap_series, traceback):
    seed = zlib.crc32(repr((mode, gap_series)).encode())
    cx, ivx, cy, ivy, s, lx, ly = operands(seed, 8, 31, 63, cuda)
    hs = plain_scores(cx, ivx, cy, ivy, s)
    before = wavefront.launches
    got = wavefront.wavefront_dp(hs, lx, ly, gap_series, mode, traceback)
    torch.cuda.synchronize()
    assert wavefront.launches == before + 1
    want = plain_dp(hs, lx, ly, gap_series, mode, traceback)
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gap_series", [(11, 1), (13, 7, 1), (5,)])
def test_walk_matches_plain(cuda, mode, gap_series):
    seed = zlib.crc32(repr(("walk", mode, gap_series)).encode())
    cx, ivx, cy, ivy, s, lx, ly = operands(seed, 8, 31, 63, cuda)
    out = plain_dp(plain_scores(cx, ivx, cy, ivy, s), lx, ly, gap_series, mode, True)
    args = (out["tb"], out["ti"], out["tj"], out["tcode"], gap_series, mode, 31 + 63)
    before = replay.launches
    moves, n = replay.replay_moves(*args)
    torch.cuda.synchronize()
    assert replay.launches == before + 1
    want_moves, want_n = replay.replay_moves_plain(*args)
    assert torch.equal(moves, want_moves) and torch.equal(n, want_n)


@pytest.mark.parametrize("bx,by", [(200, 100), (1100, 700)])
@pytest.mark.parametrize("mode", ["global", "local"])
def test_dp_lane_counts_off_the_warp_grid(cuda, bx, by, mode):
    """Lp not a multiple of 32 (idle tail lanes), with one and two lanes
    per thread."""
    cx, ivx, cy, ivy, s, lx, ly = operands(bx * 7 + by, 3, bx, by, cuda)
    hs = plain_scores(cx, ivx, cy, ivy, s)
    for traceback in (False, True):
        got = wavefront.wavefront_dp(hs, lx, ly, (13, 7, 1), mode, traceback)
        want = plain_dp(hs, lx, ly, (13, 7, 1), mode, traceback)
        for key in want:
            assert torch.equal(got[key], want[key]), key


def test_dp_two_lanes_per_thread(cuda):
    """Bucket 2047: Lp = 2048 lanes on 1024 threads."""
    cx, ivx, cy, ivy, s, lx, ly = operands(11, 2, 2047, 300, cuda)
    hs = plain_scores(cx, ivx, cy, ivy, s)
    for traceback in (False, True):
        got = wavefront.wavefront_dp(hs, lx, ly, (11, 1), "global", traceback)
        want = plain_dp(hs, lx, ly, (11, 1), "global", traceback)
        for key in want:
            assert torch.equal(got[key], want[key]), key


def test_dp_refuses_what_it_does_not_take(cuda):
    """Buckets past 2047 need the long-length routes, not ported yet."""
    cx, ivx, cy, ivy, s, lx, ly = operands(12, 1, 2048, 31, cuda)
    hs = plain_scores(cx, ivx, cy, ivy, s)
    with pytest.raises(NotImplementedError):
        wavefront.wavefront_dp(hs, lx, ly, (11, 1), "global")


@pytest.mark.parametrize("traceback", [False, True])
def test_batched_aligner_cuda_equals_cpu(cuda, traceback):
    rng = np.random.default_rng(13)
    profs = []
    for L in rng.integers(0, 120, size=12):
        c = rng.integers(0, 2, size=(int(L), A)).astype(np.float32)
        c[:, 0] += 1
        profs.append(Profile(c, np.zeros(int(L), np.float32), ALPHABET_AA))
    pairs = [(profs[i], profs[(i * 5 + 1) % 12]) for i in range(12)]
    kw = dict(traceback=traceback, bucket_sizes=(63, 127))
    got = batch.align_pairs_batched(pairs, B62, (11, 1), "global", device=cuda, **kw)
    want = batch.align_pairs_batched(pairs, B62, (11, 1), "global", device="cpu", **kw)
    for g, w in zip(got, want):
        if traceback:
            assert g.score == w.score
            assert np.array_equal(g.cols_x, w.cols_x) and np.array_equal(g.cols_y, w.cols_y)
        else:
            assert g == w
