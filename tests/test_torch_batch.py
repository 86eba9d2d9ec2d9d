"""The port's batched aligner against the JAX package's (``backend="xla"``).

Ragged profile pairs over mixed buckets, empty sequences included, go
through both ``align_pairs_batched`` implementations in scores and
traceback mode; every result must be identical.  Tolerance 0.  The port
gets its own ``Profile`` and ``ScoreMatrix``, built from the arrays the
JAX objects hold.
"""

import numpy as np
import pytest
import torch

from praline_tpu import ALPHABET_AA, Profile, builtin_score_matrix
from praline_tpu.kernels.batch import align_pairs_batched as jax_batched
from praline_tpu.oracle import align_profiles
from praline_tpu_torch.convert import matrix_from_arrays, profile_from_arrays
from praline_tpu_torch.kernels import batch
from praline_tpu_torch.kernels.batch import ProfileArena, align_pairs_batched

torch.set_num_threads(1)

B62 = builtin_score_matrix("blosum62")
PORT_B62 = matrix_from_arrays(B62.name, B62.scores, B62.alphabet.symbols)
A = ALPHABET_AA.size
BUCKETS = (31, 63)


def profiles(seed, n=10):
    """One-hot sequences and integer-count profiles of ragged lengths,
    two of them empty."""
    rng = np.random.default_rng(seed)
    out = []
    for k, L in enumerate(rng.integers(1, 60, size=n)):
        L = 0 if k in (3, 7) else int(L)
        if k % 2:
            c = np.zeros((L, A), np.float32)
            c[np.arange(L), rng.integers(0, 20, L)] = 1.0
        else:
            c = rng.integers(0, 3, size=(L, A)).astype(np.float32)
            c[:, 0] += 1
        out.append(Profile(c, np.zeros(L, np.float32), ALPHABET_AA))
    return out


def pair_list(profs):
    n = len(profs)
    return [(profs[i], profs[j]) for i in range(n) for j in range(n) if (i * 7 + j) % 3 == 0]


def port_profiles(profs):
    """The port's copies of JAX ``Profile``s, from their arrays."""
    return [profile_from_arrays(p.counts, p.gaps, p.alphabet.symbols) for p in profs]


def same(a, b, traceback):
    if not traceback:
        return (a.score, a.length, a.ti, a.tj) == (b.score, b.length, b.ti, b.tj)
    return (
        a.score == b.score and a.x_range == b.x_range and a.y_range == b.y_range
        and np.array_equal(a.cols_x, b.cols_x) and np.array_equal(a.cols_y, b.cols_y)
    )


@pytest.mark.parametrize("mode", ["global", "semiglobal", "local"])
@pytest.mark.parametrize("traceback", [False, True])
def test_batched_matches_jax_xla(mode, traceback):
    profs = profiles(1 + len(mode))
    pairs = pair_list(profs)
    gap_series = (11, 1) if mode != "local" else (13, 7, 1)
    kw = dict(traceback=traceback, bucket_sizes=BUCKETS, batch_pairs=8)
    want = jax_batched(pairs, B62, gap_series, mode, backend="xla", **kw)
    got = align_pairs_batched(pair_list(port_profiles(profs)), PORT_B62, gap_series, mode,
                              device="cpu", **kw)
    assert len(got) == len(want) == len(pairs)
    for k, (g, w) in enumerate(zip(got, want)):
        assert same(g, w, traceback), k
    if traceback:  # and the paths are the oracle's
        for (px, py), g in zip(pairs, got):
            assert same(g, align_profiles(px, py, B62, gap_series, mode), True)


def test_shared_arena_across_calls():
    profs = port_profiles(profiles(9))
    arena = ProfileArena(A, BUCKETS, "cpu")
    pairs = pair_list(profs)
    first = align_pairs_batched(pairs[:5], PORT_B62, (11, 1), "global", device="cpu",
                                bucket_sizes=BUCKETS, arena=arena)
    second = align_pairs_batched(pairs, PORT_B62, (11, 1), "global", device="cpu",
                                 bucket_sizes=BUCKETS, arena=arena)
    assert first == second[:5]
    with pytest.raises(ValueError):
        align_pairs_batched(pairs, PORT_B62, (11, 1), "global", device="cpu",
                            bucket_sizes=(127,), arena=arena)


def test_exactness_gate_raises_like_the_oracle():
    big = np.zeros((5, A), np.float32)
    big[:, 0] = 2000.0
    p = profile_from_arrays(big, np.zeros(5, np.float32), ALPHABET_AA.symbols)
    with pytest.raises(ValueError, match="exact f32"):
        align_pairs_batched([(p, p)], PORT_B62, (11, 1), "global", device="cpu")


def test_unported_routes_raise(monkeypatch):
    """Meshes are not ported; a traceback past its byte budget is no longer
    refused (it runs checkpointed, ``test_torch_long_routes.py``), nor an
    hs tensor past its budget: it takes the fused route, with the same
    results."""
    profs = port_profiles(profiles(2))
    pairs = [(profs[0], profs[1])]
    with pytest.raises(NotImplementedError):
        align_pairs_batched(pairs, PORT_B62, (11, 1), "global", device="cpu", mesh=object())
    assert batch.choose_route("cuda", 5000, batch.TB_BYTES_BUDGET // 5000, True) == \
        "checkpointed"
    want = align_pairs_batched(pairs, PORT_B62, (11, 1), "global", device="cpu")
    monkeypatch.setattr(batch, "HS_BYTES_BUDGET", 1024)
    batch.reset_route_counts()
    got = align_pairs_batched(pairs, PORT_B62, (11, 1), "global", device="cpu")
    assert batch.route_counts == {"fused": 1, "two_kernel": 0, "tiled": 0}
    assert got == want
