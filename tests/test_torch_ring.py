"""The port's ring-parallel single alignment (``praline_tpu_torch/dist/ring.py``)
on CPU shards, against the JAX package's ``dist.ring.ring_wavefront_dp`` on
its simulated 8-device mesh (``tests/conftest.py``).

The same numpy-seeded inputs go through both: every case of
``tests/dist/test_ring.py`` (the three modes on 2 and 8 shards at the
per-diagonal exchange and the default superstep; intervals 3, 7 and 200;
a 3-level series over a ragged batch of three) with terminals and every
traceback byte of the global ``(D - 2, B, Lp_pad)`` layout compared, and
every case of ``tests/dist/test_ring_ckpt.py`` (the modes at 2 and 3 gap
levels, 170 x 140, interval 8, ``ckpt_interval`` 48) with the move tape.
Also: one superstep (``ring_superstep_plain``) on every rank against the
plain full-row DP, and the ``ValueError``s the JAX function raises.
Tolerance 0.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from praline_tpu import builtin_score_matrix as jax_matrix
from praline_tpu.dist import make_pair_mesh as jax_mesh
from praline_tpu.dist.ring import ring_wavefront_dp as jax_ring
from praline_tpu_torch.dist import make_pair_mesh, ring_wavefront_dp
from praline_tpu_torch.dist.ring import merge_candidates
from praline_tpu_torch.kernels.scan import (
    edge_values, pack_candidate, ring_candidate, ring_carries, ring_rows,
    ring_superstep_plain, wavefront_dp,
)
from praline_tpu_torch.kernels.scores import skewed_pair_scores

torch.set_num_threads(1)

S = np.asarray(jax_matrix("blosum62").as_f32())
TERMINALS = ("score", "length", "ti", "tj", "tcode")


def problem(seed=0, B=2, Lx=45, Ly=33, A=23):
    """``tests/dist/test_ring.py::_problem``."""
    rng = np.random.default_rng(seed)
    cx = (rng.integers(0, 3, size=(B, Lx, A)) + (np.arange(A) == 0)).astype(np.float32)
    cy = (rng.integers(0, 3, size=(B, Ly, A)) + (np.arange(A) == 0)).astype(np.float32)
    ivx = (1.0 / np.maximum(cx.sum(-1), 1)).astype(np.float32)
    ivy = (1.0 / np.maximum(cy.sum(-1), 1)).astype(np.float32)
    lx = rng.integers(max(1, Lx // 2), Lx + 1, size=B).astype(np.int32)
    ly = rng.integers(max(1, Ly // 2), Ly + 1, size=B).astype(np.int32)
    return cx, ivx, cy, ivy, S, lx, ly


def ckpt_problem(mode, gs, B=1, Lx=170, Ly=140, A=23):
    """``tests/dist/test_ring_ckpt.py::_problem`` (a fixed seed a case)."""
    rng = np.random.default_rng(sum(map(ord, mode)) * 100 + len(gs))
    cx = (rng.integers(0, 3, size=(B, Lx, A)) + (np.arange(A) == 0)).astype(np.float32)
    cy = (rng.integers(0, 3, size=(B, Ly, A)) + (np.arange(A) == 0)).astype(np.float32)
    ivx = (1.0 / np.maximum(cx.sum(-1), 1)).astype(np.float32)
    ivy = (1.0 / np.maximum(cy.sum(-1), 1)).astype(np.float32)
    lx = rng.integers(max(1, Lx - 9), Lx + 1, size=B).astype(np.int32)
    ly = rng.integers(max(1, Ly - 9), Ly + 1, size=B).astype(np.int32)
    return cx, ivx, cy, ivy, S, lx, ly


def assert_same(got, want, keys):
    for key in keys:
        w, g = np.asarray(want[key]), got[key].numpy()
        assert w.shape == g.shape, (key, w.shape, g.shape)
        np.testing.assert_array_equal(g, w, err_msg=key)


@functools.lru_cache(maxsize=None)
def jax_result(case, n, kwargs):
    """The JAX ring on ``n`` simulated devices, once a module per case."""
    out = jax_ring(jax_mesh(n), *CASES[case], **dict(kwargs))
    return jax.tree.map(np.asarray, dict(out))


CASES = {"base": problem(), "odd": problem(seed=5, B=2, Lx=37, Ly=26),
         "ragged": problem(seed=3, B=3, Lx=29, Ly=41)}
CASES.update({f"ckpt:{mode}:{len(gs)}": ckpt_problem(mode, gs) for mode in
              ("global", "semiglobal", "local") for gs in ((11, 1), (13, 7, 1))})


@pytest.mark.parametrize("mode", ["global", "semiglobal", "local"])
@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("interval", [1, None])
def test_ring_matches_jax(mode, n, interval):
    kw = (("gap_series", (11, 1)), ("mode", mode), ("traceback", True), ("interval", interval))
    want = jax_result("base", n, kw)
    got = ring_wavefront_dp(make_pair_mesh(n, device="cpu"), *CASES["base"], **dict(kw))
    assert_same(got, want, TERMINALS + ("tb",))


@pytest.mark.parametrize("interval", [3, 7, 200])
def test_ring_odd_intervals_match_jax(interval):
    kw = (("gap_series", (11, 1)), ("mode", "semiglobal"), ("traceback", True),
          ("interval", interval))
    want = jax_result("odd", 4, kw)
    got = ring_wavefront_dp(make_pair_mesh(4, device="cpu"), *CASES["odd"], **dict(kw))
    assert_same(got, want, TERMINALS + ("tb",))


def test_ring_gap_series_and_ragged_match_jax():
    kw = (("gap_series", (13, 7, 1)), ("mode", "global"))
    want = jax_result("ragged", 4, kw)
    got = ring_wavefront_dp(make_pair_mesh(4, device="cpu"), *CASES["ragged"], **dict(kw))
    assert_same(got, want, TERMINALS)
    assert "tb" not in got


@pytest.mark.parametrize("mode", ["global", "semiglobal", "local"])
@pytest.mark.parametrize("gs", [(11, 1), (13, 7, 1)])
def test_ring_checkpointed_matches_jax(mode, gs):
    """Against the JAX ring on 8 devices, as its test runs it; the port on 8
    shards in the first case and on 2 in the others (its results do not
    depend on the shard count, and its plain version's time goes with the
    shards' steps)."""
    case = f"ckpt:{mode}:{len(gs)}"
    kw = (("gap_series", gs), ("mode", mode), ("traceback", True), ("interval", 8),
          ("ckpt_interval", 48))
    want = jax_result(case, 8, kw)
    n = 8 if (mode, gs) == ("global", (11, 1)) else 2
    got = ring_wavefront_dp(make_pair_mesh(n, device="cpu"), *CASES[case], **dict(kw))
    assert_same(got, want, TERMINALS + ("nmoves",))
    assert got["moves"].shape == want["moves"].shape
    n = int(want["nmoves"][0])
    np.testing.assert_array_equal(got["moves"].numpy()[0, :n], want["moves"][0, :n])
    assert not got["moves"][0, n:].any()


@pytest.mark.parametrize("mode", ["global", "semiglobal", "local"])
@pytest.mark.parametrize("gs", [(5,), (11, 1), (13, 7, 1)])
def test_superstep_on_every_rank_is_the_full_row_dp(mode, gs):
    """Three ranks walking chunks of 9 diagonals in the ring's order (rank p
    runs chunk c at superstep c + p, its heads the left rank's tails) give
    the plain full-row DP's terminals, bytes and final carries."""
    cx, ivx, cy, ivy, s, lx, ly = (torch.from_numpy(a) for a in problem(seed=11, Lx=40, Ly=30))
    D, n, K = 40 + 30 + 1, 3, 9
    want = wavefront_dp(skewed_pair_scores(cx, ivx, cy, ivy, s), lx, ly, gs, mode, True)
    Lpn = -(-41 // n)
    ranks = [ring_rows(cx, ivx, cy, ivy, s, p * Lpn, Lpn) for p in range(n)]
    carries = [ring_carries(r, gs, mode) for r in ranks]
    cands = [ring_candidate(lx, ly, gs, mode) for _ in ranks]
    heads = [torch.zeros((K, edge_values(len(gs)), 2)) for _ in ranks]
    tails = [torch.zeros_like(h) for h in heads]
    tb = [torch.zeros((D - 2, 2, Lpn), dtype=torch.uint8) for _ in ranks]
    nchunks = -(-(D - 2) // K)
    for step in range(nchunks + n - 1):
        for p in range(n):
            if 0 <= step - p < nchunks:
                ring_superstep_plain(ranks[p], lx, ly, gs, mode, True, 2 + (step - p) * K, K,
                                     carries[p], heads[p] if p else None, tails[p], cands[p],
                                     tb=tb[p])
        for p in range(1, n):
            heads[p].copy_(tails[p - 1])
    got = merge_candidates(cands, mode)
    for key in TERMINALS:
        assert torch.equal(got[key], want[key]), key
    assert torch.equal(torch.cat(tb, dim=2)[:, :, :41], want["tb"])
    # the final carries of a lane do not depend on the cut: one rank of all
    whole = ring_rows(cx, ivx, cy, ivy, s, 0, n * Lpn)
    c = ring_carries(whole, gs, mode)
    ring_superstep_plain(whole, lx, ly, gs, mode, False, 2, D - 2, c, None,
                         torch.zeros((D - 2, edge_values(len(gs)), 2)), ring_candidate(
                             lx, ly, gs, mode))
    assert torch.equal(torch.cat(carries, dim=2).view(torch.int32), c.view(torch.int32))


def test_superstep_refusals_and_candidate_packing():
    cx, ivx, cy, ivy, s, lx, ly = (torch.from_numpy(a) for a in problem())
    rows = ring_rows(cx, ivx, cy, ivy, s, 23, 23)
    c, t = ring_carries(rows, (11, 1), "global"), torch.zeros((4, 8, 2))
    cand = ring_candidate(lx, ly, (11, 1), "global")
    with pytest.raises(ValueError, match="heads"):
        ring_superstep_plain(rows, lx, ly, (11, 1), "global", False, 2, 4, c, None, t, cand)
    with pytest.raises(ValueError, match="outside"):
        ring_superstep_plain(rows, lx, ly, (11, 1), "global", False, 79, 4, c, t, t, cand)
    term = {"score": torch.tensor([-1.5, 2.0]), "length": torch.tensor([3.0, 4.0]),
            "ti": torch.tensor([5, -6], dtype=torch.int32),
            "tj": torch.tensor([7, 8], dtype=torch.int32),
            "tcode": torch.tensor([31, 0], dtype=torch.int32)}
    packed = pack_candidate(term)
    assert packed.shape == (5, 2) and packed.dtype == torch.float32
    assert all(torch.equal(v, term[k]) for k, v in merge_candidates([packed], "local").items())


@pytest.mark.parametrize("local", [False, True])
def test_merge_is_lexicographic(local):
    """Equal scores: the larger (i, j) wins outside local mode, the smaller
    in it; the winner's length and code ride along."""
    def cand(score, i, j, ln, code):
        return pack_candidate({"score": torch.tensor([score]), "length": torch.tensor([ln]),
                               "ti": torch.tensor([i], dtype=torch.int32),
                               "tj": torch.tensor([j], dtype=torch.int32),
                               "tcode": torch.tensor([code], dtype=torch.int32)})

    cands = [cand(5.0, 3, 9, 1.0, 1), cand(5.0, 4, 2, 2.0, 2), cand(5.0, 4, 1, 3.0, 3),
             cand(4.0, 9, 9, 4.0, 4)]
    got = merge_candidates(cands, "local" if local else "global")
    want = (3, 9, 1.0, 1) if local else (4, 2, 2.0, 2)
    assert (int(got["ti"][0]), int(got["tj"][0]), float(got["length"][0]),
            int(got["tcode"][0])) == want


def test_ring_raises_as_the_jax_function_does():
    args = CASES["base"]
    mesh = make_pair_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="15 levels"):
        ring_wavefront_dp(mesh, *args, gap_series=tuple(range(16, 0, -1)))
    with pytest.raises(ValueError, match="interval > 1"):
        ring_wavefront_dp(mesh, *args, traceback=True, interval=1, ckpt_interval=48)
    with pytest.raises(ValueError, match="traceback=True"):
        ring_wavefront_dp(mesh, *args, interval=8, ckpt_interval=48)
    with pytest.raises(ValueError, match="unknown mode"):
        ring_wavefront_dp(mesh, *args, mode="overlap")
    # Lx + Ly >= 2**24 on the superstepped exchange: refused before any work
    huge = (np.zeros((1, 1 << 23, 1), np.float32), np.ones((1, 1 << 23), np.float32),
            np.zeros((1, 1 << 23, 1), np.float32), np.ones((1, 1 << 23), np.float32),
            np.zeros((1, 1), np.float32), np.array([1], np.int32), np.array([1], np.int32))
    with pytest.raises(ValueError, match="2\\^24"):
        ring_wavefront_dp(mesh, *huge, interval=8)
    for fn in (lambda: jax_ring(jax_mesh(2), *args, traceback=True, interval=1,
                                ckpt_interval=48),
               lambda: jax_ring(jax_mesh(2), *args, interval=8, ckpt_interval=48)):
        with pytest.raises(ValueError, match="interval > 1"):
            fn()
