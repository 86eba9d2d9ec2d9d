"""The port's multi-track composites on the CPU (mirrors
``tests/oracle/test_multitrack.py``).

``praline_tpu_torch.kernels.align_tracksets_batched`` runs on CPU tensors
through the plain versions of its kernels.  It is held bit for bit against
the JAX package's ``align_tracksets_batched`` and its
``oracle.align_tracksets`` on the same numpy-built profiles, which cross
over through ``praline_tpu_torch.convert``: scores, lengths, terminal cells
and traceback columns.  Cases: three modes x scores and traceback, the
series (13, 7, 1), empty sides, a BLOSUM62 + ``dna_simple`` track pair, a
zero-weight track, the validation and exactness errors, tracksets that
share a track, and the route past the lane cap (``wavefront.MAX_LANES``
lowered to 64, the tiled DP taken).  The plain composite
``kernels/scores.py::composite_skewed_scores`` is held against the JAX
package's.  Tolerance 0.
"""

import numpy as np
import pytest
import torch

from praline_tpu import ALPHABET_AA as JAX_AA
from praline_tpu import ALPHABET_DNA as JAX_DNA
from praline_tpu import builtin_score_matrix as jax_matrix
from praline_tpu.kernels import align_tracksets_batched as jax_tracksets
from praline_tpu.kernels.scores import composite_skewed_scores as jax_composite
from praline_tpu.oracle import align_tracksets as jax_oracle
from praline_tpu.types import Profile as JaxProfile
from praline_tpu_torch import builtin_score_matrix
from praline_tpu_torch.convert import profile_from_arrays
from praline_tpu_torch.dist import make_pair_mesh
from praline_tpu_torch.kernels import batch, tiled_dp, wavefront
from praline_tpu_torch.kernels.scores import composite_skewed_scores

torch.set_num_threads(1)

MODES = ["global", "semiglobal", "local"]


def jax_prof(rng, L, alphabet=JAX_AA):
    hi = min(20, alphabet.size - 1)
    return JaxProfile.from_tokens(rng.integers(0, hi, size=L).astype(np.int32), alphabet)


def to_port(pairs):
    """The same tracksets as the port's profiles (one port object per JAX
    object, so shared tracks stay shared)."""
    seen = {}

    def conv(p):
        if id(p) not in seen:
            seen[id(p)] = profile_from_arrays(p.counts, p.gaps, "".join(p.alphabet.symbols))
        return seen[id(p)]

    return [(tuple(map(conv, tx)), tuple(map(conv, ty))) for tx, ty in pairs]


def ragged_pairs(seed, n, lo, hi, alphabets=(JAX_AA, JAX_AA)):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        Lx, Ly = int(rng.integers(lo, hi + 1)), int(rng.integers(lo, hi + 1))
        pairs.append((tuple(jax_prof(rng, Lx, a) for a in alphabets),
                      tuple(jax_prof(rng, Ly, a) for a in alphabets)))
    return pairs


def check(pairs, names, w, gaps, mode, traceback, *, batched=True, **kw):
    """Port == JAX batched (where ``batched``) == JAX oracle, pair by pair."""
    jm = [jax_matrix(n) for n in names]
    got = batch.align_tracksets_batched(to_port(pairs), [builtin_score_matrix(n) for n in names],
                                        w, gaps, mode, device="cpu", traceback=traceback, **kw)
    ref = jax_tracksets(pairs, jm, w, gaps, mode, traceback=traceback, **kw) if batched else None
    for k, ((tx, ty), r) in enumerate(zip(pairs, got)):
        want = jax_oracle(list(tx), list(ty), jm, w, gaps, mode)
        assert r.score == want.score, (k, mode, traceback)
        if traceback:
            np.testing.assert_array_equal(r.cols_x, want.cols_x)
            np.testing.assert_array_equal(r.cols_y, want.cols_y)
        else:
            assert r.length == want.length
        if ref is not None:
            j = ref[k]
            if traceback:
                assert r.score == j.score
                np.testing.assert_array_equal(r.cols_x, j.cols_x)
                np.testing.assert_array_equal(r.cols_y, j.cols_y)
            else:
                assert (r.score, r.length, r.ti, r.tj) == (j.score, j.length, j.ti, j.tj)
    return got


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("traceback", [False, True])
def test_tracksets_match_jax_and_oracle(mode, traceback):
    pairs = ragged_pairs(5, 9, 3, 30)
    batch.reset_route_counts()
    check(pairs, ["blosum62", "pam250"], (1.0, 0.25), (11, 1), mode, traceback,
          bucket_sizes=(15, 31), batch_pairs=4)
    assert batch.route_counts["two_kernel"] > 0 and batch.route_counts["tiled"] == 0


@pytest.mark.parametrize("mode", ["global", "local"])
def test_three_level_series(mode):
    check(ragged_pairs(6, 6, 3, 28), ["blosum62", "pam250"], (0.75, 0.5), (13, 7, 1), mode,
          True, bucket_sizes=(31,))


def test_empty_sides():
    rng = np.random.default_rng(7)
    empty = JaxProfile.from_tokens(np.zeros(0, np.int32), JAX_AA)
    pairs = [
        ((empty, empty), (jax_prof(rng, 5), jax_prof(rng, 5))),
        ((jax_prof(rng, 4), jax_prof(rng, 4)), (empty, empty)),
        ((empty, empty), (empty, empty)),
        ((jax_prof(rng, 4), jax_prof(rng, 4)), (jax_prof(rng, 6), jax_prof(rng, 6))),
    ]
    for mode in MODES:
        for tb in (False, True):
            got = check(pairs, ["blosum62", "pam250"], (1.0, 1.0), (11, 1), mode, tb,
                        bucket_sizes=(31,))
            if not tb:
                assert (got[0].ti, got[0].tj) == (0, 5) and (got[1].ti, got[1].tj) == (4, 0)


def test_protein_and_dna_tracks():
    """Tracks of different alphabets and matrices; only lengths are
    parallel."""
    pairs = ragged_pairs(8, 6, 3, 25, alphabets=(JAX_AA, JAX_DNA))
    for tb in (False, True):
        check(pairs, ["blosum62", "dna_simple"], (1.0, 2.0), (11, 1), "semiglobal", tb,
              bucket_sizes=(31,))


def test_zero_weight_track_is_inert():
    pairs = ragged_pairs(9, 5, 3, 25)
    two = check(pairs, ["blosum62", "pam250"], (1.0, 0.0), (11, 1), "global", True,
                bucket_sizes=(31,))
    one = batch.align_tracksets_batched(
        [((tx[0],), (ty[0],)) for tx, ty in to_port(pairs)], [builtin_score_matrix("blosum62")],
        (1.0,), (11, 1), "global", device="cpu", traceback=True, bucket_sizes=(31,))
    for a, b in zip(two, one):
        assert a.score == b.score
        np.testing.assert_array_equal(a.cols_x, b.cols_x)


def test_shared_first_track_does_not_alias():
    """Tracksets sharing their first track but not their second get rows of
    their own (keyed by the full tuple of identities)."""
    rng = np.random.default_rng(51)
    sx, sy = jax_prof(rng, 12), jax_prof(rng, 9)
    pairs = [((sx, jax_prof(rng, 12)), (sy, jax_prof(rng, 9))) for _ in range(2)]
    got = check(pairs, ["blosum62", "pam250"], (1.0, 1.0), (11, 1), "global", True,
                bucket_sizes=(31,))
    assert got[0].score != got[1].score


def test_validation_and_exactness_errors():
    rng = np.random.default_rng(4)
    px, py = jax_prof(rng, 5), jax_prof(rng, 6)
    b62, pam = builtin_score_matrix("blosum62"), builtin_score_matrix("pam250")
    jb62, jpam = jax_matrix("blosum62"), jax_matrix("pam250")
    short = jax_prof(rng, 4)
    cases = [
        ([((px, px), (py, py))], 2, (1.0,)),          # weights do not align
        ([((px, px), (py, py))], 0, ()),               # no track
        ([((px,), (py, py))], 2, (1.0, 1.0)),          # a side lacks a track
        ([((px, short), (py, py))], 2, (1.0, 1.0)),    # unequal parallel lengths
    ]
    for pairs, T, w in cases:
        mats, jmats = [b62, pam][:T], [jb62, jpam][:T]
        with pytest.raises(ValueError) as port_err:
            batch.align_tracksets_batched(to_port(pairs), mats, w, (11, 1), "global",
                                          device="cpu")
        with pytest.raises(ValueError) as jax_err:
            jax_tracksets(pairs, jmats, w, (11, 1), "global")
        assert str(port_err.value) == str(jax_err.value)
    # counts too large for exact f32 scoring, in the second track only
    big = JaxProfile(np.full((5, JAX_AA.size), 300.0, np.float32), np.zeros(5, np.float32), JAX_AA)
    pairs = [((px, big), (py, JaxProfile(np.full((6, JAX_AA.size), 300.0, np.float32),
                                         np.zeros(6, np.float32), JAX_AA)))]
    with pytest.raises(ValueError, match="exact f32") as port_err:
        batch.align_tracksets_batched(to_port(pairs), [b62, pam], (1.0, 1.0), (11, 1), "global",
                                      device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jax_tracksets(pairs, [jb62, jpam], (1.0, 1.0), (11, 1), "global")
    assert str(port_err.value) == str(jax_err.value)
    # a mesh is no longer refused: no pairs give no results on one as without
    assert batch.align_tracksets_batched([], [b62], (1.0,), (11, 1), "global", device="cpu",
                                         mesh=make_pair_mesh(2, device="cpu")) == []


@pytest.mark.parametrize("traceback", [False, True])
def test_rows_past_the_lane_cap_take_the_tiled_route(monkeypatch, traceback):
    """With the whole-row DP's cap lowered to 64 lanes and tiles of 64,
    rows of 70-100 columns take the tiled DP over the composite hs, in two
    tiles."""
    monkeypatch.setattr(wavefront, "MAX_LANES", 64)
    monkeypatch.setattr(tiled_dp, "MAX_TILE_LANES", 64)
    widest = []
    plain = tiled_dp.wavefront_dp_tiled_plain

    def spy(source, lx, ly, *args, **options):
        widest.append(source.shape[2])
        return plain(source, lx, ly, *args, **options)

    monkeypatch.setattr(tiled_dp, "wavefront_dp_tiled_plain", spy)
    batch.reset_route_counts()
    check(ragged_pairs(10, 4, 70, 100), ["blosum62", "pam250"], (1.0, 0.5), (11, 1), "local",
          traceback, batched=False, bucket_sizes=(127,))
    assert batch.route_counts["tiled"] > 0 and batch.route_counts["two_kernel"] == 0
    assert widest and max(widest) > 64


def test_composite_route_and_chunk_bytes():
    cap = wavefront.MAX_LANES
    for dev in ("cuda", "cpu"):
        assert batch.composite_route(dev, cap - 1, 500, True) == "two_kernel"
        assert batch.composite_route(dev, cap, 500, True) == "tiled"
    by = batch.HS_BYTES_BUDGET // (4 * 5001)
    for dev in ("cuda", "cpu"):  # past the hs budget: the in-place composite
        assert batch.composite_route(dev, 5000, by, False) == "tiled"
        assert batch.composite_route(dev, 5000, by, True) == "tiled"
        assert batch.composite_route(dev, 5000, batch.TB_BYTES_BUDGET // 5001, True) == \
            "checkpointed"
    assert batch.tiled_source(5000, by, "cuda") == "rows"
    assert batch.composite_in_place("tiled", 5000, by, "cuda")
    assert not batch.composite_in_place("tiled", 5000, by, "cpu")
    hs_bytes, _ = batch.per_problem_bytes(1023, 700)
    got = batch.composite_problem_bytes("two_kernel", "cuda", 1023, 700, [23, 5], True)
    assert got == (batch.chunk_problem_bytes("two_kernel", "cuda", 1023, 700, 23, True)
                   + (1023 + 700) * 6 * 4 + hs_bytes)


@pytest.mark.parametrize("traceback", [False, True])
def test_composite_route_ignores_the_fused_route_knob(monkeypatch, traceback):
    """``PRALINE_FUSED_DP=1`` moves pairs to the fused kernel, which takes
    no composite: whole-row composites keep the two-kernel route and the
    rest route as without the knob."""
    shapes = [(1023, 700), (wavefront.MAX_LANES - 1, 500), (wavefront.MAX_LANES, 500),
              (5000, batch.HS_BYTES_BUDGET // (4 * 5001)), (5000, batch.TB_BYTES_BUDGET // 5001)]
    for dev in ("cuda", "cpu"):
        monkeypatch.delenv(batch.FUSED_DP_ENV, raising=False)
        want = [batch.composite_route(dev, bx, by, traceback) for bx, by in shapes]
        monkeypatch.setenv(batch.FUSED_DP_ENV, "1")
        assert batch.choose_route(dev, 1023, 700, traceback) == "fused"
        assert [batch.composite_route(dev, bx, by, traceback) for bx, by in shapes] == want
        assert want[:2] == ["two_kernel"] * 2


def test_traceback_past_its_budget_raises_on_the_card(monkeypatch):
    """An hs within its budget (raised here: at the real budgets an hs is
    about four times its traceback bytes) and traceback bytes past theirs:
    no longer refused.  Whole rows keep the two-kernel route, as pairs do
    (``choose_route``: a traceback runs checkpointed only where the rows
    leave the whole-row DP); past its lanes, the checkpointed route over
    the summed hs."""
    monkeypatch.setattr(batch, "HS_BYTES_BUDGET", 1 << 40)
    by = batch.TB_BYTES_BUDGET // 1024 + 10
    assert batch.composite_route("cuda", 1023, by, False) == "two_kernel"
    for dev in ("cuda", "cpu"):
        assert batch.composite_route(dev, 1023, by, True) == "two_kernel"
        assert batch.composite_route(dev, 2048, by, True) == "checkpointed"
    assert not batch.composite_in_place("checkpointed", 2048, by, "cuda")


def test_plain_composite_matches_jax_composite():
    rng = np.random.default_rng(12)
    B, Lx, Ly = 3, 9, 13
    tracks = []
    for A, name in ((JAX_AA.size, "blosum62"), (JAX_DNA.size, "dna_simple")):
        cx = rng.integers(0, 3, size=(B, Lx, A)).astype(np.float32)
        cy = rng.integers(0, 3, size=(B, Ly, A)).astype(np.float32)
        cx[:, :, 0] += 1
        cy[:, :, 0] += 1
        ivx = (np.float32(1.0) / cx.sum(axis=2)).astype(np.float32)
        ivy = (np.float32(1.0) / cy.sum(axis=2)).astype(np.float32)
        tracks.append((cx, ivx, cy, ivy, jax_matrix(name).as_f32()))
    w = (0.3, 1.7)
    want = np.asarray(jax_composite(*[[t[i] for t in tracks] for i in range(5)], w))
    got = composite_skewed_scores(*[[torch.from_numpy(t[i]) for t in tracks] for i in range(5)], w)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
