"""The tiled DP's in-place score tiers (``csrc/rows_box.cuh``) on the CPU.

- The "mma" tier's box of one visit (``kernels/tiled_dp.py::
  visit_box_plain``: the tile's rows and the band's columns in the int64
  limb arithmetic) against slices of the JAX package's
  ``skewed_pair_scores``, bit for bit: at tiles past the first, where the
  band clips at j < 0 and j >= Ly, with y counts of one limb and of two
  (256, 992, 65535), and for a two-track composite in track order against
  JAX ``composite_skewed_scores``.
- Routing: every route passes the chunk's tier to the kernel that computes
  its scores, the tiled and checkpointed routes' rows source included; the
  chunk sizing counts the tier's scratch there; a composite chunk takes one
  tier for all its tracks; ``tier=`` is required on the in-place sources
  and refused on hs and on the ring's launch, which stays on the scalar
  tier at its measured box depth.
- The long routes on the rows source (budgets patched low) through
  ``align_pairs_batched`` against the JAX package's aligner, the chunk's
  tier reaching the tiled kernel's wrapper.

Tolerance 0.  The kernels themselves are held against these plain
versions on the card (``tests/test_torch_cuda.py``).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from praline_tpu import ALPHABET_AA as JAX_AA
from praline_tpu import builtin_score_matrix as jax_matrix
from praline_tpu.kernels import align_pairs_batched as jax_align_pairs
from praline_tpu.kernels import batch as jax_batch
from praline_tpu.kernels.scores import composite_skewed_scores as jax_composite
from praline_tpu.kernels.scores import skewed_pair_scores as jax_scores
from praline_tpu.types import Profile as JaxProfile
from praline_tpu_torch import builtin_score_matrix
from praline_tpu_torch.convert import operands_from_numpy, profile_from_arrays
from praline_tpu_torch.kernels import batch, tiled_dp
from praline_tpu_torch.kernels.fused_scores import TIERS, mma_scratch_bytes, tier_of
from praline_tpu_torch.kernels.scan import RingRows, ring_rows

torch.set_num_threads(1)

B62 = builtin_score_matrix("blosum62")
PAM = builtin_score_matrix("pam250")
A = 23


def seed_of(*key):
    return zlib.crc32(repr(key).encode())


def counts(rng, B, L, y_count=None):
    """Integer count profiles ``f32[B, L, A]`` and their inverses; with
    ``y_count`` every other column a single residue of that many counts
    (a wide row past 255)."""
    c = rng.integers(0, 3, size=(B, L, A)).astype(np.float32)
    c[:, :, 0] += 1
    if y_count is not None:
        c[:, ::2] = 0
        np.put_along_axis(c[:, ::2], rng.integers(0, A, size=(B, (L + 1) // 2, 1)),
                          float(y_count), axis=-1)
    return c, (np.float32(1) / c.sum(-1, dtype=np.float32)).astype(np.float32)


def jax_hs(cx, ivx, cy, ivy, s):
    return np.asarray(jax_scores(*(jnp.asarray(a) for a in (cx, ivx, cy, ivy, s))))


def box_of(hs, d0, i0, steps, lanes):
    """Diagonals d0 .. and lanes i0 .. of ``hs f32[D, B, Lp]``, +0 past its
    edges: what the box of that visit holds."""
    D, B, Lp = hs.shape
    out = np.zeros((steps, B, lanes), np.float32)
    d1, i1 = min(d0 + steps, D), min(i0 + lanes, Lp)
    out[: d1 - d0, :, : i1 - i0] = hs[d0:d1, :, i0:i1]
    return out


def same_bits(got, want):
    assert np.array_equal(np.asarray(got).view(np.int32), np.asarray(want).view(np.int32))


# y counts of one limb (None: at most 3), and of two u8 limbs
WIDE = [None, 256, 992, 65535]


@pytest.mark.parametrize("y_count", WIDE)
def test_visit_box_is_a_slice_of_jax_scores(y_count):
    """Every visit of a walk of 32-lane tiles and boxes of 8 (tiles past
    the first, bands clipped at j < 0 on the early boxes and at j >= Ly on
    the late ones, lanes past Lx) against the JAX package's skewed scores;
    with y counts past 255 the x side is one count a column (P5)."""
    rng = np.random.default_rng(seed_of("box", y_count))
    B, Lx, Ly, W, T = 2, 75, 41, 32, 8
    if y_count is None:
        cx, ivx = counts(rng, B, Lx)
        s = B62.as_f32()
    else:
        cx = np.eye(A, dtype=np.float32)[rng.integers(0, A, size=(B, Lx))]
        ivx = np.ones((B, Lx), np.float32)
        s = np.clip(B62.as_f32(), -2, 2) * np.float32(64 if y_count < 65535 else 1)
    cy, ivy = counts(rng, B, Ly, y_count)
    assert tier_of(cx, cy, s) == "mma"
    want = jax_hs(cx, ivx, cy, ivy, s)
    rows = tuple(torch.from_numpy(a) for a in (cx, ivx, cy, ivy, s))
    D = Lx + Ly + 1
    for d0 in range(2, D, T):
        for i0 in range(0, Lx + 1, W):
            same_bits(tiled_dp.visit_box_plain(rows, d0, i0, T, W), box_of(want, d0, i0, T, W))


@pytest.mark.parametrize("K", [1, 7, 32, 200])
def test_ring_steps_divide_the_chunk(K):
    """The ring's launch stays on the scalar tier at T up to
    ``RING_MAX_STEPS``: its default T is the largest divisor of the chunk
    up to it, and its geometry takes no box of the "mma" tier."""
    T = tiled_dp.ring_steps(K)
    assert 1 <= T <= tiled_dp.RING_MAX_STEPS and K % T == 0
    assert all(K % t for t in range(T + 1, tiled_dp.RING_MAX_STEPS + 1))
    g = tiled_dp.tiled_geometry(17_216, 2, "rows", steps=T, tier="scalar")
    assert g.smem_bytes < tiled_dp.tiled_geometry(17_216, 2, "rows", steps=T,
                                                  tier="mma").smem_bytes


def test_visit_box_of_a_composite_in_track_order():
    """Two tracks (BLOSUM62 and PAM250, weights 1 and 0.5), the second with
    y counts past 255: the box is JAX ``composite_skewed_scores``' slice."""
    rng = np.random.default_rng(seed_of("composite box"))
    B, Lx, Ly, W, T = 2, 50, 37, 32, 8
    cx0, ivx0 = counts(rng, B, Lx)
    cy0, ivy0 = counts(rng, B, Ly)
    cx1 = np.eye(A, dtype=np.float32)[rng.integers(0, A, size=(B, Lx))]
    ivx1 = np.ones((B, Lx), np.float32)
    cy1, ivy1 = counts(rng, B, Ly, 992)
    tracks = [(cx0, ivx0, cy0, ivy0, B62.as_f32()), (cx1, ivx1, cy1, ivy1, PAM.as_f32())]
    w = (1.0, 0.5)
    assert all(tier_of(t[0], t[2], t[4]) == "mma" for t in tracks)
    want = np.asarray(jax_composite(*[[jnp.asarray(t[i]) for t in tracks] for i in range(5)], w))
    c = tiled_dp.Composite(*[tuple(torch.from_numpy(t[i]) for t in tracks) for i in range(5)], w)
    for d0 in (2, 30, 70, Lx + Ly - 3):
        for i0 in (0, 32):
            same_bits(tiled_dp.visit_box_plain(c, d0, i0, T, W), box_of(want, d0, i0, T, W))


def rows_operands(seed, B=2, Lx=40, Ly=30):
    rng = np.random.default_rng(seed)
    cx, ivx = counts(rng, B, Lx)
    cy, ivy = counts(rng, B, Ly)
    lx = np.full(B, Lx, np.int32)
    ly = np.full(B, Ly, np.int32)
    return operands_from_numpy(cx, ivx, cy, ivy, B62.as_f32(), lx, ly, "cpu")


def test_tier_is_required_on_the_in_place_sources_and_refused_on_hs():
    """Every launch of the tiled DP: the rows source and the composite take
    "mma" or "scalar" and nothing else; hs takes none, nor does the ring's
    launch (one tier, "scalar").  On the CPU both tiers give the plain
    version."""
    ops = rows_operands(3)
    rows, lx, ly = ops[:5], ops[5], ops[6]
    hs = tiled_dp.source_scores(rows)
    c = tiled_dp.Composite(*[(r,) for r in rows], (1.0,))
    for source in (rows, c):
        for tier in (None, "fast", "bf16"):
            with pytest.raises(ValueError, match="tier"):
                tiled_dp.wavefront_dp_tiled(source, lx, ly, tier=tier)
            with pytest.raises(ValueError, match="tier"):
                tiled_dp.wavefront_dp_tiled_forward(source, lx, ly, (11, 1), "global", 8,
                                                    tier=tier)
            with pytest.raises(ValueError, match="tier"):
                tiled_dp.wavefront_dp_tiled_resume(source, lx, ly, (11, 1), "global", 8, 0,
                                                   None, tier=tier)
    for tier in TIERS:
        with pytest.raises(ValueError, match="tier"):
            tiled_dp.wavefront_dp_tiled(hs, lx, ly, tier=tier)
        with pytest.raises(ValueError, match="tier"):
            tiled_dp.wavefront_dp_tiled_forward(hs, lx, ly, (11, 1), "global", 8, tier=tier)
    r = ring_rows(*rows, 0, 41)
    with pytest.raises(TypeError, match="tier"):
        tiled_dp.wavefront_dp_tiled_ring(r, lx, ly, (11, 1), "global", False, 2, 4, None, None,
                                         None, None, tier="scalar")
    want = tiled_dp.wavefront_dp_tiled(hs, lx, ly)
    for tier in TIERS:
        for source in (rows, c):
            got = tiled_dp.wavefront_dp_tiled(source, lx, ly, tier=tier)
            for key in want:
                assert torch.equal(got[key], want[key]), (tier, key)
    assert tiled_dp.launches == dict.fromkeys(tiled_dp.SOURCE_TIERS, 0)
    assert isinstance(r, RingRows)


def test_every_route_takes_the_chunks_tier(monkeypatch):
    """The tiled route on the rows source (hs past its budget) and the
    checkpointed route get the chunk's tier, as the fused route does:
    "mma" for integer counts, "scalar" for halves."""
    monkeypatch.setattr(batch, "MAX_LANES_FUSED", 16)
    monkeypatch.setattr(batch.wavefront, "MAX_LANES", 16)
    monkeypatch.setattr(batch, "HS_BYTES_BUDGET", 64)
    seen = []
    tiled, walk = batch.wavefront_dp_tiled, batch.checkpointed_walk

    def spy_tiled(source, *args, tier=None, **kw):
        seen.append(("tiled", tiled_dp.source_kind(source), tier))
        return tiled(source, *args, tier=tier, **kw)

    def spy_walk(source, *args, tier=None, **kw):
        seen.append(("checkpointed", tiled_dp.source_kind(source), tier))
        return walk(source, *args, tier=tier, **kw)

    monkeypatch.setattr(batch, "wavefront_dp_tiled", spy_tiled)
    monkeypatch.setattr(batch, "checkpointed_walk", spy_walk)
    rng = np.random.default_rng(seed_of("route tiers"))
    for budget, route in ((1 << 40, "tiled"), (64, "checkpointed")):
        monkeypatch.setattr(batch, "TB_BYTES_BUDGET", budget)
        assert batch.choose_route("cpu", 31, 31, True) == route
        assert batch.tiled_source(31, 31, "cpu") == "rows"
        for half, tier in ((False, "mma"), (True, "scalar")):
            profs = []
            for L in (25, 20, 28):
                c, _ = counts(rng, 1, L)
                c = c[0] * np.float32(0.5 if half else 1.0)
                profs.append(profile_from_arrays(c, np.zeros(L, np.float32),
                                                 B62.alphabet.symbols))
            seen.clear()
            got = batch.align_pairs_batched([(profs[0], profs[1]), (profs[2], profs[0])], B62,
                                            (11, 1), "global", device="cpu", traceback=True,
                                            bucket_sizes=(31,))
            assert seen == [(route, "rows", tier)]
            assert all(np.isfinite(g.score) for g in got)


def test_chunk_sizing_counts_the_in_place_tier():
    """On the card the tiled routes' rows source counts its tier's scratch
    as the fused route does: the limbs on "mma", the larger of the limbs
    and the T/Cy copies on "scalar" (DNA's four-letter rows are smaller
    than the limbs)."""
    bx = 4600
    by = batch.HS_BYTES_BUDGET // (4 * (bx + 1))  # hs past its budget: the rows source
    assert batch.tiled_source(bx, by, "cuda") == "rows"
    mma = mma_scratch_bytes(1, bx, by)
    for A_, route in ((23, "tiled"), (4, "tiled"), (4, "checkpointed")):
        copies = (bx + by) * -(-A_ // 4) * 4 * 4
        on_mma = batch.chunk_problem_bytes(route, "cuda", bx, by, A_, False, "mma")
        on_scalar = batch.chunk_problem_bytes(route, "cuda", bx, by, A_, False, "scalar")
        assert on_scalar - on_mma == max(mma, copies) - mma
    assert batch.chunk_problem_bytes("tiled", "cuda", bx, by, 4, False, "scalar") == \
        batch.chunk_problem_bytes("tiled", "cuda", bx, by, 4, False, "mma")


def test_a_composite_chunk_takes_one_tier():
    assert batch.composite_tier(["mma", "mma"]) == "mma"
    assert batch.composite_tier(["mma", "scalar"]) == "scalar"
    assert batch.composite_tier(["scalar", "mma"]) == "scalar"


def test_the_in_place_scratch_of_a_composite_counts_either_tier():
    bx = by = 26_000
    alphabets = (23, 4)
    got = batch.composite_problem_bytes("tiled", "cuda", bx, by, alphabets, False)
    first = batch.chunk_problem_bytes("tiled", "cuda", bx, by, 23, False)
    other = (bx + by) * 5 * 4 + max(mma_scratch_bytes(1, bx, by), (bx + by) * 4 * 4)
    assert batch.composite_in_place("tiled", bx, by, "cuda")
    assert got == first + other


def jax_pairs(rng, specs):
    def one(L):
        return JaxProfile.from_tokens(rng.integers(0, 20, size=L).astype(np.int32), JAX_AA)
    return [(one(a), one(b)) for a, b in specs]


def to_port(p):
    return profile_from_arrays(np.asarray(p.counts), np.asarray(p.gaps), JAX_AA.symbols)


@pytest.mark.parametrize("traceback", [False, True])
def test_long_route_on_the_rows_source_matches_jax(monkeypatch, traceback):
    """Past the (lowered) lane caps and hs budget the chunks take the tiled
    kernel's rows source, with traceback past the (lowered) traceback
    budget the checkpointed route; results equal the JAX package's
    aligner, and the chunk's tier reaches the wrapper."""
    monkeypatch.setattr(jax_batch, "_lane_cap", lambda gs, tb: 20)
    monkeypatch.setattr(jax_batch, "TB_BYTES_BUDGET", 64)
    monkeypatch.setattr(batch, "MAX_LANES_FUSED", 16)
    monkeypatch.setattr(batch.wavefront, "MAX_LANES", 16)
    monkeypatch.setattr(batch, "HS_BYTES_BUDGET", 64)
    monkeypatch.setattr(batch, "TB_BYTES_BUDGET", 64)
    seen = []
    tiled, walk = batch.wavefront_dp_tiled, batch.checkpointed_walk

    def spy_tiled(source, *args, tier=None, **kw):
        seen.append(tier)
        return tiled(source, *args, tier=tier, **kw)

    def spy_walk(source, *args, tier=None, **kw):
        seen.append(tier)
        return walk(source, *args, tier=tier, **kw)

    monkeypatch.setattr(batch, "wavefront_dp_tiled", spy_tiled)
    monkeypatch.setattr(batch, "checkpointed_walk", spy_walk)
    m = jax_matrix("blosum62")
    rng = np.random.default_rng(seed_of("long rows", traceback))
    pairs = jax_pairs(rng, [(25, 18), (31, 30), (25, 9), (12, 40)])
    want = jax_align_pairs(pairs, m, (11, 1), "local", traceback=traceback, bucket_sizes=(15,),
                           backend="pallas")
    got = batch.align_pairs_batched([(to_port(a), to_port(b)) for a, b in pairs], B62, (11, 1),
                                    "local", device="cpu", traceback=traceback,
                                    bucket_sizes=(15,))
    assert seen and set(seen) == {"mma"}
    for w, g in zip(want, got):
        assert g.score == w.score
        if traceback:
            np.testing.assert_array_equal(g.cols_x, w.cols_x)
            np.testing.assert_array_equal(g.cols_y, w.cols_y)
        else:
            assert g.length == w.length
