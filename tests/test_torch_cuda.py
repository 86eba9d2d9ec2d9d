"""The Hopper kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (a CUDA kernel has no CPU mode) and
skips without one.  The file imports no JAX, so it also runs on a machine
that has only PyTorch: there the repository's ``tests/conftest.py`` (which
pins JAX to the CPU) must be left out::

    python -m pytest --noconftest -p no:cacheprovider -m requires_cuda tests/test_torch_cuda.py

Tolerance 0: producer, DP, fused producer + DP, tiled DP, walk, the
probes and the batched aligners (single-track and composite) are
bit-exact by contract.
"""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

from praline_tpu_torch import ALPHABET_AA, METRICS, Profile, builtin_score_matrix
from praline_tpu_torch.convert import matrix_to_torch, operands_from_numpy, profiles_to_stack
from praline_tpu_torch.kernels import (
    batch, fused_dp, fused_scores, probes, replay, tiled_dp, wavefront,
)
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


@pytest.mark.parametrize("tier", fused_scores.TIERS)
@pytest.mark.parametrize("bx,by", [(31, 63), (200, 100), (1023, 1023)])
def test_producer_matches_plain(cuda, bx, by, tier):
    cx, ivx, cy, ivy, s, _, _ = operands(bx + by, 16, bx, by, cuda)
    before = dict(fused_scores.launches)
    got = fused_scores.fused_skewed_scores(cx, ivx, cy, ivy, s, tier=tier)
    torch.cuda.synchronize()
    assert fused_scores.launches == {**before, tier: before[tier] + 1}
    assert torch.equal(got.view(torch.int32), plain_scores(cx, ivx, cy, ivy, s).view(torch.int32))


@pytest.mark.parametrize("tier", fused_scores.TIERS)
@pytest.mark.parametrize("B,Lx,Ly,A_", [(3, 300, 200, 4), (1, 130, 70, 32), (2, 64, 1, 23),
                                        (2, 1, 257, 23)])
def test_producer_tiers_at_the_predicate_edges(cuda, B, Lx, Ly, A_, tier):
    """Counts of 255, |T| = 32766 and |H_int| = 32766 * 510 (just under
    2**15 and 2**24), negative S entries, each output NaN-poisoned first."""
    rng = np.random.default_rng(B * 1000 + A_)
    s = rng.integers(-127, 128, size=(A_, A_)).astype(np.float32)
    s[0, 1] = s[0, 2] = 127
    cx = rng.multinomial(258, np.ones(A_) / A_, size=(B, Lx)).astype(np.float32)
    cy = np.zeros((B, Ly, A_), np.float32)
    np.put_along_axis(cy, np.argsort(rng.random((B, Ly, A_)), axis=-1)[..., :2], 255.0, axis=-1)
    cx[:, 0] = 0
    cx[:, 0, 0] = 258
    cy[:, 0] = 0
    cy[:, 0, 1] = cy[:, 0, 2] = 255
    inv = lambda c: (np.float32(1) / np.maximum(c.sum(-1, dtype=np.float32), 1)).astype(np.float32)
    assert fused_scores.tier_of(cx, cy, s) == "mma"
    ops = operands_from_numpy(cx, inv(cx), cy, inv(cy), s, [1], [1], cuda)[:5]
    out = torch.full((Lx + Ly + 1, B, Lx + 1), float("nan"), device=cuda)
    got = fused_scores.fused_skewed_scores(*ops, tier=tier, out=out)
    assert got is out
    assert torch.equal(out.view(torch.int32), plain_scores(*ops).view(torch.int32))


@pytest.mark.parametrize("y_count,x_total,max_s", [(992, 992, 17), (65535, 1, 127),
                                                   (65535, 2, 127)])
def test_mma_tier_with_wide_y_matches_plain(cuda, y_count, x_total, max_s):
    """y counts past 255 (Cy as two u8 limbs): every other column a single
    residue of ``y_count`` counts, so bands with and without a wide column;
    x columns of ``x_total`` counts (one pass for 1, two limbs else), |H_int|
    up to x_total * max_s * y_count.  The producer's and the fused kernel's
    "mma" tiers, the producer's output NaN-poisoned, bit-equal to plain."""
    rng = np.random.default_rng(y_count + x_total)
    B, Lx, Ly, A_ = 3, 300, 700, 23
    s = rng.integers(-max_s, max_s + 1, size=(A_, A_)).astype(np.float32)
    s[0, 1], s[0, 2] = max_s, -max_s
    cx = rng.multinomial(x_total, np.ones(A_) / A_, size=(B, Lx)).astype(np.float32)
    cy = rng.multinomial(255, np.ones(A_) / A_, size=(B, Ly)).astype(np.float32)
    cy[:, ::2] = 0
    np.put_along_axis(cy[:, ::2], rng.integers(0, A_, size=(B, Ly // 2, 1)), float(y_count),
                      axis=-1)
    cx[:, 0] = 0
    cx[:, 0, 0] = x_total
    cy[:, :2] = 0
    cy[:, 0, 1] = cy[:, 1, 2] = y_count
    inv = lambda c: (np.float32(1) / np.maximum(c.sum(-1, dtype=np.float32), 1)).astype(np.float32)
    assert fused_scores.tier_of(cx, cy, s) == "mma"
    lens = [[Lx, Lx - 50, 1], [Ly, 1, Ly - 333]]
    ops = operands_from_numpy(cx, inv(cx), cy, inv(cy), s, *lens, cuda)
    out = torch.full((Lx + Ly + 1, B, Lx + 1), float("nan"), device=cuda)
    fused_scores.fused_skewed_scores(*ops[:5], tier="mma", out=out)
    assert torch.equal(out.view(torch.int32), plain_scores(*ops[:5]).view(torch.int32))
    for traceback in (False, True):
        want = fused_dp.wavefront_dp_fused_plain(*ops, (11, 1), "local", traceback)
        got = fused_dp.wavefront_dp_fused(*ops, (11, 1), "local", traceback, tier="mma")
        torch.cuda.synchronize()
        for key in want:
            assert torch.equal(got[key], want[key]), key


def test_batch_driver_takes_the_tier_the_predicate_gives(cuda):
    """Integer profiles take the tensor-core tier on the card, dyadic ones
    the scalar tier, each to the CPU's results."""
    rng = np.random.default_rng(29)
    profs = []
    for L in (90, 70, 110):
        c = rng.integers(0, 3, size=(L, A)).astype(np.float32)
        c[:, 0] += 1
        profs.append(Profile(c, np.zeros(L, np.float32), ALPHABET_AA))
    for scale, tier in ((1.0, "mma"), (0.5, "scalar")):
        ps = [Profile(p.counts * np.float32(scale), p.gaps, ALPHABET_AA) for p in profs]
        pairs = [(ps[0], ps[1]), (ps[1], ps[2])]
        before = dict(fused_scores.launches)
        got = batch.align_pairs_batched(pairs, B62, (11, 1), "global", device=cuda)
        assert fused_scores.launches[tier] > before[tier]
        assert sum(fused_scores.launches.values()) - sum(before.values()) == \
            fused_scores.launches[tier] - before[tier]
        assert got == batch.align_pairs_batched(pairs, B62, (11, 1), "global", device="cpu")


def dp_geometries(Lp, k):
    """The DP's two geometries at 32-lane tiles (so that short rows take
    several tiles or CTAs), the throughput one built for four and for five
    CTAs an SM."""
    return (wavefront.geometry("throughput", Lp, k, tile_lanes=32),
            wavefront.geometry("throughput", Lp, k, tile_lanes=32, min_blocks=5),
            wavefront.geometry("latency", Lp, k, tile_lanes=32))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gap_series", [(11, 1), (13, 7, 1), (5,), (4, 3, 2, 1), (9, 7, 5, 3, 2, 1)])
@pytest.mark.parametrize("traceback", [False, True])
def test_dp_matches_plain(cuda, mode, gap_series, traceback):
    """The default geometry, then each geometry at 32-lane tiles."""
    seed = zlib.crc32(repr((mode, gap_series)).encode())
    cx, ivx, cy, ivy, s, lx, ly = operands(seed, 8, 100, 63, cuda)
    hs = plain_scores(cx, ivx, cy, ivy, s)
    want = plain_dp(hs, lx, ly, gap_series, mode, traceback)
    for g in (None, *dp_geometries(101, len(gap_series))):
        before = wavefront.launches
        got = wavefront.wavefront_dp(hs, lx, ly, gap_series, mode, traceback, geometry=g)
        torch.cuda.synchronize()
        assert wavefront.launches == before + 1
        for key in want:
            assert torch.equal(got[key], want[key]), (key, g)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", wavefront.GEOMETRIES)
def test_dp_band_edges(cuda, mode, kind):
    """Scores mode runs only the band's visits: problems at its edges (both
    lengths 1, lx << ly, lx >> ly, lx = Lp - 1, and ly = 2 mod 32, with
    which every full tile leaves the band at a box's first diagonal), into
    poisoned outputs."""
    L = 300
    pairs = ((1, 1), (1, L), (L, 1), (3, 250), (280, 5), (L, L), (200, 34), (97, 66), (129, 2))
    lx = torch.tensor([a for a, _ in pairs], dtype=torch.int32, device=cuda)
    ly = torch.tensor([b for _, b in pairs], dtype=torch.int32, device=cuda)
    rng = np.random.default_rng(zlib.crc32(repr(("edges", mode)).encode()))
    hs = torch.from_numpy(rng.normal(0, 4, size=(2 * L + 1, len(pairs), L + 1))
                          .astype(np.float32)).to(cuda)
    for series in ((11, 1), (13, 7, 1)):
        want = plain_dp(hs, lx, ly, series, mode)
        for W in (32, 64, 128):
            g = wavefront.geometry(kind, L + 1, len(series), tile_lanes=W)
            out = {k: torch.full_like(v, float("nan") if v.is_floating_point() else -7)
                   for k, v in want.items()}
            wavefront.wavefront_dp(hs, lx, ly, series, mode, geometry=g, out=out)
            torch.cuda.synchronize()
            for key in want:
                assert torch.equal(out[key], want[key]), (key, g)


@pytest.mark.parametrize("traceback", [False, True])
def test_dp_lane_slots_match_the_model(cuda, traceback):
    """The lane slots the kernel counts as it runs (``slots=``) equal
    ``wavefront.lane_slots`` on both geometries, ragged lengths included."""
    cx, ivx, cy, ivy, s, lx, ly = operands(17, 8, 300, 250, cuda)
    hs = plain_scores(cx, ivx, cy, ivy, s)
    for g in (None, *dp_geometries(301, 2)):
        ran = torch.zeros(1, dtype=torch.int64, device=cuda)
        wavefront.wavefront_dp(hs, lx, ly, (11, 1), "global", traceback, geometry=g, slots=ran)
        g = g or wavefront.dp_geometry(8, 301, 2, traceback)
        assert ran.item() == wavefront.lane_slots(lx.cpu().numpy(), ly.cpu().numpy(),
                                                  hs.shape[0], 301, g, traceback), g


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


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gap_series", [(11, 1), (13, 7, 1)])
def test_walk_windows_at_any_alignment(cuda, mode, gap_series):
    """The walks' windows are copied in 16-byte chunks aligned in device
    memory, and their moves stored so, whatever the layout: Lp = 301, the
    bytes and the tapes at odd offsets, tapes of odd lengths and cut short
    of the longest walk; the block walk over blocks of 37 rows.  Moves,
    counts and states against the plain versions."""
    seed = zlib.crc32(repr(("windows", mode, gap_series)).encode())
    cx, ivx, cy, ivy, s, lx, ly = operands(seed, 5, 300, 250, cuda)
    out = plain_dp(plain_scores(cx, ivx, cy, ivy, s), lx, ly, gap_series, mode, True)
    T, B, Lp = out["tb"].shape
    tb = torch.empty(T * B * Lp + 1, dtype=torch.uint8, device=cuda)[1:].view(T, B, Lp)
    tb.copy_(out["tb"])
    terminal = (out["ti"], out["tj"], out["tcode"])
    for steps in (T + 1, 301, 97):
        args = (tb, *terminal, gap_series, mode, steps)
        moves, n = replay.replay_moves(*args)
        want_moves, want_n = replay.replay_moves_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(moves, want_moves) and torch.equal(n, want_n), steps
    R, S = 37, T + 2
    state = replay.walk_state(*terminal, len(gap_series))
    want_state = state.clone()
    moves = torch.empty(B * S + 3, dtype=torch.uint8, device=cuda)[3:].view(B, S).zero_()
    want = torch.zeros((B, S), dtype=torch.uint8, device=cuda)
    for q in range(-(-T // R) - 1, -1, -1):
        bits = torch.full((R, B, Lp), 0xAB, dtype=torch.uint8, device=cuda)
        bits[: min(R, T - q * R)] = tb[q * R: (q + 1) * R]
        replay.replay_block(bits, state, moves, q, gap_series, mode)
        replay.replay_block_plain(bits, want_state, want, q, gap_series, mode)
        torch.cuda.synchronize()
        assert torch.equal(state, want_state) and torch.equal(moves, want), q
    assert torch.equal(moves[:, : T + 1], replay.replay_moves_plain(tb, *terminal, gap_series,
                                                                   mode, T + 1)[0])


@pytest.mark.parametrize("bx,by", [(200, 100), (1100, 700)])
@pytest.mark.parametrize("mode", ["global", "local"])
def test_dp_lane_counts_off_the_warp_grid(cuda, bx, by, mode):
    """Lp not a multiple of 32 (idle lanes in the last tile), on both
    geometries at their default tiles."""
    cx, ivx, cy, ivy, s, lx, ly = operands(bx * 7 + by, 3, bx, by, cuda)
    hs = plain_scores(cx, ivx, cy, ivy, s)
    for traceback in (False, True):
        want = plain_dp(hs, lx, ly, (13, 7, 1), mode, traceback)
        for kind in wavefront.GEOMETRIES:
            g = wavefront.geometry(kind, bx + 1, 3)
            got = wavefront.wavefront_dp(hs, lx, ly, (13, 7, 1), mode, traceback, geometry=g)
            for key in want:
                assert torch.equal(got[key], want[key]), (key, g)


def test_dp_two_lanes_per_thread(cuda):
    """Bucket 2047, where the whole-row DP before the tiled walk ran two
    lanes a thread: Lp = 2048 lanes, 16 tiles of 128 on one CTA, on a
    cluster of 4 CTAs of 4 tiles and on a cluster of 16."""
    cx, ivx, cy, ivy, s, lx, ly = operands(11, 2, 2047, 300, cuda)
    hs = plain_scores(cx, ivx, cy, ivy, s)
    for traceback in (False, True):
        want = plain_dp(hs, lx, ly, (11, 1), "global", traceback)
        for g in (wavefront.geometry("throughput", 2048, 2),
                  wavefront.geometry("latency", 2048, 2, ctas=4),
                  wavefront.geometry("latency", 2048, 2)):
            got = wavefront.wavefront_dp(hs, lx, ly, (11, 1), "global", traceback, geometry=g)
            for key in want:
                assert torch.equal(got[key], want[key]), (key, g)


def test_dp_refuses_what_it_does_not_take(cuda):
    """Buckets past 2047 are the fused kernel's (the batch driver routes
    them there); the two-kernel DP refuses them."""
    cx, ivx, cy, ivy, s, lx, ly = operands(12, 1, 2048, 31, cuda)
    hs = plain_scores(cx, ivx, cy, ivy, s)
    with pytest.raises(NotImplementedError):
        wavefront.wavefront_dp(hs, lx, ly, (11, 1), "global")
    # a geometry the kernel does not take raises before any launch
    hs = hs[:, :, :32].contiguous()[:64]
    lx.fill_(20)
    before = wavefront.launches
    for g in (wavefront.geometry("throughput", 32, 2, tile_lanes=512),
              wavefront.geometry("latency", 32, 2, tile_lanes=32, ctas=17)):
        with pytest.raises(ValueError):
            wavefront.wavefront_dp(hs, lx, ly, (11, 1), "global", geometry=g)
    assert wavefront.launches == before


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


def fused_vs_plain(cx, ivx, cy, ivy, s, lx, ly, gap_series, mode, traceback):
    """The cluster kernel on both score tiers against the plain version."""
    want = fused_dp.wavefront_dp_fused_plain(cx, ivx, cy, ivy, s, lx, ly, gap_series, mode,
                                             traceback)
    for tier in fused_dp.TIERS:
        before = dict(fused_dp.launches)
        got = fused_dp.wavefront_dp_fused(cx, ivx, cy, ivy, s, lx, ly, gap_series, mode,
                                          traceback, tier=tier)
        torch.cuda.synchronize()
        assert fused_dp.launches[tier] == before[tier] + 1
        assert set(got) == set(want)
        for key in want:
            assert torch.equal(got[key], want[key]), (tier, key)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gap_series", [(11, 1), (13, 7, 1), (5,), (4, 3, 2, 1), (9, 7, 5, 3, 2, 1)])
@pytest.mark.parametrize("traceback", [False, True])
def test_fused_matches_plain(cuda, mode, gap_series, traceback):
    seed = zlib.crc32(repr(("fused", mode, gap_series)).encode())
    ops = operands(seed, 8, 31, 63, cuda)
    fused_vs_plain(*ops, gap_series, mode, traceback)


@pytest.mark.parametrize("bx,by,mode", [(3000, 300, "global"), (3000, 300, "local"),
                                        (4095, 200, "semiglobal")])
def test_fused_rows_past_the_two_kernel_cap(cuda, bx, by, mode):
    """Lp 3001 and 4096: clusters of six and eight CTAs."""
    ops = operands(bx + by, 2, bx, by, cuda)
    for traceback in (False, True):
        fused_vs_plain(*ops, (11, 1), mode, traceback)


def test_fused_long_y(cuda):
    """Ly 8000: no hs tensor, so the length of y is not bounded."""
    ops = operands(8000, 2, 600, 8000, cuda)
    for traceback in (False, True):
        fused_vs_plain(*ops, (11, 1), "semiglobal", traceback)


def test_fused_refuses_past_its_lane_cap(cuda):
    ops = operands(4096, 1, 4096, 31, cuda)
    with pytest.raises(NotImplementedError):
        fused_dp.wavefront_dp_fused(*ops, (11, 1), "global", tier="mma")


@pytest.mark.parametrize("traceback", [False, True])
def test_batched_aligner_routes_long_rows_to_the_fused_kernel(cuda, traceback):
    rng = np.random.default_rng(17)
    profs = []
    for L in (2500, 2300, 900):
        c = rng.integers(0, 2, size=(L, A)).astype(np.float32)
        c[:, 0] += 1
        profs.append(Profile(c, np.zeros(L, np.float32), ALPHABET_AA))
    pairs = [(profs[0], profs[1]), (profs[1], profs[2]), (profs[2], profs[0])]
    batch.reset_route_counts()
    got = batch.align_pairs_batched(pairs, B62, (11, 1), "local", device=cuda,
                                    traceback=traceback)
    assert batch.route_counts["fused"] == 2
    want = batch.align_pairs_batched(pairs, B62, (11, 1), "local", device="cpu",
                                     traceback=traceback)
    for g, w in zip(got, want):
        if traceback:
            assert g.score == w.score
            assert np.array_equal(g.cols_x, w.cols_x) and np.array_equal(g.cols_y, w.cols_y)
        else:
            assert g == w


def source_tiers(source):
    """The score tiers a tiled source is run on here: hs takes none, the
    in-place sources both (the predicate admits these integer counts)."""
    return (None,) if tiled_dp.source_kind(source) == "hs" else fused_scores.TIERS


def poisoned_outputs(source, traceback):
    """The tiled DP's output tensors for ``source``, NaN-poisoned (0xAB
    bytes, -7 indices)."""
    B, Lx, Ly = tiled_dp.problem_shape(source)
    out = fused_dp.empty_outputs(B, Lx, Ly, traceback, tiled_dp.source_device(source))
    for t in out.values():
        t.fill_(float("nan") if t.is_floating_point() else 0xAB if t.dtype == torch.uint8 else -7)
    return out


def tiled_vs_plain(source, lx, ly, gap_series, mode, traceback, want, **kw):
    """The tiled kernel on ``source``, on each of its tiers, into poisoned
    outputs, equals ``want``; one launch counted a call, under its tier."""
    counts = (tiled_dp.composite_launches if tiled_dp.source_kind(source) == "composite"
              else tiled_dp.launches)
    for tier in source_tiers(source):
        key = tier or "hs"
        before = dict(counts)
        got = tiled_dp.wavefront_dp_tiled(source, lx, ly, gap_series, mode, traceback, tier=tier,
                                          out=poisoned_outputs(source, traceback), **kw)
        torch.cuda.synchronize()
        assert counts == {**before, key: before[key] + 1}
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (kw, tier, k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gap_series", [(11, 1), (13, 7, 1), (5,), (9, 7, 5, 3, 2, 1)])
@pytest.mark.parametrize("traceback", [False, True])
def test_tiled_matches_plain(cuda, mode, gap_series, traceback):
    """Both score sources; tiles of 32, 128 and 256 lanes (Lp 301: a
    ragged last tile); 1, 7 and 32 diagonals a visit."""
    seed = zlib.crc32(repr(("tiled", mode, gap_series)).encode())
    ops = operands(seed, 4, 300, 200, cuda)
    hs = plain_scores(*ops[:5])
    want = plain_dp(hs, ops[5], ops[6], gap_series, mode, traceback)
    for w, t in ((32, 7), (128, 32), (256, 1)):
        tiled_vs_plain(hs, ops[5], ops[6], gap_series, mode, traceback, want,
                       tile_lanes=w, steps_per_visit=t)
    tiled_vs_plain(ops[:5], ops[5], ops[6], gap_series, mode, traceback, want,
                   tile_lanes=128, steps_per_visit=32)


@pytest.mark.parametrize("R", range(1, tiled_dp.MAX_CTAS + 1))
def test_tiled_cluster_sizes_match_plain(cuda, R):
    """Every cluster size, with 1, 2 or 3 tiles a CTA (Lp 701: ragged last
    tiles; tiles sized for R % 3 + 1 tiles a CTA, which warp-wide tiles do
    not allow at every R), both sources, every mode, scores and
    traceback."""
    W = min(tiled_dp.MAX_TILE_LANES, -(-(-(-701 // (R * (R % 3 + 1)))) // 32) * 32)
    assert 1 <= tiled_dp.tiled_geometry(701, 2, ctas=R, tile_lanes=W).m <= 3
    ops = operands(700 + R, 3, 700, 90, cuda)
    hs = plain_scores(*ops[:5])
    for mode in MODES:
        for traceback in (False, True):
            want = plain_dp(hs, ops[5], ops[6], (11, 1), mode, traceback)
            for source in (hs, ops[:5]):
                tiled_vs_plain(source, ops[5], ops[6], (11, 1), mode, traceback, want,
                               ctas=R, tile_lanes=W, steps_per_visit=(32, 7, 3)[R % 3])


@pytest.mark.parametrize("lanes", tiled_dp.LANES_PER_THREAD)
@pytest.mark.parametrize("gap_series", [(5,), (11, 1), (13, 7, 1)])
def test_tiled_lanes_per_thread_match_plain(cuda, monkeypatch, lanes, gap_series):
    """Q lanes a thread (scores mode on hs, k = 1, 2, 3), every mode, ragged
    lx and ly (Lp 1301): each of the chooser's candidates at Q (1 to 3 CTAs
    of one tile, boxes of 32 diagonals or fewer where shared memory is
    short), taken by a chunk of 4 problems on a card said to hold one
    cluster of any other geometry at once."""
    Lp, k = 1301, len(gap_series)
    seed = zlib.crc32(repr(("lanes", lanes, gap_series)).encode())
    ops = operands(seed, 4, Lp - 1, 1100, cuda)
    hs = plain_scores(*ops[:5])
    wants = {mode: plain_dp(hs, ops[5], ops[6], gap_series, mode) for mode in MODES}
    cands = [g for g in tiled_dp.lanes_candidates(Lp, k, tiled_dp.sm_shared_memory())
             if g.Q == lanes]
    assert {g.R for g in cands} >= {2, 3}
    for target in cands:
        monkeypatch.setattr(tiled_dp, "max_active_clusters",
                            lambda k, source, g, ckpt=False, tier=None, t=target:
                            64 if g == t else 1)
        assert tiled_dp.tiled_geometry(Lp, k, problems=4, diagonals=hs.shape[0]) == target
        for mode in MODES:
            tiled_vs_plain(hs, ops[5], ops[6], gap_series, mode, False, wants[mode])


def test_tiled_chunk_past_one_wave_takes_lanes(cuda):
    """A scores chunk over hs of one problem more than the card holds
    one-lane clusters at once (Lp 4301) takes the Q-lane geometry by
    default, counts its problems under ``tiled.problems:q{Q}`` and equals
    the plain DP."""
    Lp, k = 4301, 2
    B = tiled_dp.max_active_clusters(k, "hs", tiled_dp.tiled_geometry(Lp, k)) + 1
    ops = operands(4301, B, Lp - 1, 500, cuda)
    hs = plain_scores(*ops[:5])
    g = tiled_dp.tiled_geometry(Lp, k, problems=B, diagonals=hs.shape[0])
    assert g.Q > 1
    key = f"tiled.problems:q{g.Q}"
    for mode in MODES:
        want = plain_dp(hs, ops[5], ops[6], (11, 1), mode)
        before = METRICS.counters.get(key, 0)
        tiled_vs_plain(hs, ops[5], ops[6], (11, 1), mode, False, want)
        assert METRICS.counters[key] == before + B


@pytest.mark.parametrize("mode", ["global", "local"])
def test_tiled_rows_past_the_fused_cap(cuda, mode):
    """Lp 4201, the default geometry (15 CTAs of one 288-lane tile), both
    sources."""
    ops = operands(4200 + len(mode), 1, 4200, 300, cuda)
    hs = plain_scores(*ops[:5])
    for traceback in (False, True):
        want = plain_dp(hs, ops[5], ops[6], (11, 1), mode, traceback)
        tiled_vs_plain(hs, ops[5], ops[6], (11, 1), mode, traceback, want)
        tiled_vs_plain(ops[:5], ops[5], ops[6], (11, 1), mode, traceback, want)


def test_tiled_refuses_what_it_does_not_take(cuda, monkeypatch):
    """Geometries the kernel does not take raise, and so does one the card
    cannot hold: no launch, no other kernel in its place."""
    ops = operands(5, 1, 100, 50, cuda)
    for kw in (dict(tile_lanes=48), dict(tile_lanes=1024), dict(steps_per_visit=33),
               dict(ctas=17)):
        for tier in fused_scores.TIERS:
            with pytest.raises(ValueError):
                tiled_dp.wavefront_dp_tiled(ops[:5], ops[5], ops[6], tier=tier, **kw)
    monkeypatch.setattr(tiled_dp, "max_active_clusters", lambda *args: 0)
    before = (dict(tiled_dp.launches), wavefront.launches, dict(fused_dp.launches))
    for source, tier in ((plain_scores(*ops[:5]), None), (ops[:5], "mma"), (ops[:5], "scalar")):
        with pytest.raises(RuntimeError, match="cannot hold one cluster"):
            tiled_dp.wavefront_dp_tiled(source, ops[5], ops[6], ctas=16, tier=tier)
    assert (tiled_dp.launches, wavefront.launches, dict(fused_dp.launches)) == before


def test_batched_aligner_routes_rows_past_4096_to_the_tiled_kernel(cuda):
    rng = np.random.default_rng(19)
    profs = []
    for L in (4300, 4150):
        c = rng.integers(0, 2, size=(L, A)).astype(np.float32)
        c[:, 0] += 1
        profs.append(Profile(c, np.zeros(L, np.float32), ALPHABET_AA))
    pairs = [(profs[0], profs[1])]
    for traceback in (False, True):
        batch.reset_route_counts()
        got = batch.align_pairs_batched(pairs, B62, (11, 1), "semiglobal", device=cuda,
                                        traceback=traceback)
        assert batch.route_counts["tiled"] == 1
        cx, ivx, lx = profiles_to_stack([profs[0]], 4300, cuda)
        cy, ivy, ly = profiles_to_stack([profs[1]], 4150, cuda)
        want = plain_dp(plain_scores(cx, ivx, cy, ivy, matrix_to_torch(B62, cuda)), lx, ly, (11, 1),
                        "semiglobal")
        assert got[0].score == want["score"][0].item()


def chain_values(seed, shape, device):
    """Both arms of the probe's max, negatives and values near 1e-36 and
    1.0, whose chains cross into the subnormal range."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    flat = x.reshape(-1)
    n = flat.size
    flat[: n // 4] = rng.uniform(900.0, 5000.0, size=n // 4)
    flat[n // 4 : n // 2] = -flat[n // 4 : n // 2]
    flat[n // 2 : n // 2 + 6] = [1e-36, -1e-36, 0.0, -0.0, 1000.0, 1e30]
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("links", [0, 1, 1000, 90000])
def test_probe_chains_match_plain(cuda, links):
    """K7 and K8 bit for bit; 90000 links take chains from 1.0 below
    1e-38."""
    x = chain_values(links, (33, 100), cuda)  # 3300 elements: a ragged last block
    before = dict(probes.launches)
    got = probes.smem_chain(x, links)
    torch.cuda.synchronize()
    assert probes.launches["smem_chain"] == before["smem_chain"] + 1
    want = probes.smem_chain_plain(x, links)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if links == 90000:
        assert ((want.abs() < 1.1754944e-38) & (want != 0)).any()  # subnormals reached
    got = probes.alu_chains(x, min(links, 2000))
    want = probes.alu_chains_plain(x, min(links, 2000))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("block", [(16, 128, 128), (8, 128, 1024), (3, 100, 77), (1, 1, 1)])
def test_write_blocks_match_plain(cuda, block):
    x = torch.tensor([[-0.0]], device=cuda)
    before = probes.launches["write_blocks"]
    got = probes.write_blocks(x, (20, 300, 1100), block)
    torch.cuda.synchronize()
    assert probes.launches["write_blocks"] == before + 1
    want = probes.write_blocks_plain(x, torch.empty((20, 300, 1100), device=cuda))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    hs = torch.full((300, 5, 200), 3.0, device=cuda)
    probes.write_blocks(torch.tensor([[2.5]], device=cuda), block=probes.HS_BLOCK,
                        out=probes.hs_pattern_view(hs))
    assert torch.equal(hs, torch.full_like(hs, 2.5))


def trackset_pairs(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        Lx, Ly = int(rng.integers(lo, hi + 1)), int(rng.integers(lo, hi + 1))
        pairs.append(tuple(tuple(Profile.from_tokens(rng.integers(0, 20, size=L).astype(np.int32),
                                                     ALPHABET_AA) for _ in range(2))
                           for L in (Lx, Ly)))
    return pairs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("traceback", [False, True])
def test_composites_match_plain_on_both_routes(cuda, monkeypatch, mode, traceback):
    """align_tracksets_batched on the card equals the CPU's plain
    composition: the whole-row route, then the tiled route (the whole-row
    cap lowered to 32 lanes, tiles of 64)."""
    mats, w = [B62, builtin_score_matrix("pam250")], (1.0, 0.5)
    pairs = trackset_pairs(23, 12, 60, 300)
    want = batch.align_tracksets_batched(pairs, mats, w, (11, 1), mode, device="cpu",
                                         traceback=traceback)
    for cap, route in ((wavefront.MAX_LANES, "two_kernel"), (32, "tiled")):
        monkeypatch.setattr(wavefront, "MAX_LANES", cap)
        monkeypatch.setattr(tiled_dp, "MAX_TILE_LANES", 64)
        batch.reset_route_counts()
        before = dict(fused_scores.launches)
        got = batch.align_tracksets_batched(pairs, mats, w, (11, 1), mode, device=cuda,
                                            traceback=traceback)
        assert batch.route_counts[route] > 0 and sum(batch.route_counts.values()) == \
            batch.route_counts[route]
        # one-hot tracks: every producer launch on the tensor cores
        assert fused_scores.launches == {"mma": before["mma"] + 2 * batch.route_counts[route],
                                         "scalar": before["scalar"]}
        for g, e in zip(got, want):
            if traceback:
                assert g.score == e.score
                assert np.array_equal(g.cols_x, e.cols_x) and np.array_equal(g.cols_y, e.cols_y)
            else:
                assert g == e


def merge_family(n, L, seed):
    """n members of a root of L residues with substitutions and short
    deletions."""
    from praline_tpu_torch import Sequence

    rng = np.random.default_rng(seed)
    root = rng.integers(0, 20, size=L)
    out = []
    for k in range(n):
        toks = root.copy()
        sub = rng.random(L) < 0.2
        toks[sub] = rng.integers(0, 20, size=int(sub.sum()))
        cut = int(rng.integers(0, L // 5))
        at = int(rng.integers(0, L - cut))
        out.append(Sequence(f"m{k}", np.delete(toks, np.arange(at, at + cut)).astype(np.int32),
                            ALPHABET_AA))
    return out


@pytest.mark.parametrize("mode", MODES)
def test_compose_matches_plain(cuda, mode):
    """The compose kernel against compose_plain on the card, output slots
    poisoned: tapes from the DP's traceback at (C, C) and, outside global
    mode, an empty walk, x moves alone and y moves alone."""
    from praline_tpu_torch.kernels import compose

    rng = np.random.default_rng(41)
    J, C = 6, 200
    counts = np.zeros((3 * J, C, A), np.float32)
    gaps = np.zeros((3 * J, C), np.float32)
    lens = np.r_[rng.integers(20, 100, size=2 * J), np.ones(J)].astype(np.int32)
    for k in range(2 * J):
        c = rng.integers(0, 3, size=(lens[k], A)).astype(np.float32)
        c[rng.random(lens[k]) < 0.3, 0] += 400  # merged columns past COUNT_LIMIT
        counts[k, : lens[k]], gaps[k, : lens[k]] = c, rng.integers(0, 50, size=lens[k])
    mems = np.r_[rng.integers(1, 300, size=2 * J), np.zeros(J)].astype(np.int32)
    inv_table = compose.inverse_table(float(counts.sum(-1).max()))
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    table = compose.NodeTable(up(counts), up(gaps), up(compose.column_inverses(counts, inv_table)),
                              up(lens), up(mems))
    li = torch.arange(0, 2 * J, 2, dtype=torch.int32, device=cuda)
    ri, oi = li + 1, torch.arange(2 * J, 3 * J, dtype=torch.int32, device=cuda)
    ix, iy = li.long(), ri.long()
    out = batch.dispatch("two_kernel", table.counts[ix], table.inv[ix], table.counts[iy],
                         table.inv[iy], matrix_to_torch(B62, cuda), table.lens[ix],
                         table.lens[iy], gap_series=(11, 1), mode=mode, traceback=True,
                         tier="scalar")
    moves, nm, ti, tj = out["moves"], out["nmoves"], out["ti"], out["tj"]
    if mode != "global":
        for row, (mv, k) in enumerate(((2, 0 if mode == "local" else 10), (2, 15), (3, 12))):
            moves[row].zero_()
            moves[row, :k] = mv
            nm[row], ti[row], tj[row] = k, (k if mv == 2 else 0), (k if mv == 3 else 0)
    clone = lambda t: compose.NodeTable(t.counts.clone(), t.gaps.clone(), t.inv.clone(),
                                        t.lens.clone(), t.mems.clone())
    want = clone(table)
    tape_p, nmv_p = compose.compose_plain(moves, nm, ti, tj, want, li, ri, oi, up(inv_table), mode)
    got = clone(table)
    for t in (got.counts, got.gaps, got.inv):
        t[oi.long()] = float("nan")
    got.lens[oi.long()] = -7
    before = compose.launches
    tape, nmv = compose.compose(moves, nm, ti, tj, got, li, ri, oi, up(inv_table), mode)
    torch.cuda.synchronize()
    assert compose.launches == before + 1
    assert torch.equal(tape, tape_p) and torch.equal(nmv, nmv_p)
    for key in ("counts", "gaps", "inv"):
        assert torch.equal(getattr(got, key).view(torch.int32), getattr(want, key).view(torch.int32))
    assert torch.equal(got.lens, want.lens) and torch.equal(got.mems, want.mems)


@pytest.mark.parametrize("mode", MODES)
def test_device_merge_cuda_equals_cpu(cuda, mode):
    """The device walk on the card, enqueued with every synchronizing call
    an error, gives the CPU's bytes and the per-level path's; the compose
    kernel runs once a level."""
    from praline_tpu_torch import PralineConfig, format_alignment_fasta
    from praline_tpu_torch.kernels import compose
    from praline_tpu_torch.msa import device_merge as dm
    from praline_tpu_torch.msa.pipeline import batched_all_pairs, per_level_merge
    from praline_tpu_torch.oracle.tree import build_guide_tree, similarity_from_scores

    seqs = merge_family(9, 150, 43)
    cfg = PralineConfig(merge_mode=mode)
    scores, lengths = batched_all_pairs(seqs, B62, cfg, device=cuda)
    tree = build_guide_tree(similarity_from_scores(scores, lengths, "length"), "average")
    plan = dm.plan_merge(seqs, tree, B62, cfg)
    before = compose.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        walk = dm.enqueue_walk(plan, plan.rungs[-1], cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert compose.launches == before + len(plan.levels)
    got = dm.collect_walk(plan, walk)
    want = dm.merge_on_device(dataclasses.replace(plan, rungs=plan.rungs[-1:]), "cpu")
    assert format_alignment_fasta(got) == format_alignment_fasta(want)
    assert format_alignment_fasta(got) == format_alignment_fasta(
        per_level_merge(seqs, tree, B62, cfg, device=cuda))


# ---- the long routes: checkpointed launches, block walk, in-place composite ----


def checkpointed_launches_match_plain(cuda, sources, hs, lx, ly, gap_series, mode, interval,
                                      geometry):
    """On each of ``sources`` (whose scores are ``hs``), at ``geometry``:
    the forward launch's terminals and snapshot equal ``forward_snapshots``'s,
    every block's resumed bytes ``resume_block``'s and the full traceback's
    rows, and the block walk's tape ``replay_moves_plain``'s over the full
    traceback."""
    D, B, Lp = hs.shape
    full = plain_dp(hs, lx, ly, gap_series, mode, True)
    want_moves, want_n = replay.replay_moves_plain(full["tb"], full["ti"], full["tj"],
                                                  full["tcode"], gap_series, mode, D - 1)
    want_out, want_snap = tiled_dp.forward_snapshots(hs, lx, ly, gap_series, mode, interval)
    want_blocks = [tiled_dp.resume_block(hs, want_snap, q, interval, gap_series, mode)
                   for q in range(want_snap.shape[0])]
    for source, tier in ((src, tier) for src in sources for tier in source_tiers(src)):
        # an in-place source's operands, made once for every launch, as the route does
        launch = dict(geometry)
        if tier is not None:
            launch.update(tier=tier, operands=tiled_dp.prepare_operands(source, tier))
        before = (dict(tiled_dp.forward_launches), dict(tiled_dp.resume_launches))
        out, snap = tiled_dp.wavefront_dp_tiled_forward(source, lx, ly, gap_series, mode,
                                                        interval, **launch)
        torch.cuda.synchronize()
        for key in want_out:
            assert torch.equal(out[key], want_out[key]), (tier, key)
        assert torch.equal(snap.view(torch.int32), want_snap.view(torch.int32))
        state = replay.walk_state(out["ti"], out["tj"], out["tcode"], len(gap_series))
        moves = torch.zeros((B, D - 1), dtype=torch.uint8, device=cuda)
        for q in range(snap.shape[0] - 1, -1, -1):
            bits = torch.full((interval, B, Lp), 0xAB, dtype=torch.uint8, device=cuda)
            tiled_dp.wavefront_dp_tiled_resume(source, lx, ly, gap_series, mode, interval, q,
                                               snap, out=bits, **launch)
            rows = min(interval, D - 2 - q * interval)  # rows past D - 1 are not written
            assert torch.equal(bits[:rows], want_blocks[q][:rows])
            assert torch.equal(bits[:rows], full["tb"][q * interval: q * interval + rows])
            blocks = replay.block_launches
            replay.replay_block(bits, state, moves, q, gap_series, mode)
            assert replay.block_launches == blocks + 1
        torch.cuda.synchronize()
        assert torch.equal(moves, want_moves) and torch.equal(state[5], want_n)
        key, nblk = tier or "hs", snap.shape[0]
        assert (tiled_dp.forward_launches[key], tiled_dp.resume_launches[key]) == (
            before[0][key] + 1, before[1][key] + nblk)


# (gap series, bx x by, geometry, carries in the scratch): more than one
# tile a CTA, where a tile restarts from the carry store (shared memory, or
# at 15 levels on 1024 lanes a CTA the device-memory scratch)
MANY_TILES = [((11, 1), (300, 200), dict(ctas=1, tile_lanes=64), False),
              ((13, 7, 1), (300, 200), dict(ctas=2, tile_lanes=32), False),
              (tuple(range(29, 0, -2)), (1000, 700), dict(ctas=1, tile_lanes=256), True)]


def composite_operands(cuda, key, bx, by):
    """A two-track composite (BLOSUM62 and PAM250, weights 1 and 0.5) and
    its true lengths."""
    tracks = [operands(zlib.crc32(repr((key, t)).encode()), 3, bx, by, cuda) for t in range(2)]
    pam = matrix_to_torch(builtin_score_matrix("pam250"), cuda)
    ops = [tracks[0][:5], (*tracks[1][:4], pam)]
    c = tiled_dp.Composite(*[tuple(o[i] for o in ops) for i in range(5)], (1.0, 0.5))
    return c, tracks[0][5], tracks[0][6]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gap_series", [(11, 1), (13, 7, 1), (5,)])
def test_tiled_resume_matches_plain(cuda, mode, gap_series):
    """The forward launch's terminals and snapshot, and each block's
    resumed bytes, on both sources, equal the plain pass's; the block walk
    over them equals ``replay_moves_plain`` over the full traceback."""
    seed = zlib.crc32(repr(("resume", mode, gap_series)).encode())
    ops = operands(seed, 3, 300, 200, cuda)
    hs = plain_scores(*ops[:5])
    checkpointed_launches_match_plain(cuda, (hs, ops[:5]), hs, ops[5], ops[6], gap_series, mode,
                                      64, dict(tile_lanes=128))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", range(len(MANY_TILES)))
def test_tiled_resume_on_many_tiles_matches_plain(cuda, mode, case):
    """As above with several tiles a CTA, on both sources and the in-place
    composite: a resumed tile restarts from the snapshot in place of the
    carry store, and the tiles after it from the store."""
    gap_series, (bx, by), geometry, scratch = MANY_TILES[case]
    for kind in tiled_dp.SOURCES:
        g = tiled_dp.tiled_geometry(bx + 1, len(gap_series), kind, **geometry)
        assert g.m > 1 and g.carry_scratch == scratch, (kind, g)
    ops = operands(zlib.crc32(repr(("many tiles", mode, case)).encode()), 3, bx, by, cuda)
    hs = plain_scores(*ops[:5])
    checkpointed_launches_match_plain(cuda, (hs, ops[:5]), hs, ops[5], ops[6], gap_series, mode,
                                      64, geometry)
    c, lx, ly = composite_operands(cuda, ("many tiles composite", mode, case), bx, by)
    checkpointed_launches_match_plain(cuda, (c,), tiled_dp.source_scores(c), lx, ly, gap_series,
                                      mode, 64, geometry)


@pytest.mark.parametrize("mode", MODES)
def test_composite_source_matches_plain(cuda, mode):
    """The in-place composite source equals the plain DP over
    ``composite_skewed_scores``, scores and traceback bytes, at one tile a
    CTA and at several."""
    c, lx, ly = composite_operands(cuda, ("composite", mode), 300, 200)
    want = plain_dp(tiled_dp.source_scores(c), lx, ly, (11, 1), mode, True)
    for geometry in (dict(tile_lanes=128), dict(ctas=1, tile_lanes=64)):
        tiled_vs_plain(c, lx, ly, (11, 1), mode, True, want, **geometry)


def wide_operands(seed, B, bx, by, y_count, x_total, max_s, device):
    """Operands the tensor-core predicate admits with y counts past 255
    (Cy as two u8 limbs on the "mma" tier): S of entries in [-max_s,
    max_s]; x columns of ``x_total`` counts; every other y column a single
    residue of ``y_count`` counts, the rest 255 counts spread, so that
    bands with and without a wide column meet; ragged true lengths."""
    rng = np.random.default_rng(seed)
    A_ = 23
    s = rng.integers(-max_s, max_s + 1, size=(A_, A_)).astype(np.float32)
    cx = rng.multinomial(x_total, np.ones(A_) / A_, size=(B, bx)).astype(np.float32)
    cy = rng.multinomial(255, np.ones(A_) / A_, size=(B, by)).astype(np.float32)
    cy[:, ::2] = 0
    np.put_along_axis(cy[:, ::2], rng.integers(0, A_, size=(B, (by + 1) // 2, 1)),
                      float(y_count), axis=-1)
    lx = rng.integers(1, bx + 1, size=B).astype(np.int32)
    ly = rng.integers(1, by + 1, size=B).astype(np.int32)
    lx[0], ly[0] = bx, by

    def inv(c):
        return (np.float32(1) / np.maximum(c.sum(-1, dtype=np.float32), 1)).astype(np.float32)

    assert fused_scores.tier_of(cx, cy, s) == "mma"
    return operands_from_numpy(cx, inv(cx), cy, inv(cy), s, lx, ly, device)


# (y count, x total, max |S|, mode): y counts of 992, 65535 (both limbs 255)
# and 256, |H_int| up to x_total * max_s * y_count, just under 2**24
WIDE_CASES = [(992, 992, 17, "global"), (65535, 2, 127, "local"), (256, 1, 127, "semiglobal")]


@pytest.mark.parametrize("case", WIDE_CASES)
def test_in_place_tiers_at_wide_y(cuda, case):
    """Every in-place launch of the tiled kernel on both tiers where y's
    counts pass 255, at three tiles a CTA: the ordinary launch (scores and
    traceback), the forward and every resumed block, the two-track
    composite (one track wide), and the ring across two shards on its
    scalar tier."""
    from praline_tpu_torch.dist import make_pair_mesh, ring_wavefront_dp

    *wide, mode = case
    ops = wide_operands(zlib.crc32(repr(("wide", case)).encode()), 2, 300, 200, *wide, cuda)
    rows, lx, ly = ops[:5], ops[5], ops[6]
    hs = plain_scores(*rows)
    geometry = dict(ctas=2, tile_lanes=64)
    assert tiled_dp.tiled_geometry(301, 2, "rows", tier="mma", **geometry).m == 3
    for traceback in (False, True):
        tiled_vs_plain(rows, lx, ly, (11, 1), mode, traceback,
                       plain_dp(hs, lx, ly, (11, 1), mode, traceback), **geometry)
    checkpointed_launches_match_plain(cuda, (rows,), hs, lx, ly, (11, 1), mode, 64, geometry)
    other = operands(zlib.crc32(repr(("wide other", case)).encode()), 2, 300, 200, cuda)
    c = tiled_dp.Composite(*[(r, o) for r, o in zip(rows, other[:5])], (1.0, 0.5))
    tiled_vs_plain(c, lx, ly, (11, 1), mode, True,
                   plain_dp(tiled_dp.source_scores(c), lx, ly, (11, 1), mode, True), **geometry)
    host = [t.cpu() for t in ops]
    want = ring_wavefront_dp(make_pair_mesh(2, device="cpu"), *host, mode=mode, traceback=True,
                             interval=32)
    before = tiled_dp.ring_launches
    got = ring_wavefront_dp(make_pair_mesh(devices=[cuda, cuda]), *host, mode=mode,
                            traceback=True, interval=32)
    assert tiled_dp.ring_launches > before
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("mode", MODES)
def test_checkpointed_route_cuda_equals_cpu(cuda, monkeypatch, mode):
    """The batch aligner past a (lowered) traceback budget runs the
    checkpointed route on the card, with the CPU's results."""
    rng = np.random.default_rng(5)
    profs = [Profile.from_tokens(rng.integers(0, 20, size=L).astype(np.int32), ALPHABET_AA)
             for L in (4700, 4500, 4300, 4900)]
    pairs = [(profs[0], profs[1]), (profs[2], profs[3])]
    monkeypatch.setattr(batch, "TB_BYTES_BUDGET", 1 << 20)
    want = batch.align_pairs_batched(pairs, B62, (11, 1), mode, device="cpu", traceback=True)
    batch.reset_route_counts()
    got = batch.align_pairs_batched(pairs, B62, (11, 1), mode, device=cuda, traceback=True)
    assert batch.checkpointed_chunks > 0
    for g, e in zip(got, want):
        assert g.score == e.score
        assert np.array_equal(g.cols_x, e.cols_x) and np.array_equal(g.cols_y, e.cols_y)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("interval", [1, 7, 32])
@pytest.mark.parametrize("geometry", [{}, dict(ctas=1, tile_lanes=32)])
def test_ring_launch_matches_plain(cuda, mode, interval, geometry):
    """A ring of two ranks on the card (``kernels/tiled_dp.py::
    wavefront_dp_tiled_ring``, one tile a CTA or four with the carries in
    shared memory): every launch, into NaN-poisoned carries, tails and
    candidate and 0xAB bytes, equals ``ring_superstep_plain`` on the same
    inputs, and the ring's terminals and bytes equal the plain full-row
    DP's."""
    from praline_tpu_torch.dist.ring import merge_candidates
    from praline_tpu_torch.kernels.scan import (
        edge_values, ring_candidate, ring_carries, ring_rows, ring_superstep_plain,
    )

    cx, ivx, cy, ivy, s, lx, ly = operands(zlib.crc32(repr(("ring", mode)).encode()), 3, 200,
                                           150, cuda)
    gs, K, n = (11, 1), interval, 2
    D, Lpn = 200 + 150 + 1, -(-201 // 2)
    want = plain_dp(plain_scores(cx, ivx, cy, ivy, s), lx, ly, gs, mode, True)
    ranks = [ring_rows(cx, ivx, cy, ivy, s, p * Lpn, Lpn) for p in range(n)]
    carries = [ring_carries(r, gs, mode) for r in ranks]
    cands = [ring_candidate(lx, ly, gs, mode).to(cuda) for _ in ranks]
    shape = (K, edge_values(2), 3)
    heads = [torch.zeros(shape, device=cuda) for _ in ranks]
    tails = [torch.zeros(shape, device=cuda) for _ in ranks]
    tb = [torch.zeros((D - 2, 3, Lpn), dtype=torch.uint8, device=cuda) for _ in ranks]
    nchunks = -(-(D - 2) // K)
    for step in range(nchunks + n - 1):
        for p in range(n):
            if not 0 <= step - p < nchunks:
                continue
            d0 = 2 + (step - p) * K
            nd = min(K, D - d0)
            h = heads[p] if p else None
            plain = dict(carries_out=torch.empty_like(carries[p]),
                         cand_out=torch.empty_like(cands[p]))
            plain_tails = torch.zeros(shape, device=cuda)
            plain_tb = torch.zeros((nd, 3, Lpn), dtype=torch.uint8, device=cuda)
            ring_superstep_plain(ranks[p], lx, ly, gs, mode, True, d0, K, carries[p], h,
                                 plain_tails, cands[p], tb=plain_tb, tb_row0=d0 - 2, **plain)
            got = dict(carries_out=torch.full_like(carries[p], float("nan")),
                       cand_out=torch.full_like(cands[p], float("nan")))
            tails[p].fill_(float("nan"))
            rows = tb[p][d0 - 2:d0 - 2 + nd]
            rows.fill_(0xAB)
            before = tiled_dp.ring_launches
            tiled_dp.wavefront_dp_tiled_ring(ranks[p], lx, ly, gs, mode, True, d0, K,
                                             carries[p], h, tails[p], cands[p], tb=tb[p],
                                             **got, **geometry)
            torch.cuda.synchronize()
            assert tiled_dp.ring_launches == before + 1
            for key in got:
                assert torch.equal(got[key].view(torch.int32), plain[key].view(torch.int32)), key
            assert torch.equal(tails[p][:nd].view(torch.int32), plain_tails[:nd].view(torch.int32))
            assert torch.equal(rows, plain_tb)
            carries[p], cands[p] = got["carries_out"], got["cand_out"]
        for p in range(1, n):
            heads[p].copy_(tails[p - 1])
    out = merge_candidates([c.cpu() for c in cands], mode)
    for key in ("score", "length", "ti", "tj", "tcode"):
        assert torch.equal(out[key], want[key].cpu()), key
    assert torch.equal(torch.cat(tb, dim=2)[:, :, :201], want["tb"])


def test_ring_on_the_card_equals_cpu(cuda):
    """``ring_wavefront_dp`` on a one-process mesh of two shards on the card
    gives the CPU shards' results: scores, traceback and checkpointed."""
    from praline_tpu_torch.dist import make_pair_mesh, ring_wavefront_dp

    ops = [t.cpu() for t in operands(7, 2, 300, 200, cuda)]
    gpu, cpu = make_pair_mesh(devices=[cuda, cuda]), make_pair_mesh(2, device="cpu")
    for kw in (dict(mode="local", traceback=True, interval=32),
               dict(mode="semiglobal", gap_series=(13, 7, 1), traceback=True, interval=8,
                    ckpt_interval=64)):
        want = ring_wavefront_dp(cpu, *ops, **kw)
        got = ring_wavefront_dp(gpu, *ops, **kw)
        assert set(got) == set(want)
        for key in want:
            assert torch.equal(got[key], want[key]), (kw, key)
