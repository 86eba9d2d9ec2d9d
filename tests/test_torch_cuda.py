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

import zlib

import numpy as np
import pytest
import torch

from praline_tpu_torch import ALPHABET_AA, Profile, builtin_score_matrix
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
    """Buckets past 2047 are the fused kernel's (the batch driver routes
    them there); the two-kernel DP refuses them."""
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


def tiled_vs_plain(source, lx, ly, gap_series, mode, traceback, want, **kw):
    before = tiled_dp.launches
    got = tiled_dp.wavefront_dp_tiled(source, lx, ly, gap_series, mode, traceback, **kw)
    torch.cuda.synchronize()
    assert tiled_dp.launches == before + 1
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), (kw, key)


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


@pytest.mark.parametrize("mode", ["global", "local"])
def test_tiled_rows_past_the_fused_cap(cuda, mode):
    """Lp 4201, the default tiles (5 of 864 lanes), both sources."""
    ops = operands(4200 + len(mode), 1, 4200, 300, cuda)
    hs = plain_scores(*ops[:5])
    for traceback in (False, True):
        want = plain_dp(hs, ops[5], ops[6], (11, 1), mode, traceback)
        tiled_vs_plain(hs, ops[5], ops[6], (11, 1), mode, traceback, want)
        tiled_vs_plain(ops[:5], ops[5], ops[6], (11, 1), mode, traceback, want)


def test_tiled_refuses_what_it_does_not_take(cuda):
    ops = operands(5, 1, 100, 50, cuda)
    for kw in (dict(tile_lanes=48), dict(tile_lanes=2048), dict(steps_per_visit=33)):
        with pytest.raises(ValueError):
            tiled_dp.wavefront_dp_tiled(ops[:5], ops[5], ops[6], **kw)


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
