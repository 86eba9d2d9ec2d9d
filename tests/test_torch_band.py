"""The whole-row DP's band walk against the JAX package, bit for bit.

In scores mode the Hopper DP over ``hs`` (``csrc/wavefront_dp.cu``) runs
only the visits and steps of each problem's band (``csrc/cluster_walk.cuh``
BAND).  Its plain twin, ``kernels/tiled_dp.py::wavefront_dp_tiled_plain(...,
band=True)``, walks the same visits with every edge slot that no step wrote
poisoned; here it is held against the JAX package's plain DP
(``praline_tpu.kernels.scan.wavefront_dp``), K4 ``wavefront_dp_pallas`` and
K2 ``wavefront_dp_strip`` (interpret mode) over every mode, ragged lengths
and the band's edges (both lengths 1, lx << ly, lx >> ly, lx = Lp - 1, and
tiles that leave the band at a box's first diagonal), at narrow tiles and
short boxes.  Also: ``dp_geometry``'s choice, the geometries' shapes and
checks, and ``lane_slots`` against a count of the walk.  Tolerance 0.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from praline_tpu import ALPHABET_AA, builtin_score_matrix
from praline_tpu.kernels.pallas_dp import wavefront_dp_pallas
from praline_tpu.kernels.scan import wavefront_dp as jax_dp
from praline_tpu.kernels.scores import skewed_pair_scores as jax_skewed
from praline_tpu.kernels.strip import strip_dispatch_core, strip_stride
from praline_tpu_torch.kernels import wavefront
from praline_tpu_torch.kernels.fused_dp import SMEM_PER_CTA
from praline_tpu_torch.kernels.tiled_dp import wavefront_dp_tiled_plain

torch.set_num_threads(1)

B62 = builtin_score_matrix("blosum62")
A = ALPHABET_AA.size
MODES = ["global", "semiglobal", "local"]
KEYS = ("score", "length", "ti", "tj", "tcode")
# (lx, ly) at bucket 40 x 40: both lengths 1, lx << ly, lx >> ly, lx = Lp -
# 1 with ly full, and ly = 2 mod 4, with which every full tile of 8 or 16
# lanes leaves the band at the first diagonal of a box of 4 (ie + ly + 1 =
# 2 mod 4), so that the next tile's first lane enters the last column there.
EDGES = ((1, 1), (1, 40), (40, 1), (3, 35), (38, 2), (40, 40), (20, 6), (17, 10), (9, 2),
         (33, 14))


def workload(seed, B, bx, by, edges=()):
    rng = np.random.default_rng(seed)
    cx = rng.integers(0, 3, size=(B, bx, A)).astype(np.float32)
    cy = rng.integers(0, 3, size=(B, by, A)).astype(np.float32)
    cx[:, :, 0] += 1
    cy[:, :, 0] += 1
    ivx = (np.float32(1.0) / cx.sum(axis=2)).astype(np.float32)
    ivy = (np.float32(1.0) / cy.sum(axis=2)).astype(np.float32)
    lx = rng.integers(1, bx + 1, size=B).astype(np.int32)
    ly = rng.integers(1, by + 1, size=B).astype(np.int32)
    for b, (x, y) in enumerate(edges):
        lx[b], ly[b] = x, y
    hs = np.array(jax_skewed(cx, ivx, cy, ivy, B62.as_f32()))
    return cx, ivx, cy, ivy, lx, ly, hs


def band(hs, lx, ly, gap_series, mode, W, T):
    out = wavefront_dp_tiled_plain(torch.from_numpy(hs), torch.from_numpy(lx),
                                   torch.from_numpy(ly), gap_series, mode, False,
                                   tile_lanes=W, steps_per_visit=T, band=True)
    return {k: v.numpy() for k, v in out.items()}


def seed_of(*key):
    return zlib.crc32(repr(key).encode())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gap_series", [(11, 1), (13, 7, 1), (5,)])
def test_band_walk_matches_jax_scan(mode, gap_series):
    """Ragged lengths at 8-lane tiles and boxes of 4, and 16-lane tiles
    and boxes of 3."""
    _, _, _, _, lx, ly, hs = workload(seed_of("scan", mode, gap_series), 6, 40, 60, EDGES[:2])
    want = jax_dp(jnp.asarray(hs), jnp.asarray(lx), jnp.asarray(ly),
                  gap_series=gap_series, mode=mode)
    for W, T in ((8, 4), (16, 3)):
        got = band(hs, lx, ly, gap_series, mode, W, T)
        assert set(got) == set(want)
        for key in got:
            assert np.array_equal(got[key], np.asarray(want[key])), (W, T, key)


@pytest.mark.parametrize("mode", MODES)
def test_band_edges_match_pallas_classic(mode):
    """K4 in interpret mode over the band's edges, scores mode (its lengths
    on), and the JAX plain DP for the state codes."""
    _, _, _, _, lx, ly, hs = workload(seed_of("classic", mode), len(EDGES), 40, 40, EDGES)
    want = wavefront_dp_pallas(jnp.asarray(hs), jnp.asarray(lx), jnp.asarray(ly),
                               gap_series=(11, 1), mode=mode, lengths=True, interpret=True)
    codes = jax_dp(jnp.asarray(hs), jnp.asarray(lx), jnp.asarray(ly), gap_series=(11, 1),
                   mode=mode)["tcode"]
    for W, T in ((8, 4), (16, 4)):
        got = band(hs, lx, ly, (11, 1), mode, W, T)
        for key in ("score", "length", "ti", "tj"):
            assert np.array_equal(got[key], np.asarray(want[key])), (W, T, key)
        assert np.array_equal(got["tcode"], np.asarray(codes)), (W, T)


@pytest.mark.parametrize("mode", MODES)
def test_band_edges_match_pallas_strip(mode):
    """K1 + K2 in interpret mode (strip producer and strip DP, R = 4
    problems a row) over the band's edges."""
    B, bx, by, R = 12, 40, 40, 4
    cx, ivx, cy, ivy, lx, ly, hs = workload(seed_of("strip", mode), B, bx, by, EDGES)
    want = strip_dispatch_core(
        jnp.asarray(cx), jnp.asarray(ivx), jnp.asarray(cy), jnp.asarray(ivy),
        jnp.asarray(B62.as_f32()), jnp.asarray(lx), jnp.asarray(ly),
        K=strip_stride(bx, by), R=R, gap_series=(13, 7, 1), mode=mode, qd=None,
        interpret=True,
    )
    got = band(hs, lx, ly, (13, 7, 1), mode, 8, 4)
    for key in ("score", "length", "ti", "tj"):
        assert np.array_equal(got[key], np.asarray(want[key]).reshape(B)), key


@pytest.mark.parametrize("mode", MODES)
def test_band_edges_deep_series(mode):
    """k = 15 and k = 4 over the band's edges against the JAX plain DP."""
    _, _, _, _, lx, ly, hs = workload(seed_of("deep", mode), len(EDGES), 40, 40, EDGES)
    for series in (tuple(range(30, 0, -2)), (9, 5, 3, 1)):
        want = jax_dp(jnp.asarray(hs), jnp.asarray(lx), jnp.asarray(ly), gap_series=series,
                      mode=mode)
        got = band(hs, lx, ly, series, mode, 8, 4)
        for key in KEYS:
            assert np.array_equal(got[key], np.asarray(want[key])), (series, key)


def test_band_has_no_effect_with_traceback():
    """Traceback mode walks every lane: the band flag changes nothing."""
    _, _, _, _, lx, ly, hs = workload(seed_of("tb"), 4, 30, 30, EDGES[:4])
    args = (torch.from_numpy(hs), torch.from_numpy(lx), torch.from_numpy(ly), (11, 1), "local",
            True)
    a = wavefront_dp_tiled_plain(*args, tile_lanes=8, steps_per_visit=4, band=True)
    b = wavefront_dp_tiled_plain(*args, tile_lanes=8, steps_per_visit=4)
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_geometries_cover_the_row():
    for Lp in (2, 33, 128, 129, 1024, 2048):
        tiles = -(-Lp // 128)
        for k in (1, 2, 3, 15):
            thr = wavefront.geometry("throughput", Lp, k)
            assert (thr.R, thr.W, thr.m) == (1, 128, tiles)
            assert thr.carry_scratch == (tiles > 1)
            lat = wavefront.geometry("latency", Lp, k)
            assert (lat.R, lat.W, lat.m, lat.carry_scratch) == (tiles, 128, 1, False)
            for g in (thr, lat, wavefront.geometry("latency", Lp, k, ctas=2)):
                wavefront.check_geometry(g, Lp)
                assert g.smem_bytes <= SMEM_PER_CTA and g.R * g.m * g.W >= Lp
    # the carries of m > 1 tiles wait in the scratch, so a CTA's shared
    # memory does not grow with its tiles
    for k in (1, 2, 3, 15):
        assert wavefront.geometry("throughput", 2048, k).smem_bytes == \
            wavefront.geometry("throughput", 128, k).smem_bytes
    g = wavefront.geometry("latency", 1024, 2, ctas=3)
    assert (g.R, g.m) == (3, 3)


def test_check_geometry_refuses_what_the_kernel_does_not_take():
    for g in (wavefront.geometry("throughput", 64, 2, tile_lanes=256),
              wavefront.geometry("throughput", 64, 2, tile_lanes=48),
              wavefront.geometry("latency", 64, 2, tile_lanes=32, ctas=17),
              wavefront.geometry("throughput", 64, 2, steps=33),
              wavefront.geometry("throughput", 64, 2, min_blocks=3)):
        with pytest.raises(ValueError):
            wavefront.check_geometry(g, 64)


def test_dp_geometry_spreads_a_chunk_over_the_idle_sms():
    """With the H100's occupancy at bucket 1023 and 2047 (k = 2): 660 CTAs
    of one problem each at five CTAs an SM, 528 at four; clusters of 2, 8
    and 16 CTAs at four an SM: 264, 62 and 28."""
    asked = set()

    def clusters(k, g):
        asked.add((k, g.R, g.min_blocks))
        if g.R == 1:
            return 660 if g.min_blocks == 5 else 528
        return {2: 264, 8: 62, 16: 28}.get(g.R, 0) if g.min_blocks == 4 else 80

    def shape(B, Lp, k=2):
        g = wavefront.dp_geometry(B, Lp, k, False, clusters=clusters)
        assert wavefront.dp_geometry(B, Lp, k, True, clusters=clusters) == g
        return g.kind, g.R, g.m, g.W, g.min_blocks, g.carry_scratch

    assert shape(2945, 1024) == ("throughput", 1, 8, 128, 5, True)
    assert shape(256, 1024) == ("latency", 2, 4, 128, 4, True)
    assert shape(200, 1024) == ("latency", 3, 3, 128, 5, True)
    assert shape(64, 1024) == ("latency", 8, 1, 128, 5, False)
    assert shape(4, 1024) == ("latency", 8, 1, 128, 4, False)
    assert shape(1, 1024) == ("latency", 8, 1, 128, 4, False)
    assert shape(64, 2048) == ("latency", 16, 1, 128, 5, False)
    assert shape(4, 64) == ("throughput", 1, 1, 128, 5, False)
    # past three levels the build for four CTAs an SM, which does not spill
    assert shape(2945, 1024, 15) == ("throughput", 1, 8, 128, 4, True)
    assert shape(1, 1024, 15) == ("latency", 8, 1, 128, 4, False)
    assert (2, 1, 5) in asked and (15, 1, 4) in asked
    # a card that holds fewer CTAs than the chunk has problems: one a problem
    assert wavefront.dp_geometry(3, 1024, 2, False, clusters=lambda k, g: 2).R == 1


def walk_count(lx, ly, D, Lp, W, T):
    """Lane slots of the band walk, visit by visit."""
    total = 0
    for x, y in zip(lx, ly):
        dend, lane_end = min(x + y, D - 1), min(x, Lp - 1)
        for d0 in range(2, dend + 1, T):
            d1 = min(d0 + T - 1, dend)
            for i0 in range(0, lane_end + 1, W):
                ie = min(i0 + W - 1, lane_end)
                first, last = max(d0, i0), min(d1, ie + y + 1)
                if first <= min(d1, ie + y):
                    total += (last - first + 1) * W
    return total


def test_lane_slots_count_the_band_walk():
    rng = np.random.default_rng(seed_of("slots"))
    for Lp, W, T in ((1024, 128, 32), (200, 32, 8), (301, 64, 5)):
        L = Lp - 1
        lx = rng.integers(1, L + 1, 20)
        ly = rng.integers(1, L + 1, 20)
        lx[0], ly[1], ly[2] = L, 34, 2
        g = wavefront.geometry("throughput", Lp, 2, tile_lanes=W, steps=T)
        assert wavefront.lane_slots(lx, ly, 2 * L + 1, Lp, g, False) == \
            walk_count(lx, ly, 2 * L + 1, Lp, W, T)
        assert wavefront.lane_slots(lx, ly, 2 * L + 1, Lp, g, True) == \
            20 * -(-Lp // W) * W * (2 * L - 1)


def test_slots_count_only_the_kernels_walk():
    """The lane-slot counter measures the kernel's walk: the plain DP on
    the CPU has none to count and refuses it."""
    _, _, _, _, lx, ly, hs = workload(seed_of("slots-cpu"), 2, 8, 8)
    with pytest.raises(ValueError):
        wavefront.wavefront_dp(torch.from_numpy(hs), torch.from_numpy(lx), torch.from_numpy(ly),
                               slots=torch.zeros(1, dtype=torch.int64))
