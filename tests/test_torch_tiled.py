"""The port's lane-tiled DP on the CPU, and the route it carries.

``praline_tpu_torch.kernels.tiled_dp.wavefront_dp_tiled`` on CPU tensors
takes its plain version, which walks the Hopper kernel's (diagonal block,
tile, step) order with its edge hand-off.  It is held bit for bit against:

- the JAX package's ``wavefront_dp_tiled`` (K6, Pallas, interpret mode) on
  the same seeded scores in K6's body layout;
- the port's plain whole-row DP ``kernels/scan.py::wavefront_dp`` over
  modes x gap series x tile widths x diagonals a visit, with both score
  sources, and at the tile widths the kernel runs on long rows;
- the 8 goldens, aligned through the tiled route with the two-kernel and
  fused lane caps lowered to 64 lanes and the tile cap lowered so that
  each golden's widest DP walks two tiles.

It also holds the kernel's default geometry (``tiled_geometry``) to the
card's limits at every lane count.  Tolerance 0.  The CUDA kernel is held
against the plain version in ``test_torch_cuda.py``.
"""

import dataclasses
import itertools
import zlib
from dataclasses import astuple
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from praline_tpu import ALPHABET_AA as JAX_ALPHABET_AA
from praline_tpu import builtin_score_matrix as jax_matrix
from praline_tpu.kernels.pallas_dp_tiled import wavefront_dp_tiled as jax_tiled
from praline_tpu_torch import ALPHABET_AA, ALPHABET_DNA, builtin_score_matrix
from praline_tpu_torch.convert import operands_from_numpy
from praline_tpu_torch.io import (
    format_alignment_clustal, format_alignment_fasta, load_sequence_fasta,
)
from praline_tpu_torch.kernels import batch, fused_dp, tiled_dp, wavefront
from praline_tpu_torch.kernels.fused_scores import mma_scratch_bytes, tier_of
from praline_tpu_torch.kernels.scan import wavefront_dp as plain_dp
from praline_tpu_torch.kernels.scores import skewed_pair_scores
from praline_tpu_torch.msa import msa_align

torch.set_num_threads(1)

TESTDATA = Path(__file__).resolve().parents[1] / "testdata"
S = jax_matrix("blosum62").as_f32()
A = JAX_ALPHABET_AA.size
MODES = ["global", "semiglobal", "local"]


def seed_of(*key):
    return zlib.crc32(repr(key).encode())


def operands(seed, B, Lx, Ly):
    """Integer-count profiles with their inverses and ragged true lengths;
    problem 0 has lx = 1 (a diagonal-1 terminal)."""
    rng = np.random.default_rng(seed)
    cx = rng.integers(0, 3, size=(B, Lx, A)).astype(np.float32)
    cy = rng.integers(0, 3, size=(B, Ly, A)).astype(np.float32)
    cx[:, :, 0] += 1
    cy[:, :, 0] += 1
    ivx = (np.float32(1.0) / cx.sum(axis=2)).astype(np.float32)
    ivy = (np.float32(1.0) / cy.sum(axis=2)).astype(np.float32)
    lx = rng.integers(1, Lx + 1, size=B).astype(np.int32)
    ly = rng.integers(1, Ly + 1, size=B).astype(np.int32)
    lx[0] = 1
    return operands_from_numpy(cx, ivx, cy, ivy, S, lx, ly, "cpu")


def tiled(source, lx, ly, gap_series, mode, traceback, **kw):
    before = dict(tiled_dp.launches)
    if tiled_dp.source_kind(source) != "hs":  # the in-place sources' tier, as the batch picks it
        kw.setdefault("tier", tier_of(source[0].numpy(), source[2].numpy(), source[4].numpy()))
    out = tiled_dp.wavefront_dp_tiled(source, lx, ly, gap_series, mode, traceback, **kw)
    assert tiled_dp.launches == before  # CPU tensors take the plain version
    return out


@pytest.mark.parametrize("gap_series,mode,traceback", [((11, 1), "global", False),
                                                       ((5,), "local", True)])
def test_plain_matches_jax_tiled_kernel(gap_series, mode, traceback):
    """K6 in interpret mode on the body layout (rows = diagonals 2.., lanes
    padded to 128), as ``tests/kernels/test_tiled.py`` feeds it.  K6 keeps
    lengths only in scores mode and state codes only with traceback."""
    ops = operands(seed_of("jax", gap_series, mode), 3, 150, 120)
    hs = skewed_pair_scores(*ops[:5]).numpy()
    D, B, Lp = hs.shape
    body = np.zeros((-(-(D - 2) // 128) * 128, B, -(-Lp // 128) * 128), np.float32)
    body[: D - 2, :, :Lp] = hs[2:]
    lx, ly = ops[5].numpy(), ops[6].numpy()
    want = jax_tiled(jnp.asarray(body), jnp.asarray(lx), jnp.asarray(ly), gap_series=gap_series,
                     mode=mode, traceback=traceback, steps_per_visit=8, total_d=D,
                     interpret=True)
    got = tiled(ops[:5], ops[5], ops[6], gap_series, mode, traceback, tile_lanes=64,
                steps_per_visit=8)
    keys = ("score", "ti", "tj") + (("tcode",) if traceback else ("length",))
    for key in keys:
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    if traceback:
        assert np.array_equal(got["tb"].numpy(), np.asarray(want["tb"])[: D - 2, :, :Lp])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gap_series", [(11, 1), (13, 7, 1), (5,)])
@pytest.mark.parametrize("traceback", [False, True])
def test_plain_matches_whole_row_plain_dp(mode, gap_series, traceback):
    """Tile widths 32 and 48 (a ragged last tile of 61 lanes either way)
    and 1, 7 and 32 diagonals a visit (the 108 steps: 32 does not divide
    them, 1 does); the in-place source once."""
    ops = operands(seed_of("plain", mode, gap_series), 3, 60, 47)
    hs = skewed_pair_scores(*ops[:5])
    want = plain_dp(hs, ops[5], ops[6], gap_series, mode, traceback)
    runs = [(hs, w, t) for w, t in itertools.product((32, 48), (1, 7, 32))] + [(ops[:5], 32, 5)]
    for source, w, t in runs:
        got = tiled(source, ops[5], ops[6], gap_series, mode, traceback, tile_lanes=w,
                    steps_per_visit=t)
        assert set(got) == set(want)
        for key in want:
            assert torch.equal(got[key], want[key]), (w, t, key)


def test_default_tiles_are_balanced_and_warp_wide():
    """The default cluster spreads a row over up to 16 CTAs of one tile
    where it can (no narrower than 256 lanes), then takes tiles of 512."""
    geo = lambda Lp, **kw: astuple(tiled_dp.tiled_geometry(Lp, 2, **kw))[:3]
    assert geo(200, tile_lanes=48) == (5, 1, 48)
    assert geo(200, ctas=3) == (3, 1, 96)
    assert [geo(Lp) for Lp in (2, 1024, 1025, 4097, 4601, 4957, 8192, 8193, 40000)] == [
        (1, 1, 256), (4, 1, 256), (5, 1, 256), (15, 1, 288), (16, 1, 288), (16, 1, 320),
        (16, 1, 512), (15, 2, 288), (16, 5, 512)]
    assert [tiled_dp.carry_values(k) for k in (1, 2, 3, 15)] == [14, 14, 22, 70]


EDGES = sorted({e for R in range(1, 17) for m in (1, 2, 3)
                for e in (512 * R * m, 512 * R * m + 1, 256 * R, 256 * R + 1)})


@pytest.mark.parametrize("source", tiled_dp.SOURCES)
@pytest.mark.parametrize("k", [1, 2, 3, 15])
def test_geometry_fits_the_card_at_every_lane_count(k, source):
    """Lp from 2 to 40,000 (sampled, with the edges 512 R m and 256 R and
    one past each): a cluster of at most 16 CTAs of warp-wide tiles of at
    most 512 lanes covering the row, no CTA without lanes, two CTAs or more
    past 512 lanes, boxes of 32 diagonals, and shared memory within the
    H100's 232,448 bytes a CTA, with the carries in it where they fit."""
    for Lp in sorted(set(range(2, 40_001, 97)) | set(EDGES)):
        g = tiled_dp.tiled_geometry(Lp, k, source)
        assert 1 <= g.R <= tiled_dp.MAX_CTAS and g.m >= 1 and g.T == 32
        assert g.W % 32 == 0 and 32 <= g.W <= tiled_dp.MAX_TILE_LANES
        assert g.R * g.m * g.W >= Lp > (g.R - 1) * g.m * g.W
        assert g.R >= 2 or Lp <= 512
        assert g.m == -(-Lp // (tiled_dp.MAX_CTAS * tiled_dp.MAX_TILE_LANES))
        assert g.smem_bytes <= tiled_dp.SMEM_PER_CTA
        base, in_smem = tiled_dp.smem_layout(g.W, g.T, 1, k, source)
        carries = tiled_dp.carry_values(k) * g.m * g.W * 4
        assert g.carry_scratch == (g.m > 1 and base + carries > tiled_dp.SMEM_PER_CTA)
        assert g.smem_bytes == base + (carries if g.m > 1 and not g.carry_scratch else 0)
    with pytest.raises(ValueError):
        tiled_dp.tiled_geometry(10, k, "both")


H100_SM_SMEM = 233_472  # shared memory an SM of the H100 holds


def clusters_held(g):
    """Clusters the H100 holds at once, as the card answered for K6 over hs
    (PERF_ARCHIVE.md, S7: 7 clusters of 10 to 16 CTAs; 30, 22, 17 and 15 of
    4 to 7), for tests without a card."""
    return {4: 30, 5: 22, 6: 17, 7: 15}.get(g.R, 7 if g.R >= 8 else int(110 / g.R))


@pytest.fixture
def h100(monkeypatch):
    """The chooser's view of the card without one: the H100's cluster
    counts (:func:`clusters_held`) and its shared memory an SM."""
    monkeypatch.setattr(tiled_dp, "max_active_clusters",
                        lambda k, source, g, ckpt=False, tier=None: clusters_held(g))
    monkeypatch.setattr(tiled_dp, "sm_shared_memory", lambda: H100_SM_SMEM)


def chunk_cost(g, B, D):
    """The chooser's model of a chunk of B problems of D diagonals on g:
    waves x steps x (W + the step's fixed part in lanes)."""
    steps = (-(-(D - 2) // g.T) + g.R - 1) * g.m * g.T
    return -(-B // clusters_held(g)) * steps * (g.W + tiled_dp.STEP_FIXED_LANES)


@pytest.mark.parametrize("Lp,k,source,B,traceback", [
    (4736, 2, "hs", 1, False), (4736, 2, "hs", 21, True), (4736, 15, "hs", 21, False),
    (4736, 4, "hs", 32, False), (4736, 2, "rows", 21, False), (4736, 2, "composite", 32, False),
    (4736, 2, "hs", 7, False), (4224, 3, "hs", 5, False), (8193, 2, "hs", 2, True)])
def test_chunk_geometry_is_todays_where_lanes_do_not_apply(h100, Lp, k, source, B, traceback):
    """One problem, a traceback, more than three levels, the in-place
    sources, and a chunk the card holds in one wave keep the one-lane
    geometry, field for field."""
    today = tiled_dp.tiled_geometry(Lp, k, source)
    assert today.Q == 1
    got = tiled_dp.tiled_geometry(Lp, k, source, problems=B, traceback=traceback,
                                  diagonals=2 * Lp - 1)
    assert got == today


@pytest.mark.parametrize("B", [21, 24, 28, 32])
@pytest.mark.parametrize("Lp", [4224, 4480, 4736])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_chunk_geometry_takes_lanes_past_one_wave(h100, Lp, B, k):
    """A scores chunk over hs of more problems than the card holds one-lane
    clusters at once (dhc1's all-pairs chunks, B 21-32 at Lp 4224-4736)
    takes Q > 1 lanes a thread: one tile a CTA covering the row, warp-wide
    in threads of at most 512, shared memory within the H100's 232,448
    bytes, and no candidate nor the one-lane geometry of a smaller modelled
    time."""
    D = Lp + 4607 + 1
    g = tiled_dp.tiled_geometry(Lp, k, problems=B, diagonals=D)
    assert g.Q in tiled_dp.LANES_PER_THREAD and g.m == 1 and not g.carry_scratch
    assert g.W % (32 * g.Q) == 0 and g.W // g.Q <= tiled_dp.MAX_TILE_LANES
    assert g.R * g.W >= Lp > (g.R - 1) * g.W and 1 <= g.T <= tiled_dp.MAX_STEPS
    assert g.smem_bytes == tiled_dp.smem_layout(g.W, g.T, 1, k, "hs", lanes=g.Q)[0]
    assert g.smem_bytes <= tiled_dp.SMEM_PER_CTA == 232_448
    assert tiled_dp.smem_layout(g.W, g.T + 1, 1, k, "hs", lanes=g.Q)[0] > 232_448 \
        or g.T == tiled_dp.MAX_STEPS
    cands = tiled_dp.lanes_candidates(Lp, k, H100_SM_SMEM)
    assert g in cands and all(2 * (c.smem_bytes + 1024) > H100_SM_SMEM for c in cands)
    assert chunk_cost(g, B, D) == min(chunk_cost(c, B, D) for c in cands)
    assert chunk_cost(g, B, D) < chunk_cost(tiled_dp.tiled_geometry(Lp, k), B, D)


@pytest.mark.parametrize("kw", [dict(Q=2, W=96), dict(Q=3, W=1632), dict(Q=4, W=128),
                                dict(Q=2, W=768, m=2, R=2)])
def test_check_geometry_refuses_lanes_the_kernel_does_not_take(kw):
    """W a multiple of 32 Q up to 512 Q, Q in 1..3, one tile a CTA at Q > 1;
    Q > 1 only in scores mode on hs at k <= 3."""
    ok = tiled_dp.TiledGeometry(R=4, m=1, W=768, T=32, smem_bytes=0, carry_scratch=False, Q=2)
    with pytest.raises(ValueError):
        tiled_dp.check_geometry(dataclasses.replace(ok, **kw), 3000, 2, "hs", False)
    tiled_dp.check_geometry(ok, 3000, 2, "hs", False)
    for args in ((3000, 2, "hs", True), (3000, 4, "hs", False), (3000, 2, "rows", False)):
        with pytest.raises(ValueError, match="lanes a thread"):
            tiled_dp.check_geometry(ok, *args)
    for args in ((3000, 2, "hs", True), (3000, 4, "hs", False), (3000, 2, "rows", False)):
        with pytest.raises(ValueError, match="lanes a thread"):
            tiled_dp.check_geometry(ok, *args)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("lanes,W", [(2, 64), (2, 128), (3, 96), (3, 288)])
def test_plain_at_lane_tile_widths_matches_whole_row(mode, lanes, W):
    """The plain version at the tile widths of Q lanes a thread (multiples
    of 32 Q, a ragged last tile), gap series of 1, 2 and 3 levels, scores
    and traceback: the whole-row plain DP's bits."""
    ops = operands(seed_of("lanes", mode, lanes, W), 3, 200, 150)
    hs = skewed_pair_scores(*ops[:5])
    for gap_series in ((5,), (11, 1), (13, 7, 1)):
        for traceback in (False, True):
            want = plain_dp(hs, ops[5], ops[6], gap_series, mode, traceback)
            got = tiled(hs, ops[5], ops[6], gap_series, mode, traceback, tile_lanes=W,
                        steps_per_visit=7)
            for key in want:
                assert torch.equal(got[key], want[key]), (gap_series, traceback, key)


@pytest.mark.parametrize("W,Lx,mode,traceback", [(320, 700, "local", True),
                                                 (496, 1020, "semiglobal", False)])
def test_plain_at_the_card_tile_widths_matches_jax_and_whole_row(W, Lx, mode, traceback):
    """The tile widths the kernel runs on long rows (320 and 496 lanes),
    each with a ragged last tile, against K6 in interpret mode and the
    whole-row plain DP."""
    ops = operands(seed_of("card widths", W), 2, Lx, 30)
    hs = skewed_pair_scores(*ops[:5])
    D, B, Lp = hs.shape
    assert Lp % W and Lp // W >= 2  # ragged, past one tile
    body = np.zeros((-(-(D - 2) // 128) * 128, B, -(-Lp // 128) * 128), np.float32)
    body[: D - 2, :, :Lp] = hs.numpy()[2:]
    jax_want = jax_tiled(jnp.asarray(body), jnp.asarray(ops[5].numpy()),
                         jnp.asarray(ops[6].numpy()), gap_series=(11, 1), mode=mode,
                         traceback=traceback, steps_per_visit=8, total_d=D, interpret=True)
    want = plain_dp(hs, ops[5], ops[6], (11, 1), mode, traceback)
    for source in (hs, ops[:5]):
        got = tiled(source, ops[5], ops[6], (11, 1), mode, traceback, tile_lanes=W)
        for key in want:
            assert torch.equal(got[key], want[key]), key
        for key in ("score", "ti", "tj") + (("tcode",) if traceback else ("length",)):
            assert np.array_equal(got[key].numpy(), np.asarray(jax_want[key])), key
        if traceback:
            assert np.array_equal(got["tb"].numpy(), np.asarray(jax_want["tb"])[: D - 2, :, :Lp])


def test_tiled_ablation_variant_applies_to_the_kernel_source():
    """``tiled_ablation``'s "direct" variant replaces the hs visits (and
    nothing else) of ``csrc/tiled_dp.cu``, the include of
    ``csrc/hs_visits.cuh``; "kernel" is the source as is."""
    from praline_tpu_torch import tiled_ablation

    source = tiled_ablation.SOURCE.read_text()
    assert tiled_ablation.variant_source("kernel") == source
    direct = tiled_ablation.variant_source("direct")
    assert direct.count("struct HsVisits {") == 1 and tiled_ablation.DIRECT_VISITS in direct
    visits = (tiled_ablation.SOURCE.parent / "hs_visits.cuh").read_text()
    assert "copy_wait_group<1>" in visits and "copy_wait_group<1>" not in direct
    head, tail = source.split(tiled_ablation.INCLUDE)
    assert direct == head + tiled_ablation.DIRECT_VISITS + tail


def test_outputs_into_out_on_the_plain_path():
    ops = operands(seed_of("out"), 2, 40, 30)
    want = plain_dp(skewed_pair_scores(*ops[:5]), ops[5], ops[6], (11, 1), "local", True)
    out = {k: torch.full_like(v, -7) for k, v in want.items()}
    got = tiled(ops[:5], ops[5], ops[6], (11, 1), "local", True, out=out, ctas=2)
    assert got is out
    for key in want:
        assert torch.equal(out[key], want[key]), key
    with pytest.raises(ValueError, match="out must hold"):
        tiled(ops[:5], ops[5], ops[6], (11, 1), "local", False, out=out)


@pytest.mark.parametrize("traceback", [False, True])
@pytest.mark.parametrize("bx,by", [(4096, 4096), (4645, 4683), (5889, 120)])
def test_rows_past_the_fused_cap_take_the_tiled_route(bx, by, traceback):
    """The hs source where one problem's hs fits its budget, else scores
    in place; rows of 4096 lanes or fewer keep their routes."""
    for dev in ("cuda", "cpu"):
        assert batch.choose_route(dev, bx, by, traceback) == "tiled"
        assert batch.choose_route(dev, fused_dp.MAX_LANES_FUSED - 1, by, traceback) == "fused"
    assert batch.tiled_source(bx, by, "cpu") == "hs"
    assert batch.tiled_source(bx, batch.HS_BYTES_BUDGET // (4 * (bx + 1)), "cpu") == "rows"


def test_giant_traceback_on_the_tiled_route_still_raises():
    """It no longer raises: traceback bytes past their budget on the tiled
    route's shape run checkpointed on the same kernel, on a card as on the
    CPU; just under the budget the full traceback stays."""
    by = batch.TB_BYTES_BUDGET // 5000
    assert batch.choose_route("cuda", 4999, by, False) == "tiled"
    for dev in ("cuda", "cpu"):
        assert batch.choose_route(dev, 4999, by, True) == "checkpointed"
        fits = batch.TB_BYTES_BUDGET // 5000 - 4998  # (4999 + fits - 1) 5000 bytes
        assert batch.choose_route(dev, 4999, fits, True) == "tiled"


def test_chunk_sizing_counts_the_carry_scratch():
    A_ = 23
    hs_bytes, tb_bytes = batch.per_problem_bytes(4600, 4400)
    carry = tiled_dp.carry_values(fused_dp.MAX_LEVELS) * 4601 * 4
    operands_bytes = (4600 + 4400) * (A_ + 1) * 4
    got = batch.chunk_problem_bytes("tiled", "cuda", 4600, 4400, A_, True)
    # the hs source: hs and the tensor-core producer's scratch
    scratch = mma_scratch_bytes(1, 4600, 4400)
    assert got == operands_bytes + hs_bytes + scratch + carry + 2 * tb_bytes
    by = batch.HS_BYTES_BUDGET // (4 * 4601)  # the rows source: no hs on the card
    rows = batch.chunk_problem_bytes("tiled", "cuda", 4600, by, A_, False)
    assert rows == (4600 + by) * (A_ + 1) * 4 + (4600 + by) * 24 * 4 + carry


# (matrix, config kwargs, tile cap): each cap cuts the golden's widest DP
# (its longest merged profile) into two tiles.
GOLDENS = {
    ("family10", "default"): ("blosum62", {}, 64),
    ("family10", "ppglobal"): ("blosum62", dict(preprofile_mode="global"), 64),
    ("family10", "series3_local"): ("blosum62", dict(
        gap_series=(13, 7, 1), distance_mode="local", linkage="complete"), 64),
    ("family16div", "default"): ("blosum62", {}, 96),
    ("family16div", "pam250_semi_pplocal"): ("pam250", dict(
        merge_mode="semiglobal", preprofile_mode="local", gap_series=(10, 2), linkage="single"), 96),
    ("dna8", "default"): ("dna_simple", dict(
        gap_series=(8, 2), alphabet="dna", score_matrix="dna_simple"), 64),
    ("family64", "default"): ("blosum62", {}, 64),
    ("family64", "semi_series3"): ("blosum62", dict(
        gap_series=(12, 6, 1), merge_mode="semiglobal", linkage="average"), 512),
}


@pytest.mark.parametrize("family,tag", sorted(GOLDENS))
def test_goldens_through_the_tiled_route(monkeypatch, family, tag):
    from praline_tpu_torch import PralineConfig

    monkeypatch.setattr(wavefront, "MAX_LANES", 64)
    monkeypatch.setattr(batch, "MAX_LANES_FUSED", 64)
    matrix_name, kw, tile_cap = GOLDENS[(family, tag)]
    monkeypatch.setattr(tiled_dp, "MAX_TILE_LANES", tile_cap)
    monkeypatch.delenv(batch.FUSED_DP_ENV, raising=False)
    widest = []
    plain = tiled_dp.wavefront_dp_tiled_plain

    def spy(source, lx, ly, *args, **options):
        widest.append(int(lx.max()) + 1)
        return plain(source, lx, ly, *args, **options)

    monkeypatch.setattr(tiled_dp, "wavefront_dp_tiled_plain", spy)
    alphabet = ALPHABET_DNA if family == "dna8" else ALPHABET_AA
    seqs = load_sequence_fasta(TESTDATA / f"{family}.fasta", alphabet)
    batch.reset_route_counts()
    aln = msa_align(seqs, builtin_score_matrix(matrix_name), PralineConfig(**kw), device="cpu")
    assert format_alignment_fasta(aln) == (TESTDATA / f"{family}.{tag}.golden.fasta").read_text()
    assert format_alignment_clustal(aln) == (TESTDATA / f"{family}.{tag}.golden.aln").read_text()
    assert batch.route_counts["tiled"] > 0 and batch.route_counts["fused"] == 0
    assert max(widest) > tile_cap  # the widest DP walked two tiles or more
