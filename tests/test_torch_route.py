"""The batch driver's route choice, and the repair it carries.

Before the fused kernel the port refused, on a card, every bucket past
2047 and every ``hs`` tensor past its budget; the JAX package aligns
them.  ``choose_route`` now sends them to the fused producer + DP, and
rows past the fused kernel's own lane cap to the tiled DP
(``tests/test_torch_tiled.py``); only a traceback past its byte budget
is still refused on a card.  ``PRALINE_FUSED_DP`` decides only where both
the two-kernel and the fused route take the shape.  With the two-kernel lane
cap lowered to 64 lanes, two golden configurations run most of their DPs
through the fused route on the CPU and stay byte-equal.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from praline_tpu import ALPHABET_AA as JAX_AA
from praline_tpu import Profile as JaxProfile
from praline_tpu import builtin_score_matrix as jax_matrix
from praline_tpu.kernels.batch import align_pairs_batched as jax_batched
from praline_tpu.oracle import align_profiles as jax_align_profiles
from praline_tpu_torch import ALPHABET_AA, PralineConfig, Profile, builtin_score_matrix
from praline_tpu_torch.convert import profile_from_arrays
from praline_tpu_torch.io import (
    format_alignment_clustal, format_alignment_fasta, load_sequence_fasta,
)
from praline_tpu_torch.kernels import batch, fused_dp, wavefront
from praline_tpu_torch.kernels.fused_dp import MAX_LANES_FUSED, MAX_LEVELS
from praline_tpu_torch.kernels.fused_scores import mma_scratch_bytes
from praline_tpu_torch.kernels.tiled_dp import carry_values
from praline_tpu_torch.msa import msa_align

torch.set_num_threads(1)

TESTDATA = Path(__file__).resolve().parents[1] / "testdata"
ROUTE = batch.choose_route


@pytest.fixture(autouse=True)
def knob_unset(monkeypatch):
    monkeypatch.delenv(batch.FUSED_DP_ENV, raising=False)


@pytest.mark.parametrize("traceback", [False, True])
@pytest.mark.parametrize("bx,by", [(2047, 2047), (2048, 31), (3417, 3417), (4095, 100)])
def test_rows_past_the_two_kernel_cap_take_the_fused_route(bx, by, traceback):
    route = ROUTE("cuda", bx, by, traceback)
    assert route == ("fused" if bx + 1 > wavefront.MAX_LANES else "two_kernel")


def test_hs_past_its_budget_takes_the_fused_route():
    hs_bytes, _ = batch.per_problem_bytes(1023, 300_000)
    assert hs_bytes > batch.HS_BYTES_BUDGET
    assert ROUTE("cuda", 1023, 300_000, False) == "fused"
    assert ROUTE("cuda", 1023, 200_000, False) == "two_kernel"


@pytest.mark.parametrize("traceback", [False, True])
def test_past_the_fused_cap_a_card_refuses(traceback):
    """It no longer refuses: rows past the fused kernel's lane cap take the
    tiled kernel, on a card as on the CPU."""
    cap = MAX_LANES_FUSED
    assert ROUTE("cuda", cap - 1, 100, traceback) == "fused"
    for dev in ("cuda", "cpu"):
        assert ROUTE(dev, cap, 100, traceback) == "tiled"


def test_giant_traceback_needs_the_checkpointed_route():
    """Traceback bytes past their budget on the fused route's shape take
    the checkpointed route on the tiled kernel, on a card as on the CPU
    (no card here: the budgets stay as written)."""
    by = batch.TB_BYTES_BUDGET // 4096 + 10
    assert ROUTE("cuda", 4095, by, False) == "fused"
    for dev in ("cuda", "cpu"):
        assert ROUTE(dev, 4095, by, True) == "checkpointed"
    fits = batch.TB_BYTES_BUDGET // 4096 - 4094  # (4095 + fits - 1) 4096 bytes
    assert ROUTE("cuda", 4095, fits, True) == "fused"
    assert ROUTE("cuda", 4095, fits + 1, True) == "checkpointed"


@pytest.mark.parametrize("knob,want", [("1", "fused"), ("0", "two_kernel"), (None, "two_kernel")])
@pytest.mark.parametrize("traceback", [False, True])
def test_knob_decides_only_where_both_routes_take_the_shape(monkeypatch, knob, want, traceback):
    if knob is not None:
        monkeypatch.setenv(batch.FUSED_DP_ENV, knob)
    for dev in ("cuda", "cpu"):
        assert ROUTE(dev, 1023, 1023, traceback) == want
        assert ROUTE(dev, 2500, 1023, traceback) == "fused"


def test_chunk_sizing_counts_what_each_route_allocates():
    A = 23
    size = batch.chunk_problem_bytes
    two = size("two_kernel", "cuda", 1023, 1023, A, False)
    fused = size("fused", "cuda", 1023, 1023, A, False, "mma")
    hs_bytes, tb_bytes = batch.per_problem_bytes(1023, 1023)
    mma, rows = mma_scratch_bytes(1, 1023, 1023), 2046 * 24 * 4
    # on "mma" both routes count the tensor-core scratch alone (the
    # producer's, the fused kernel's): they differ by hs and the whole-row
    # DP's carry scratch (at the deepest series unless the chunk's is given)
    carries = carry_values(MAX_LEVELS) * 1024 * 4
    assert two - fused == hs_bytes + carries
    assert size("two_kernel", "cuda", 1023, 1023, A, False, levels=2) == \
        two - carries + carry_values(2) * 1024 * 4
    assert size("two_kernel", "cpu", 1023, 1023, A, False) == two - carries - mma
    # a group on "scalar" may run a chunk on either tier: the larger
    # scratch, here the fused kernel's T / Cy copies
    assert size("fused", "cuda", 1023, 1023, A, False, "scalar") == fused - mma + max(mma, rows)
    assert size("fused", "cuda", 1023, 1023, A, True, "mma") == fused + 2 * tb_bytes
    # the plain versions build hs on either route, and no tensor-core scratch
    assert size("fused", "cpu", 1023, 1023, A, False, "mma") == fused + hs_bytes - mma


def test_stepped_buckets_stop_at_the_route_caps():
    """With a largest bucket of 1000 (not 2047 mod 128), a stepped bucket
    never crosses the whole-row DP's or the fused kernel's lane cap that
    its length stays within, so every length past 1000 takes the route
    its exact size would."""
    sizes = (63, 1000)
    got = [batch._bucket(n, sizes) for n in (1001, 2040, 2047, 2048, 2100, 4090, 4095, 4096)]
    assert got == [1128, 2047, 2047, 2152, 2152, 4095, 4095, 4200]
    for n in range(1001, 5001, 7):
        b = batch._bucket(n, sizes)
        assert b >= n
        for traceback in (False, True):
            assert ROUTE("cuda", b, b, traceback) == ROUTE("cuda", n, n, traceback)


def test_lengths_past_the_largest_bucket_take_stepped_buckets():
    sizes = (63, 127, 255, 511, 1023, 2047)
    assert batch.BUCKET_STEP == 128
    got = [batch._bucket(n, sizes) for n in (1, 64, 2047, 2048, 2175, 2176, 2400, 4000)]
    assert got == [63, 127, 2047, 2175, 2175, 2303, 2431, 4095]
    assert batch._bucket(300, (127, 31)) == 383


def count_profiles(rng, lengths, dyadic=False):
    """Integer-count profiles (or, with ``dyadic``, counts of halves) as
    numpy arrays."""
    out = []
    for L in lengths:
        c = rng.integers(0, 3, size=(L, ALPHABET_AA.size)).astype(np.float32)
        c[:, 0] += 1
        out.append(c * 0.5 if dyadic else c)
    return out


def test_stepped_buckets_give_the_reference_results_in_fewer_groups(monkeypatch):
    """Lengths 17-30 past a largest bucket of 15: exact-size buckets (a
    step of 1) make a group of each pair, steps of 16 one group of 31 x
    31; both give the JAX package's results (its batched aligner, scores
    only; its oracle, with traceback)."""
    counts = count_profiles(np.random.default_rng(23), (17, 20, 24, 27, 30))
    jprofs = [JaxProfile(c, np.zeros(len(c), np.float32), JAX_AA) for c in counts]
    profs = [profile_from_arrays(c, np.zeros(len(c), np.float32), ALPHABET_AA.symbols)
             for c in counts]
    index = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0)]
    b62 = jax_matrix("blosum62")
    want = jax_batched([(jprofs[i], jprofs[j]) for i, j in index], b62, (11, 1), "local",
                       backend="xla", bucket_sizes=(15,), batch_pairs=8)
    pairs = [(profs[i], profs[j]) for i, j in index]
    groups = {}
    for step in (1, 16):
        monkeypatch.setattr(batch, "BUCKET_STEP", step)
        batch.reset_route_counts()
        kw = dict(device="cpu", bucket_sizes=(15,), batch_pairs=8)
        got = batch.align_pairs_batched(pairs, builtin_score_matrix("blosum62"), (11, 1), "local",
                                        **kw)
        groups[step] = sum(batch.route_counts.values())
        assert [(g.score, g.length, g.ti, g.tj) for g in got] == \
            [(w.score, w.length, w.ti, w.tj) for w in want]
        paths = batch.align_pairs_batched(pairs, builtin_score_matrix("blosum62"), (11, 1),
                                          "local", traceback=True, **kw)
        for (i, j), g in zip(index, paths):
            w = jax_align_profiles(jprofs[i], jprofs[j], b62, (11, 1), "local")
            assert g.score == w.score and g.x_range == w.x_range and g.y_range == w.y_range
            assert np.array_equal(g.cols_x, w.cols_x) and np.array_equal(g.cols_y, w.cols_y)
    assert groups == {1: len(index), 16: 1}


def test_fused_route_takes_the_chunks_score_tier(monkeypatch):
    """The fused route gets the tier of its chunk's profiles: "mma" for
    integer counts, "scalar" for counts the tensor-core predicate refuses
    (halves); on the CPU no launch is counted on either tier."""
    monkeypatch.setenv(batch.FUSED_DP_ENV, "1")
    seen = []
    real = batch.wavefront_dp_fused

    def spy(*args, tier, **kw):
        seen.append(tier)
        return real(*args, tier=tier, **kw)

    monkeypatch.setattr(batch, "wavefront_dp_fused", spy)
    fused_dp.reset_launches()
    rng = np.random.default_rng(29)
    m = builtin_score_matrix("blosum62")
    for dyadic, tier in ((False, "mma"), (True, "scalar")):
        profs = [Profile(c, np.zeros(len(c), np.float32), ALPHABET_AA)
                 for c in count_profiles(rng, (9, 14, 12), dyadic)]
        seen.clear()
        batch.reset_route_counts()
        got = batch.align_pairs_batched([(profs[0], profs[1]), (profs[1], profs[2])], m, (11, 1),
                                        "global", device="cpu", bucket_sizes=(15,))
        assert seen == [tier] and batch.route_counts["fused"] == 1
        assert all(np.isfinite(r.score) for r in got)
    assert fused_dp.launches == {"mma": 0, "scalar": 0}


@pytest.mark.parametrize("tag,cfg", [
    ("default", PralineConfig()),
    ("series3_local", PralineConfig(gap_series=(13, 7, 1), distance_mode="local",
                                    linkage="complete")),
])
def test_goldens_through_the_fused_route(monkeypatch, tag, cfg):
    monkeypatch.setattr(wavefront, "MAX_LANES", 64)
    batch.reset_route_counts()
    seqs = load_sequence_fasta(TESTDATA / "family10.fasta", ALPHABET_AA)
    aln = msa_align(seqs, builtin_score_matrix("blosum62"), cfg, device="cpu")
    assert format_alignment_fasta(aln) == (TESTDATA / f"family10.{tag}.golden.fasta").read_text()
    assert format_alignment_clustal(aln) == (TESTDATA / f"family10.{tag}.golden.aln").read_text()
    assert batch.route_counts["fused"] > batch.route_counts["two_kernel"]
