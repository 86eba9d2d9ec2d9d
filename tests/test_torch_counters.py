"""``METRICS.counters`` (``praline_tpu_torch/util/metrics.py``): the DP
cells the batch drivers launch (rows times the bucket's ``bx * by``) and
need (``lx * ly`` at true lengths), a route each, and the device merge's
(joins times ``C_cap**2`` for every rung tried; the emitted joins'
``cols_left * cols_right``), counted exactly and never reset."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from praline_tpu_torch import ALPHABET_AA, METRICS, PralineConfig, builtin_score_matrix
from praline_tpu_torch.io import format_alignment_fasta, load_sequence_fasta
from praline_tpu_torch.kernels import batch, tiled_dp
from praline_tpu_torch.msa import device_merge as dm
from praline_tpu_torch.msa import msa_align
from praline_tpu_torch.msa.pipeline import batched_all_pairs
from praline_tpu_torch.oracle.tree import build_guide_tree, similarity_from_scores
from praline_tpu_torch.types import Profile

TESTDATA = Path(__file__).resolve().parents[1] / "testdata"
B62 = builtin_score_matrix("blosum62")
BUCKETS = (63, 127, 255)


def profile(length: int, rng) -> Profile:
    counts = np.zeros((length, ALPHABET_AA.size), dtype=np.float32)
    counts[np.arange(length), rng.integers(0, 20, size=length)] = 1.0
    return Profile(counts, np.zeros(length, dtype=np.float32), ALPHABET_AA)


@pytest.mark.parametrize("tracks", [False, True])
def test_batch_cells_equal_bucket_and_true_length_sums(tracks):
    """Ragged lengths over three buckets, chunks of three rows, an empty
    member (no DP, no cells): launched is the sum of each pair's bucket
    product, needed the sum of its lengths' product, both on the route;
    the list entry counts every pair it takes as listed."""
    rng = np.random.default_rng(3)
    lengths = [7, 40, 63, 64, 100, 127, 128, 200, 0]
    profs = [profile(L, rng) for L in lengths]
    pairs = [(profs[i], profs[j]) for i in range(len(profs)) for j in range(i + 1, len(profs))]
    before = dict(METRICS.counters)
    if tracks:
        batch.align_tracksets_batched([((x,), (y,)) for x, y in pairs], [B62], [1.0], (11, 1),
                                      "global", device="cpu", bucket_sizes=BUCKETS, batch_pairs=3)
    else:
        batch.align_pairs_batched(pairs, B62, (11, 1), "global", device="cpu",
                                  bucket_sizes=BUCKETS, batch_pairs=3)
    grown = {k: v - before.get(k, 0) for k, v in METRICS.counters.items()
             if v != before.get(k, 0)}
    real = [(x.length, y.length) for x, y in pairs if x.length and y.length]
    assert grown == {
        "batch.cells_launched:two_kernel":
            sum(batch._bucket(a, BUCKETS) * batch._bucket(b, BUCKETS) for a, b in real),
        "batch.cells_needed:two_kernel": sum(a * b for a, b in real),
        **({} if tracks else {"batch.pairs:listed": len(pairs)}),
    }


def test_merge_cells_count_every_rung_tried(monkeypatch):
    """family10's walk at a first rung of its longest member overflows
    and reruns at 127: launched counts both walks, needed the emitted
    joins' widths, as the merge stage's cells; ``METRICS.reset`` keeps
    them."""
    seqs = load_sequence_fasta(TESTDATA / "family10.fasta", ALPHABET_AA)
    cfg = PralineConfig()
    scores, lengths = batched_all_pairs(seqs, B62, cfg, device="cpu")
    tree = build_guide_tree(similarity_from_scores(scores, lengths, cfg.score_normalization),
                            cfg.linkage)
    longest = max(s.length for s in seqs)
    monkeypatch.setattr(dm, "ladder", lambda max_len: (max_len, 127))
    METRICS.reset()
    before = dict(METRICS.counters)
    got = dm.try_device_merge(seqs, tree, B62, cfg, device="cpu")
    assert METRICS.notes["merge_attempts"] == [longest, 127]
    assert format_alignment_fasta(got) == (TESTDATA / "family10.default.golden.fasta").read_text()
    launched = METRICS.counters["merge.cells_launched"] - before.get("merge.cells_launched", 0)
    needed = METRICS.counters["merge.cells_needed"] - before.get("merge.cells_needed", 0)
    assert launched == len(tree.joins) * (longest**2 + 127**2)
    assert needed == METRICS.stages["merge"].cells
    kept = dict(METRICS.counters)
    METRICS.reset()
    assert METRICS.counters == kept


def test_msa_align_counts_its_all_pairs_and_merge_cells():
    """One ``msa_align`` on family10: the all-pairs stage's needed cells
    are its stage cells, and the device merge's needed cells its merge
    cells."""
    seqs = load_sequence_fasta(TESTDATA / "family10.fasta", ALPHABET_AA)
    before = dict(METRICS.counters)
    msa_align(seqs, B62, PralineConfig(), device="cpu")
    grown = {k: v - before.get(k, 0) for k, v in METRICS.counters.items()}
    assert sum(v for k, v in grown.items() if k.startswith("batch.cells_needed:")) == \
        METRICS.stages["all_pairs"].cells
    assert grown["merge.cells_needed"] == METRICS.stages["merge"].cells
    assert grown["merge.cells_launched"] == \
        (len(seqs) - 1) * sum(c * c for c in METRICS.notes["merge_attempts"])


def test_all_pairs_counts_its_pairs_as_indexed():
    """One ``batched_all_pairs`` on N members: N(N-1)/2 pairs enter the
    batch driver as index arrays and none as a list; the list entry counts
    its pairs as listed."""
    seqs = load_sequence_fasta(TESTDATA / "family10.fasta", ALPHABET_AA)
    n = len(seqs)
    before = dict(METRICS.counters)
    batched_all_pairs(seqs, B62, PralineConfig(), device="cpu")
    grown = {k: v - before.get(k, 0) for k, v in METRICS.counters.items()}
    assert grown["batch.pairs:indexed"] == n * (n - 1) // 2
    assert grown.get("batch.pairs:listed", 0) == 0
    rng = np.random.default_rng(4)
    profs = [profile(L, rng) for L in (9, 30, 0)]
    before = dict(METRICS.counters)
    batch.align_pairs_batched([(profs[0], profs[1]), (profs[1], profs[2]), (profs[0], profs[0])],
                              B62, (11, 1), "global", device="cpu", bucket_sizes=BUCKETS)
    assert METRICS.counters["batch.pairs:listed"] - before.get("batch.pairs:listed", 0) == 3
    assert METRICS.counters["batch.pairs:indexed"] == before["batch.pairs:indexed"]


@pytest.mark.parametrize("traceback", [False, True])
def test_tiled_counters_count_the_long_routes_chunks_and_problems(monkeypatch, traceback):
    """The lane caps forced down (the whole-row DP to 31 lanes, the fused
    kernel to 63): x sides in bucket 63 take the fused route and longer
    ones the tiled route, with traceback (127, 255) past a lowered byte
    budget checkpointed.  Every chunk of the tiled and checkpointed routes
    adds one to ``tiled.chunks:hs`` and its problems to
    ``tiled.problems:scores`` or ``tiled.problems:traceback``; the fused
    route adds nothing there."""
    monkeypatch.setattr(batch.wavefront, "MAX_LANES", 32)
    monkeypatch.setattr(batch, "MAX_LANES_FUSED", 64)
    monkeypatch.setattr(batch, "TB_BYTES_BUDGET", 40_000)  # (127, 127) fits, (127, 255) not
    monkeypatch.delenv(batch.FUSED_DP_ENV, raising=False)
    rng = np.random.default_rng(5)
    profs = [profile(L, rng) for L in (40, 50, 64, 100, 130)]
    pairs = [(profs[i], profs[j]) for i in range(len(profs)) for j in range(i + 1, len(profs))]
    batch.reset_route_counts()
    before = dict(METRICS.counters)
    got = batch.align_pairs_batched(pairs, B62, (11, 1), "global", device="cpu",
                                    bucket_sizes=BUCKETS, batch_pairs=2, traceback=traceback)
    grown = {k: v - before.get(k, 0) for k, v in METRICS.counters.items()
             if k.startswith("tiled.") and v != before.get(k, 0)}
    long_x = [i for i, (x, _) in enumerate(pairs) if x.length > 63]
    chunks = batch.route_counts["tiled"] + batch.checkpointed_chunks
    assert batch.route_counts["fused"] > 0 and batch.route_counts["two_kernel"] == 0
    assert (batch.checkpointed_chunks > 0) == traceback
    assert grown == {"tiled.chunks:hs": chunks,
                     f"tiled.problems:{'traceback' if traceback else 'scores'}": len(long_x)}
    monkeypatch.undo()  # the default caps: every pair on the two-kernel route, same results
    want = batch.align_pairs_batched(pairs, B62, (11, 1), "global", device="cpu",
                                     bucket_sizes=BUCKETS, traceback=traceback)
    assert all(np.array_equal(getattr(a, f.name), getattr(b, f.name))
               for a, b in zip(got, want, strict=True) for f in dataclasses.fields(a))


@pytest.mark.parametrize("k,kind,traceback,grows", [
    (2, "hs", False, True), (3, "hs", False, True), (2, "hs", True, False),
    (15, "hs", False, False), (2, "rows", False, False)])
def test_lane_problems_count_where_the_chunk_takes_lanes(monkeypatch, k, kind, traceback,
                                                         grows):
    """A launch's geometry, chosen as on the H100 (7 one-lane clusters of
    15-16 CTAs at once, 30 of 4 CTAs; 233,472 B of shared memory an SM),
    then counted as launched: a scores chunk over hs of 21 problems of 4736
    lanes adds them to ``tiled.problems:q{Q}`` for its Q > 1; a traceback
    launch, more than three levels and the in-place sources add nothing
    there."""
    monkeypatch.setattr(tiled_dp, "max_active_clusters",
                        lambda k, source, g, ckpt=False, tier=None:
                        7 if g.Q == 1 else max(1, 120 // g.R))
    monkeypatch.setattr(tiled_dp, "sm_shared_memory", lambda: 233_472)
    before = dict(METRICS.counters)
    g = tiled_dp.tiled_geometry(4736, k, kind, problems=21, traceback=traceback, diagonals=9343,
                                tier=None if kind == "hs" else "scalar")
    tiled_dp.count_lanes(g, 21)
    grown = {key: v - before.get(key, 0) for key, v in METRICS.counters.items()
             if v != before.get(key, 0)}
    assert (g.Q > 1) == grows
    assert grown == ({f"tiled.problems:q{g.Q}": 21} if grows else {})
