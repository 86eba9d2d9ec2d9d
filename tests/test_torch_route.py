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

import pytest
import torch

from praline_tpu_torch import ALPHABET_AA, PralineConfig, builtin_score_matrix
from praline_tpu_torch.io import (
    format_alignment_clustal, format_alignment_fasta, load_sequence_fasta,
)
from praline_tpu_torch.kernels import batch, wavefront
from praline_tpu_torch.kernels.fused_dp import MAX_LANES_FUSED
from praline_tpu_torch.kernels.fused_scores import mma_scratch_bytes
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
    by = batch.TB_BYTES_BUDGET // 4096 + 10
    assert ROUTE("cuda", 4095, by, False) == "fused"
    with pytest.raises(NotImplementedError, match="checkpointed"):
        ROUTE("cuda", 4095, by, True)


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
    two = batch.chunk_problem_bytes("two_kernel", "cuda", 1023, 1023, A, False)
    fused = batch.chunk_problem_bytes("fused", "cuda", 1023, 1023, A, False)
    hs_bytes, tb_bytes = batch.per_problem_bytes(1023, 1023)
    # hs and the tensor-core producer's scratch against the fused kernel's T / Cy copies
    assert two - fused == hs_bytes + mma_scratch_bytes(1, 1023, 1023) - 2046 * 24 * 4
    assert batch.chunk_problem_bytes("fused", "cuda", 1023, 1023, A, True) == fused + 2 * tb_bytes
    # the plain versions build hs on either route
    assert batch.chunk_problem_bytes("fused", "cpu", 1023, 1023, A, False) == fused + hs_bytes


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
