"""The port's host layers against the JAX package's, on the same inputs.

``praline_tpu_torch`` carries its own copies of the JAX package's numpy
host code (``types``, ``io``, ``oracle``, ``util``; the port imports
nothing of ``praline_tpu``).  Each copy is held against the original here:
FASTA and CLUSTAL read and written byte-equal for the goldens, the 9
packaged matrices, guide-tree joins under each linkage, profile
composition and gap injection through one merge, the preprofile
projection, the run digest and a checkpoint round trip.  Objects cross
between the packages only as numpy arrays (``praline_tpu_torch.convert``).
Tolerance 0.
"""

from pathlib import Path

import numpy as np
import pytest

import praline_tpu.io as jio
import praline_tpu.oracle as jor
import praline_tpu_torch.io as tio
import praline_tpu_torch.oracle as tor
from praline_tpu.types import ALPHABETS as JAX_ALPHABETS
from praline_tpu.types import Alignment as JaxAlignment
from praline_tpu.types import PralineConfig as JaxConfig
from praline_tpu.util.checkpoint import run_digest as jax_run_digest
from praline_tpu_torch.convert import (
    alphabet_from_letters, matrix_from_arrays, profile_from_arrays, sequence_from_arrays,
)
from praline_tpu_torch.types import ALPHABETS, Alignment, PralineConfig, SequenceTree
from praline_tpu_torch.util.checkpoint import Checkpoint, run_digest

TESTDATA = Path(__file__).resolve().parents[1] / "testdata"
GOLDEN_FILES = sorted(p.name for p in TESTDATA.glob("*.golden.*"))


def alphabets(name):
    family = name.split(".")[0]
    key = "dna" if family.startswith("dna") else "protein"
    return JAX_ALPHABETS[key], ALPHABETS[key]


def port_alignment(aln):
    """The port's ``Alignment`` of a JAX one, from its arrays."""
    members = tuple(sequence_from_arrays(s.name, s.tokens, s.alphabet.symbols)
                    for s in aln.members)
    return Alignment(members, np.asarray(aln.rows))


def test_goldens_cover_the_eight_configurations():
    assert len(GOLDEN_FILES) == 16


@pytest.mark.parametrize("name", GOLDEN_FILES)
def test_alignment_files_read_and_written_byte_equal(name):
    ja, ta = alphabets(name)
    path = TESTDATA / name
    text = path.read_text()
    if name.endswith(".fasta"):
        want, got = jio.load_alignment_fasta(path, ja), tio.load_alignment_fasta(path, ta)
        assert tio.format_alignment_fasta(got) == jio.format_alignment_fasta(want) == text
    else:
        want, got = jio.load_alignment_clustal(path, ja), tio.load_alignment_clustal(path, ta)
        assert tio.format_alignment_clustal(got) == jio.format_alignment_clustal(want) == text
    assert [m.name for m in got.members] == [m.name for m in want.members]
    assert np.array_equal(got.rows, want.rows)


@pytest.mark.parametrize("family", ["family10", "family16div", "family64", "dna8", "divfam"])
def test_sequence_fasta_tokens_equal(family):
    ja, ta = alphabets(family)
    want = jio.load_sequence_fasta(TESTDATA / f"{family}.fasta", ja)
    got = tio.load_sequence_fasta(TESTDATA / f"{family}.fasta", ta)
    assert [s.name for s in got] == [s.name for s in want]
    assert all(np.array_equal(g.tokens, w.tokens) for g, w in zip(got, want))
    assert tio.format_sequences_fasta(got) == jio.format_sequences_fasta(want)


@pytest.mark.parametrize("name", sorted(jio.BUILTIN_MATRICES))
def test_builtin_matrices_equal(name):
    want, got = jio.builtin_score_matrix(name), tio.builtin_score_matrix(name)
    assert got.name == want.name
    assert got.alphabet.symbols == want.alphabet.symbols
    assert np.array_equal(got.scores, want.scores)
    assert got.scores.dtype == want.scores.dtype
    port_file = Path(tio.matrixfile.__file__).parents[1] / "data" / "matrices" / f"{name}.txt"
    jax_file = Path(jio.matrixfile.__file__).parents[1] / "data" / "matrices" / f"{name}.txt"
    assert port_file.read_bytes() == jax_file.read_bytes()


@pytest.mark.parametrize("linkage", ["single", "complete", "average"])
@pytest.mark.parametrize("normalization", ["length", "none"])
def test_guide_tree_joins_equal(linkage, normalization):
    rng = np.random.default_rng(len(linkage) * 7 + len(normalization))
    n = 12
    scores = rng.integers(-50, 400, size=(n, n)).astype(np.float64)
    scores = scores + scores.T
    scores[rng.random((n, n)) < 0.1] = 100.0  # ties
    scores = np.maximum(scores, scores.T)
    lengths = rng.integers(50, 120, size=(n, n)).astype(np.int64)
    lengths = np.maximum(lengths, lengths.T)
    sim_j = jor.similarity_from_scores(scores, lengths, normalization)
    sim_t = tor.similarity_from_scores(scores, lengths, normalization)
    assert np.array_equal(sim_j, sim_t)
    want = jor.build_guide_tree(sim_j, linkage)
    got = tor.build_guide_tree(sim_t, linkage)
    assert got.joins == want.joins and got.num_leaves == want.num_leaves
    names = [f"s{i}" for i in range(n)]
    assert got.newick(names) == want.newick(names)


@pytest.mark.parametrize("mode,gap_series", [("global", (11, 1)), ("semiglobal", (12, 6, 1))])
def test_profile_composition_and_gap_injection_equal(mode, gap_series):
    """One merge of two sub-alignments of a golden: member and node
    profiles, the oracle's alignment of them, the full-coverage path, the
    injected rows and the composed profile."""
    jaln = jio.load_alignment_fasta(TESTDATA / "family16div.default.golden.fasta",
                                    JAX_ALPHABETS["protein"])
    jm = jio.builtin_score_matrix("blosum62")
    tm = matrix_from_arrays(jm.name, jm.scores, jm.alphabet.symbols)
    # ungapped members, split into two progressive nodes of 3 and 4 members
    seqs = [jor.member_profile(s) for s in jaln.members]
    tseqs = [tor.member_profile(sequence_from_arrays(s.name, s.tokens, s.alphabet.symbols))
             for s in jaln.members]
    for w, g in zip(seqs, tseqs):
        assert np.array_equal(w.counts, g.counts) and np.array_equal(w.gaps, g.gaps)
    nodes = []
    for members in (jaln.members[:3], jaln.members[3:7]):
        rows = [m.tokens for m in members]
        width = max(len(r) for r in rows)
        padded = np.full((len(rows), width), -1, np.int32)
        for k, r in enumerate(rows):
            padded[k, : len(r)] = r
        nodes.append(JaxAlignment(tuple(members), padded))
    tnodes = [port_alignment(a) for a in nodes]
    jp = [jor.node_profile(a) for a in nodes]
    tp = [tor.node_profile(a) for a in tnodes]
    for w, g in zip(jp, tp):
        assert np.array_equal(w.counts, g.counts) and np.array_equal(w.gaps, g.gaps)
    want = jor.align_profiles(jp[0], jp[1], jm, gap_series, mode)
    got = tor.align_profiles(tp[0], tp[1], tm, gap_series, mode)
    assert got.score == want.score
    assert np.array_equal(got.cols_x, want.cols_x) and np.array_equal(got.cols_y, want.cols_y)
    L1, L2 = nodes[0].num_columns, nodes[1].num_columns
    wx, wy = jor.full_coverage_path(want, L1, L2)
    gx, gy = tor.full_coverage_path(got, L1, L2)
    assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    assert np.array_equal(tor.inject_gaps(tnodes[0].rows, tnodes[1].rows, gx, gy),
                          jor.inject_gaps(nodes[0].rows, nodes[1].rows, wx, wy))
    from praline_tpu.oracle.profile import compose_profiles as jax_compose
    from praline_tpu_torch.oracle.profile import compose_profiles

    wc = jax_compose(jp[0], jp[1], 3, 4, wx, wy)
    gc = compose_profiles(tp[0], tp[1], 3, 4, gx, gy)
    assert np.array_equal(gc.counts, wc.counts) and np.array_equal(gc.gaps, wc.gaps)


@pytest.mark.parametrize("mode", ["global", "local"])
def test_preprofile_projection_equal(mode):
    jseqs = jio.load_sequence_fasta(TESTDATA / "family10.fasta", JAX_ALPHABETS["protein"])[:4]
    tseqs = [sequence_from_arrays(s.name, s.tokens, s.alphabet.symbols) for s in jseqs]
    jm = jio.builtin_score_matrix("blosum62")
    tm = matrix_from_arrays(jm.name, jm.scores, jm.alphabet.symbols)
    want = jor.attach_preprofiles(jseqs, jm, (11, 1), mode)
    got = tor.attach_preprofiles(tseqs, tm, (11, 1), mode)
    for w, g in zip(want, got):
        wp, gp = w.profiles["preprofile"], g.profiles["preprofile"]
        assert np.array_equal(gp.counts, wp.counts) and np.array_equal(gp.gaps, wp.gaps)
    res = jor.align_tokens(jseqs[0].tokens, jseqs[1].tokens, jm, (11, 1), mode)
    tres = tor.align_tokens(tseqs[0].tokens, tseqs[1].tokens, tm, (11, 1), mode)
    assert np.array_equal(tor.project_to_master(tres, tseqs[0].length),
                          jor.project_to_master(res, jseqs[0].length))


def test_checkpoint_round_trip_and_digest(tmp_path):
    jseqs = jio.load_sequence_fasta(TESTDATA / "family10.fasta", JAX_ALPHABETS["protein"])
    seqs = [sequence_from_arrays(s.name, s.tokens, s.alphabet.symbols) for s in jseqs]
    cfg = PralineConfig(gap_series=(13, 7, 1), linkage="complete")
    digest = run_digest(seqs, cfg)
    assert digest == jax_run_digest(jseqs, JaxConfig(gap_series=(13, 7, 1), linkage="complete"))
    assert digest != run_digest(seqs, PralineConfig())

    ck = Checkpoint(tmp_path / "ck", digest)
    pre = [s.with_profile("preprofile", s.one_hot_profile()) for s in seqs]
    rng = np.random.default_rng(3)
    scores, lengths = rng.random((10, 10)), rng.integers(1, 99, (10, 10))
    tree = SequenceTree(3, ((0, 1), (3, 2)))
    ck.save_preprofiles(pre)
    ck.save_distances(scores, lengths)
    ck.save_distance_tile(0, scores[0], lengths[0])
    ck.save_tree(tree)

    again = Checkpoint(tmp_path / "ck", digest)
    loaded = again.load_preprofiles(seqs)
    assert all(np.array_equal(a.profiles["preprofile"].counts, b.profiles["preprofile"].counts)
               for a, b in zip(loaded, pre))
    got_s, got_l = again.load_distances()
    assert np.array_equal(got_s, scores) and np.array_equal(got_l, lengths)
    tile_s, _ = again.load_distance_tile(0)
    assert np.array_equal(tile_s, scores[0])
    again.clear_distance_tiles()
    assert again.load_distance_tile(0) is None
    assert again.load_tree() == tree
    with pytest.raises(ValueError, match="different run"):
        Checkpoint(tmp_path / "ck", run_digest(seqs, PralineConfig()))


def test_array_converters_build_the_ports_objects():
    jm = jio.builtin_score_matrix("dna_simple")
    tm = matrix_from_arrays(jm.name, jm.scores, jm.alphabet.symbols)
    assert tm.alphabet is ALPHABETS["dna"] and np.array_equal(tm.scores, jm.scores)
    p = profile_from_arrays(np.ones((3, 5)), np.zeros(3), "ACGTN")
    assert p.counts.dtype == np.float32 and p.alphabet is ALPHABETS["dna"]
    with pytest.raises(ValueError, match="no alphabet"):
        alphabet_from_letters("XYZ")
