"""The port's ``msa_align`` on the CPU against every committed golden.

The 8 golden configurations of ``tests/e2e/test_goldens.py`` (16 files in
``testdata/``) must come out byte-equal, FASTA and CLUSTAL, plus one CLI
run and the CLI's refusals of knobs the port does not have yet.  The
inputs are read, and the outputs written, by the port's own readers and
writers (``praline_tpu_torch.io``).
"""

from pathlib import Path

import pytest
import torch

from praline_tpu_torch import ALPHABET_AA, ALPHABET_DNA, PralineConfig, builtin_score_matrix
from praline_tpu_torch.io import (
    format_alignment_clustal, format_alignment_fasta, load_sequence_fasta,
)
from praline_tpu_torch.cli.main import main
from praline_tpu_torch.msa import msa_align

torch.set_num_threads(1)

TESTDATA = Path(__file__).resolve().parents[1] / "testdata"

GOLDENS = {
    ("family10", "default"): ("blosum62", PralineConfig()),
    ("family10", "ppglobal"): ("blosum62", PralineConfig(preprofile_mode="global")),
    ("family10", "series3_local"): ("blosum62", PralineConfig(
        gap_series=(13, 7, 1), distance_mode="local", linkage="complete")),
    ("family16div", "default"): ("blosum62", PralineConfig()),
    ("family16div", "pam250_semi_pplocal"): ("pam250", PralineConfig(
        merge_mode="semiglobal", preprofile_mode="local", gap_series=(10, 2),
        linkage="single")),
    ("dna8", "default"): ("dna_simple", PralineConfig(
        gap_series=(8, 2), alphabet="dna", score_matrix="dna_simple")),
    ("family64", "default"): ("blosum62", PralineConfig()),
    ("family64", "semi_series3"): ("blosum62", PralineConfig(
        gap_series=(12, 6, 1), merge_mode="semiglobal", linkage="average")),
}


@pytest.mark.parametrize("family,tag", sorted(GOLDENS))
def test_msa_align_cpu_matches_golden(family, tag):
    matrix_name, cfg = GOLDENS[(family, tag)]
    alphabet = ALPHABET_DNA if family == "dna8" else ALPHABET_AA
    seqs = load_sequence_fasta(TESTDATA / f"{family}.fasta", alphabet)
    aln = msa_align(seqs, builtin_score_matrix(matrix_name), cfg, device="cpu")
    assert format_alignment_fasta(aln) == (TESTDATA / f"{family}.{tag}.golden.fasta").read_text()
    assert format_alignment_clustal(aln) == (TESTDATA / f"{family}.{tag}.golden.aln").read_text()


def test_checkpoint_resume_after_a_distance_fault(tmp_path):
    """The distance stage's fault seam: a crash in tile 0 leaves a
    checkpoint dir the next run resumes from, with the golden output."""
    seqs = load_sequence_fasta(TESTDATA / "family10.fasta", ALPHABET_AA)
    m = builtin_score_matrix("blosum62")
    cfg = PralineConfig(checkpoint_dir=str(tmp_path / "ck"))

    def crash(tile_id):
        raise RuntimeError(f"injected fault in tile {tile_id}")

    with pytest.raises(RuntimeError, match="injected"):
        msa_align(seqs, m, cfg, device="cpu", fault_hook=crash)
    want = (TESTDATA / "family10.default.golden.fasta").read_text()
    for _ in range(2):  # a fresh run, then one that loads every stage
        assert format_alignment_fasta(msa_align(seqs, m, cfg, device="cpu")) == want
    assert (tmp_path / "ck" / "distances.npz").exists()


def test_cli_cpu_run_matches_golden(tmp_path):
    out = tmp_path / "out.aln"
    tree = tmp_path / "tree.nwk"
    rc = main([str(TESTDATA / "family10.fasta"), str(out), "--device", "cpu",
               "--tree-out", str(tree)])
    assert rc == 0
    assert out.read_text() == (TESTDATA / "family10.default.golden.aln").read_text()
    assert tree.read_text().startswith("(")


@pytest.mark.parametrize("flags", [
    ["--devices", "2"], ["--blast-db", "db"], ["--devices", "2", "--profile-dir", "p"],
    ["--backend", "xla"], ["--backend", "pallas"],
])
def test_cli_refuses_unported_knobs(tmp_path, capsys, monkeypatch, flags):
    """Only the JAX package's backends are refused as not ported.
    ``--devices`` and ``--blast-db`` are ported: on the CPU ``--devices 2``
    (with ``--profile-dir``, ``tests/test_torch_profiling.py``) gives the
    golden bytes, and ``--blast-db`` with no ``psiblast`` on PATH fails
    cleanly (``tests/test_torch_homology.py`` drives a stub)."""
    monkeypatch.setenv("PATH", str(tmp_path))  # no psiblast
    flags = [str(tmp_path / f) if f == "p" else f for f in flags]
    out = tmp_path / "o.fasta"
    rc = main([str(TESTDATA / "family10.fasta"), str(out), "--device", "cpu", *flags])
    err = capsys.readouterr().err
    if flags[0] == "--backend":
        assert rc == 2 and "not ported" in err
    elif flags[0] == "--blast-db":
        assert rc == 2 and "--blast-db" in err and "psiblast" in err
    else:
        assert rc == 0
        assert out.read_text() == (TESTDATA / "family10.default.golden.fasta").read_text()


def test_cli_without_a_card_fails_cleanly(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main([str(TESTDATA / "family10.fasta"), str(tmp_path / "o.fasta")])
    assert rc == 2
    assert "device='cpu'" in capsys.readouterr().err


def test_msa_align_refuses_jax_backends_and_meshes():
    """The JAX backends are refused; a mesh is not any more: two CPU shards
    give the golden bytes (``tests/test_torch_dist.py``)."""
    seqs = load_sequence_fasta(TESTDATA / "family10.fasta", ALPHABET_AA)
    m = builtin_score_matrix("blosum62")
    with pytest.raises(ValueError):
        msa_align(seqs, m, PralineConfig(backend="xla"), device="cpu")
    aln = msa_align(seqs, m, PralineConfig(mesh_shape=(2,)), device="cpu")
    assert format_alignment_fasta(aln) == \
        (TESTDATA / "family10.default.golden.fasta").read_text()


def test_msa_align_with_a_mesh_checks_its_input_first(tmp_path):
    """With ``mesh_shape`` set, the empty-input check, the one-sequence
    return and the oracle backend come before the mesh, as in the JAX
    package's ``msa_align``: both raise ValueError on no sequences and
    return the same bytes for one sequence and under backend "oracle"."""
    import praline_tpu as jax_pkg
    from praline_tpu.msa import msa_align as jax_msa_align

    fasta = tmp_path / "in.fasta"
    fasta.write_text(">a\nMKVLAWGYPVED\n>b\nMKVLAWGYPED\n>c\nMKVINWGYPVED\n")
    seqs = load_sequence_fasta(fasta, ALPHABET_AA)
    jseqs = jax_pkg.load_sequence_fasta(fasta, jax_pkg.ALPHABET_AA)
    m, jm = builtin_score_matrix("blosum62"), jax_pkg.builtin_score_matrix("blosum62")
    cfg = PralineConfig(mesh_shape=(2,))
    jcfg = jax_pkg.PralineConfig(mesh_shape=(2,))
    with pytest.raises(ValueError, match="no sequences"):
        msa_align([], m, cfg, device="cpu")
    with pytest.raises(ValueError, match="no sequences"):
        jax_msa_align([], jm, jcfg)
    one = msa_align(seqs[:1], m, cfg, device="cpu")
    assert format_alignment_fasta(one) == jax_pkg.format_alignment_fasta(
        jax_msa_align(jseqs[:1], jm, jcfg))
    oracle = PralineConfig(mesh_shape=(2,), backend="oracle")
    joracle = jax_pkg.PralineConfig(mesh_shape=(2,), backend="oracle")
    assert format_alignment_fasta(msa_align(seqs, m, oracle, device="cpu")) == \
        jax_pkg.format_alignment_fasta(jax_msa_align(jseqs, jm, joracle))
