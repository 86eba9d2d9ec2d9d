"""Homology-extended preprofiles in the port (``praline_tpu_torch/msa/
homology.py``, the CLI's ``--blast-db``) against the JAX package's.

``find_homologs`` through ``FakeBlastFinder`` gives the JAX package's
mapping; ``BlastPlusFinder`` drives a stub ``psiblast`` on PATH (the
pattern of ``tests/e2e/test_blast_adapter.py``) to the JAX adapter's hits:
the same argv, the first HSP of a subject, gaps and stops stripped,
malformed and all-gap rows dropped, ``max_hits``, a failing search logged
and empty, a missing binary ``FileNotFoundError``.  ``msa_align`` with the
hits is byte-equal to the JAX package's with the same hits and to the
port's ``oracle_msa``; the CLI's ``--blast-db`` to the library path; the
checkpoint digest covers the hits' content as the JAX package's does.
"""

import os
import stat

import numpy as np
import pytest
import torch

import praline_tpu as jax_pkg
from praline_tpu.msa import msa_align as jax_msa_align
from praline_tpu.msa.homology import BlastPlusFinder as JaxBlastFinder
from praline_tpu.msa.homology import FakeBlastFinder as JaxFakeFinder
from praline_tpu.msa.homology import find_homologs as jax_find_homologs
from praline_tpu.util.checkpoint import run_digest as jax_run_digest
from praline_tpu_torch import ALPHABET_AA, PralineConfig, Sequence, builtin_score_matrix
from praline_tpu_torch.cli.main import main
from praline_tpu_torch.io import format_alignment_fasta, load_sequence_fasta
from praline_tpu_torch.msa import (
    BlastPlusFinder, FakeBlastFinder, batched_preprofiles, find_homologs, find_homologs_blast,
    msa_align,
)
from praline_tpu_torch.oracle import oracle_msa
from praline_tpu_torch.types import TRACK_ID_PREPROFILE
from praline_tpu_torch.util.checkpoint import run_digest

torch.set_num_threads(1)

B62 = builtin_score_matrix("blosum62")
JB62 = jax_pkg.builtin_score_matrix("blosum62")

# Canned outfmt-6 rows keyed on the query's name; the argv goes to
# $STUB_LOG.  Rows: a duplicate subject (the first HSP wins), segments with
# gaps and stops (stripped), a malformed row, an all-gap row.
STUB = r"""#!/bin/sh
printf '%s\n' "$@" > "$STUB_LOG"
query=""
while [ $# -gt 0 ]; do
  [ "$1" = "-query" ] && query="$2"
  shift
done
case "$(head -1 "$query")" in
  ">boom"*) echo "simulated database failure" >&2; exit 2 ;;
  ">a"*)
    printf 'hit1\tMKVL-AWGYPV*QD\n'
    printf 'hit1\tSHOULDBEDEDUPED\n'
    printf 'malformed row without tab\n'
    printf 'hit2\tMKVINWGYPV\n'
    printf 'gaponly\t----\n'
    printf 'hit3\tKVINWGYPVEDA\n'
    ;;
esac
exit 0
"""
PAIR = [("a", "MKVLAWGYPVED"), ("b", "MKVLAWGYPED")]


@pytest.fixture
def stub_psiblast(tmp_path, monkeypatch):
    exe = tmp_path / "psiblast"
    exe.write_text(STUB)
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    log = tmp_path / "argv.log"
    monkeypatch.setenv("STUB_LOG", str(log))
    return log


def seqs(pairs=PAIR):
    return [Sequence.from_str(n, t, ALPHABET_AA) for n, t in pairs]


def jax_seqs(pairs=PAIR):
    return [jax_pkg.Sequence.from_str(n, t, jax_pkg.ALPHABET_AA) for n, t in pairs]


def as_tuples(mapping):
    return {i: [(h.name, h.tokens.tolist()) for h in hits] for i, hits in mapping.items()}


def family_and_hits(seed=5, n=6, n_hits=3):
    """``n`` mutants of one root and, for every other one, ``n_hits`` hits:
    members of a second family, so that the hits change the preprofiles."""
    rng = np.random.default_rng(seed)

    def mutants(prefix, k, L):
        root = rng.integers(0, 20, size=L)
        out = []
        for i in range(k):
            t = root.copy()
            sub = rng.random(L) < 0.3
            t[sub] = rng.integers(0, 20, size=int(sub.sum()))
            out.append((f"{prefix}{i}", "".join(ALPHABET_AA.symbols[v] for v in t)))
        return out

    members, others = mutants("m", n, 40), mutants("h", n_hits * n, 36)
    hits = {name: [Sequence.from_str(*h, ALPHABET_AA) for h in others[i * n_hits:(i + 1) * n_hits]]
            for i, (name, _) in enumerate(members) if i % 2 == 0}
    return members, hits


def test_fake_finder_mapping_matches_jax():
    members, hits = family_and_hits()
    jhits = {k: [jax_pkg.Sequence.from_str(h.name, h.text(), jax_pkg.ALPHABET_AA) for h in v]
             for k, v in hits.items()}
    finder, jfinder = FakeBlastFinder(hits), JaxFakeFinder(jhits)
    got = find_homologs(seqs(members), finder)
    want = jax_find_homologs(jax_seqs(members), jfinder)
    assert as_tuples(got) == as_tuples(want) and sorted(got) == [0, 2, 4]
    assert finder.calls == jfinder.calls == [n for n, _ in members]


def test_missing_binary_is_a_clean_error(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="psiblast"):
        BlastPlusFinder("somedb")
    with pytest.raises(FileNotFoundError, match="psiblast"):
        find_homologs_blast(seqs(), "somedb")


@pytest.mark.parametrize("max_hits", [10, 2])
def test_adapter_matches_the_jax_adapter(stub_psiblast, max_hits):
    """The same hits as the JAX adapter (first HSP a subject, gaps and stops
    stripped, malformed and all-gap rows dropped, cut at ``max_hits``) and
    the same argv."""
    kw = dict(iterations=2, evalue=1e-4, max_hits=max_hits)
    got = BlastPlusFinder("somedb", **kw)(seqs()[0])
    argv = stub_psiblast.read_text().split()
    want = JaxBlastFinder("somedb", **kw)(jax_seqs()[0])
    jax_argv = stub_psiblast.read_text().split()
    assert jax_argv[0] == argv[0] == "-query"
    assert jax_argv[2:] == argv[2:]  # all but the query's temporary file
    assert [(h.name, h.text()) for h in got] == [(h.name, h.text()) for h in want]
    assert [h.name for h in got] == ["hit1", "hit2", "hit3"][:max_hits]
    assert got[0].text() == "MKVLAWGYPVQD"
    assert argv[argv.index("-db") + 1] == "somedb"
    assert argv[argv.index("-num_iterations") + 1] == "2"
    assert argv[argv.index("-evalue") + 1] == "0.0001"
    assert argv[argv.index("-max_target_seqs") + 1] == str(max_hits)
    assert argv[argv.index("-outfmt") + 1:] == ["6", "sseqid", "sseq"]


def test_adapter_failure_logs_and_returns_empty(stub_psiblast, caplog):
    with caplog.at_level("WARNING", logger="praline_tpu_torch"):
        hits = BlastPlusFinder("somedb")(Sequence.from_str("boom", "MKVLAWGYPVED", ALPHABET_AA))
    assert hits == []
    assert any("psiblast failed" in r.message and "exit 2" in r.message for r in caplog.records)


def test_msa_align_with_hits_matches_jax_and_the_oracle():
    """Hits from ``FakeBlastFinder`` through the port's ``msa_align`` give
    the JAX package's bytes with the same hits and the port's oracle's;
    they change the preprofiles."""
    members, hits = family_and_hits()
    ss = seqs(members)
    mapping = find_homologs(ss, FakeBlastFinder(hits))
    jmapping = {i: [jax_pkg.Sequence.from_str(h.name, h.text(), jax_pkg.ALPHABET_AA) for h in v]
                for i, v in mapping.items()}
    for mode in ("global", "local"):
        cfg = PralineConfig(preprofile_mode=mode)
        got = format_alignment_fasta(msa_align(ss, B62, cfg, device="cpu", extra_slaves=mapping))
        want = jax_pkg.format_alignment_fasta(jax_msa_align(
            jax_seqs(members), JB62, jax_pkg.PralineConfig(preprofile_mode=mode),
            extra_slaves=jmapping))
        oracle = format_alignment_fasta(oracle_msa(ss, B62, cfg, extra_slaves=mapping))
        assert got == want == oracle, mode
    cfg = PralineConfig(preprofile_mode="global")
    plain = batched_preprofiles(ss, B62, cfg, device="cpu")
    extended = batched_preprofiles(ss, B62, cfg, device="cpu", extra_slaves=mapping)
    for i, (p, e) in enumerate(zip(plain, extended)):
        same = np.array_equal(p.profiles[TRACK_ID_PREPROFILE].counts,
                              e.profiles[TRACK_ID_PREPROFILE].counts)
        assert same == (i not in mapping), i


def test_cli_blast_db_end_to_end(stub_psiblast, tmp_path):
    """``--blast-db`` runs the adapter through the CLI: the library path's
    bytes with the same hits."""
    fa = tmp_path / "in.fasta"
    fa.write_text("".join(f">{n}\n{t}\n" for n, t in PAIR))
    out = tmp_path / "ext.fasta"
    assert main([str(fa), str(out), "--device", "cpu", "--preprofile", "global",
                 "--blast-db", "somedb"]) == 0
    ss = load_sequence_fasta(fa, ALPHABET_AA)
    mapping = find_homologs_blast(ss, "somedb")
    assert set(mapping) == {0} and len(mapping[0]) == 3
    want = msa_align(ss, B62, PralineConfig(preprofile_mode="global"), device="cpu",
                     extra_slaves=mapping)
    assert out.read_text() == format_alignment_fasta(want)


def test_cli_blast_db_without_psiblast_fails_cleanly(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PATH", str(tmp_path))
    fa = tmp_path / "in.fasta"
    fa.write_text("".join(f">{n}\n{t}\n" for n, t in PAIR))
    assert main([str(fa), str(tmp_path / "o.fasta"), "--device", "cpu", "--blast-db", "db"]) == 2
    assert "psiblast" in capsys.readouterr().err


def test_checkpoint_digest_covers_hit_content_as_jax_does():
    """The run digest changes with a hit's name or residues and not with
    the database it came from; it equals the JAX package's digest, so a
    checkpoint dir written by one package is resumed or refused by the
    other alike."""
    members, hits = family_and_hits()
    ss, js = seqs(members), jax_seqs(members)
    cfg, jcfg = PralineConfig(preprofile_mode="global"), jax_pkg.PralineConfig(
        preprofile_mode="global")
    mapping = find_homologs(ss, FakeBlastFinder(hits))

    def jax_map(m):
        return {i: [jax_pkg.Sequence.from_str(h.name, h.text(), jax_pkg.ALPHABET_AA) for h in v]
                for i, v in m.items()}

    base = run_digest(ss, cfg)
    with_hits = run_digest(ss, cfg, extra_slaves=mapping)
    assert with_hits != base
    assert with_hits == jax_run_digest(js, jcfg, extra_slaves=jax_map(mapping))
    assert base == jax_run_digest(js, jcfg)
    renamed = {i: [Sequence.from_str(h.name + "x", h.text(), ALPHABET_AA) for h in v]
               for i, v in mapping.items()}
    mutated = dict(mapping)
    first = mapping[0][0]
    mutated[0] = [Sequence.from_str(first.name, "W" + first.text()[1:], ALPHABET_AA)] + \
        mapping[0][1:]
    assert len({with_hits, run_digest(ss, cfg, extra_slaves=renamed),
                run_digest(ss, cfg, extra_slaves=mutated)}) == 3
