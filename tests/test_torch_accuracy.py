"""The port's SP/TC column accuracy (``praline_tpu_torch/util/accuracy.py``)
against the JAX package's ``sp_tc``, and the CLI's ``--score-against``.

The same gapped records go through both packages' ``sp_tc`` (template:
``tests/util/test_accuracy.py``); the metric is a ratio of counts, so the
two must agree exactly.
"""

from pathlib import Path

import numpy as np
import pytest

from praline_tpu import ALPHABET_AA as JAX_AA
from praline_tpu.io.fasta import alignment_from_gapped_texts as jax_alignment
from praline_tpu.util.accuracy import sp_tc as jax_sp_tc
from praline_tpu_torch import ALPHABET_AA
from praline_tpu_torch.cli.main import main
from praline_tpu_torch.io.fasta import alignment_from_gapped_texts
from praline_tpu_torch.util.accuracy import sp_tc

TESTDATA = Path(__file__).resolve().parent.parent / "testdata"

CASES = {
    "identity": ([("x", "MKV-LA"), ("y", "MK-WLA"), ("z", "MKVW-A")],
                 [("x", "MKV-LA"), ("y", "MK-WLA"), ("z", "MKVW-A")]),
    "shifted": ([("a", "AC"), ("b", "AC")], [("a", "AC-"), ("b", "-AC")]),
    "partial": ([("a", "MKV-"), ("b", "MK--"), ("c", "M--V")],
                [("a", "MKV"), ("b", "MK-"), ("c", "M-V")]),
    "single": ([("only", "MKV")], [("only", "MKV")]),
}


def random_pair(seed, n=6, L=30):
    """Two gappings of the same n ungapped sequences."""
    rng = np.random.default_rng(seed)
    letters = "ACDEFGHIKLMNPQRSTVWY"
    seqs = ["".join(rng.choice(list(letters), size=int(rng.integers(L // 2, L))))
            for _ in range(n)]

    def gapped():
        width = max(len(s) for s in seqs) + 8
        out = []
        for k, s in enumerate(seqs):
            cols = np.sort(rng.choice(width, size=len(s), replace=False))
            row = ["-"] * width
            for c, ch in zip(cols, s):
                row[c] = ch
            out.append((f"s{k}", "".join(row)))
        return out

    return gapped(), gapped()


@pytest.mark.parametrize("case", [*CASES, "random0", "random1", "random2"])
def test_sp_tc_matches_jax(case):
    test, ref = CASES[case] if case in CASES else random_pair(int(case[-1]))
    want = jax_sp_tc(jax_alignment(test, JAX_AA), jax_alignment(ref, JAX_AA))
    got = sp_tc(alignment_from_gapped_texts(test, ALPHABET_AA),
                alignment_from_gapped_texts(ref, ALPHABET_AA))
    assert got == want


def test_sp_tc_raises_like_jax():
    a = [("a", "MKV"), ("b", "MKV")]
    for other in ([("a", "MKV"), ("c", "MKV")], [("a", "MKVL"), ("b", "MKV-")],
                  [("x", "MKV"), ("x", "MKV")]):
        with pytest.raises(ValueError):
            jax_sp_tc(jax_alignment(a if other[0][0] != "x" else other, JAX_AA),
                      jax_alignment(other, JAX_AA))
        with pytest.raises(ValueError):
            sp_tc(alignment_from_gapped_texts(a if other[0][0] != "x" else other, ALPHABET_AA),
                  alignment_from_gapped_texts(other, ALPHABET_AA))


def test_cli_scores_against_the_golden(tmp_path, capsys):
    """``--score-against`` the run's own golden prints SP=1 TC=1; a
    missing reference exits 2 with the reference's message."""
    golden = TESTDATA / "family10.default.golden.aln"
    rc = main([str(TESTDATA / "family10.fasta"), str(tmp_path / "o.aln"), "--device", "cpu",
               "--score-against", str(golden)])
    assert rc == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == "SP=1.0000 TC=1.0000"
    rc = main([str(TESTDATA / "family10.fasta"), str(tmp_path / "o.aln"), "--device", "cpu",
               "--score-against", str(tmp_path / "missing.fasta")])
    assert rc == 2
    assert "error: --score-against:" in capsys.readouterr().err
