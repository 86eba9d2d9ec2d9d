"""Homology search for preprofile extension.

The port's copy of ``praline_tpu/msa/homology.py`` (which imports no JAX;
the port keeps its own copy, on its own ``types.Sequence`` and
``util.metrics.log``).  PSI-BLAST runs as a subprocess against a user
database and its hits join the master's slave set, enriching preprofiles
(homology-extended alignment, Simossis & Heringa 2005): the mapping that
:func:`find_homologs` returns is ``msa_align``'s ``extra_slaves``.  A
deterministic in-process fake finder serves tests and offline use.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable

from ..types import Sequence
from ..util.metrics import log

# A finder maps (master sequence) -> hit sequences to use as extra slaves.
HomologyFinder = Callable[[Sequence], list[Sequence]]


def find_homologs(
    sequences: list[Sequence], finder: HomologyFinder
) -> dict[int, list[Sequence]]:
    """Run a finder for every input; returns the extra-slaves mapping
    consumed by the preprofile builders."""
    out: dict[int, list[Sequence]] = {}
    for i, seq in enumerate(sequences):
        hits = finder(seq)
        if hits:
            out[i] = hits
    return out


class FakeBlastFinder:
    """Canned-hit finder for tests and offline runs: returns preset hits per
    sequence name (no external binary, fully deterministic)."""

    def __init__(self, hits_by_name: dict[str, list[Sequence]]):
        self.hits_by_name = hits_by_name
        self.calls: list[str] = []

    def __call__(self, seq: Sequence) -> list[Sequence]:
        self.calls.append(seq.name)
        return list(self.hits_by_name.get(seq.name, []))


class BlastPlusFinder:
    """PSI-BLAST subprocess adapter (requires NCBI BLAST+ ``psiblast``).

    Uses ``-outfmt "6 sseqid sseq"`` so hit rows carry the aligned subject
    segment directly; gaps are stripped to recover plain sequences.
    """

    def __init__(
        self,
        db: str,
        *,
        binary: str = "psiblast",
        iterations: int = 3,
        evalue: float = 1e-3,
        max_hits: int = 50,
    ):
        self.db = db
        self.binary = binary
        self.iterations = iterations
        self.evalue = evalue
        self.max_hits = max_hits
        if shutil.which(binary) is None:
            raise FileNotFoundError(
                f"{binary!r} not found on PATH; install NCBI BLAST+ or use "
                f"the fake finder"
            )

    def __call__(self, seq: Sequence) -> list[Sequence]:
        with tempfile.TemporaryDirectory(prefix="praline_blast_") as tmp:
            query = Path(tmp) / "query.fasta"
            query.write_text(f">{seq.name}\n{seq.text()}\n")
            cmd = [
                self.binary,
                "-query", str(query),
                "-db", self.db,
                "-num_iterations", str(self.iterations),
                "-evalue", str(self.evalue),
                "-max_target_seqs", str(self.max_hits),
                "-outfmt", "6 sseqid sseq",
            ]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                log.warning(
                    "psiblast failed for %s (exit %d): %s",
                    seq.name, proc.returncode, proc.stderr.strip()[:500],
                )
                return []
            hits: list[Sequence] = []
            seen: set[str] = set()
            for line in proc.stdout.splitlines():
                parts = line.split("\t")
                if len(parts) != 2:
                    continue
                sseqid, sseq = parts
                if sseqid in seen:
                    continue  # keep the first (best) HSP per subject
                seen.add(sseqid)
                text = sseq.replace("-", "").replace("*", "")
                if text:
                    hits.append(Sequence.from_str(sseqid, text, seq.alphabet))
                if len(hits) >= self.max_hits:
                    break
            return hits


def find_homologs_blast(
    sequences: list[Sequence], db: str, **kwargs
) -> dict[int, list[Sequence]]:
    return find_homologs(sequences, BlastPlusFinder(db, **kwargs))
