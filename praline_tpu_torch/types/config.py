"""Frozen run configuration.

Replaces the reference's CLI-flag -> ``Environment`` dict cascade (SURVEY.md
§6 "Config / flag system", C6/C8) with a single frozen dataclass constructed
once by the CLI / API caller and threaded through the pipeline unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

AlignMode = Literal["global", "semiglobal", "local"]
PreprofileMode = Literal["dummy", "global", "local"]
Linkage = Literal["single", "complete", "average"]
ScoreNormalization = Literal["none", "length"]
OutputFormat = Literal["fasta", "clustal"]


@dataclasses.dataclass(frozen=True)
class PralineConfig:
    """Everything a full MSA run needs, in one immutable value.

    Semantics of every knob are pinned in SURVEY.md §8:

    * ``gap_series``: positive costs; the m-th consecutive gap column costs
      ``gap_series[min(m, k) - 1]`` (§8.2).  ``(11, 1)`` == classic affine
      open-11/extend-1.
    * ``merge_mode`` is the DP mode used for profile-profile merges and the
      all-pairs distance stage; ``preprofile_mode`` selects the master-slave
      strategy (§8.5), with ``dummy`` meaning plain progressive alignment.
    * ``linkage`` / ``score_normalization`` control guide-tree construction
      (§8.4): similarity = pairwise score, optionally divided by alignment
      length, joined by single/complete/average linkage with lexicographic
      (min_index, max_index) tie-breaks.
    """

    score_matrix: str = "blosum62"
    alphabet: str = "protein"
    gap_series: tuple[int, ...] = (11, 1)
    merge_mode: AlignMode = "global"
    distance_mode: AlignMode = "global"
    preprofile_mode: PreprofileMode = "dummy"
    preprofile_gap_series: tuple[int, ...] | None = None  # None -> gap_series
    linkage: Linkage = "average"
    score_normalization: ScoreNormalization = "length"
    output_format: OutputFormat = "fasta"
    fasta_wrap: int = 60  # §8.6: wrap sequence lines at 60 chars
    # Batching / device knobs (TPU build only; no reference analog).
    # Buckets are 2^n - 1 so diagonal vectors (length bucket+1) fill TPU
    # lanes exactly.
    bucket_sizes: tuple[int, ...] = (63, 127, 255, 511, 1023, 2047)
    batch_pairs: int = 512  # pairwise problems per batched DP dispatch
    backend: Literal["auto", "oracle", "xla", "pallas"] = "auto"
    # Distribution (SURVEY.md §3.2): pair-space sharding over a device mesh.
    mesh_shape: tuple[int, ...] | None = None
    checkpoint_dir: str | None = None

    def __post_init__(self) -> None:
        if not self.gap_series or any(g < 0 for g in self.gap_series):
            raise ValueError("gap_series must be non-empty, non-negative costs")
        if self.preprofile_gap_series is not None and (
            not self.preprofile_gap_series or any(g < 0 for g in self.preprofile_gap_series)
        ):
            raise ValueError("preprofile_gap_series must be non-empty, non-negative costs")
        if self.fasta_wrap < 1:
            raise ValueError("fasta_wrap must be >= 1")

    @property
    def effective_preprofile_gap_series(self) -> tuple[int, ...]:
        return self.preprofile_gap_series or self.gap_series
