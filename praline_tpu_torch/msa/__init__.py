"""The MSA pipeline of the port: host orchestration over the batched DP."""

from .pipeline import (
    batched_all_pairs,
    batched_preprofiles,
    batched_progressive_merge,
    msa_align,
    per_level_merge,
)
from .device_merge import try_device_merge
from .homology import BlastPlusFinder, FakeBlastFinder, find_homologs, find_homologs_blast

__all__ = [
    "BlastPlusFinder",
    "FakeBlastFinder",
    "batched_all_pairs",
    "batched_preprofiles",
    "batched_progressive_merge",
    "find_homologs",
    "find_homologs_blast",
    "msa_align",
    "per_level_merge",
    "try_device_merge",
]
