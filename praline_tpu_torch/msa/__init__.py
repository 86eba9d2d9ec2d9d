"""The MSA pipeline of the port: host orchestration over the batched DP."""

from .pipeline import (
    batched_all_pairs,
    batched_preprofiles,
    batched_progressive_merge,
    msa_align,
)

__all__ = [
    "batched_all_pairs",
    "batched_preprofiles",
    "batched_progressive_merge",
    "msa_align",
]
