"""The MSA pipeline of the port: host orchestration over the batched DP."""

from .pipeline import (
    batched_all_pairs,
    batched_preprofiles,
    batched_progressive_merge,
    msa_align,
    per_level_merge,
)
from .device_merge import try_device_merge

__all__ = [
    "batched_all_pairs",
    "batched_preprofiles",
    "batched_progressive_merge",
    "msa_align",
    "per_level_merge",
    "try_device_merge",
]
