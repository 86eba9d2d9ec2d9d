"""Compute kernels of the port: the Hopper producer, DP, fused producer +
DP, lane-tiled DP, traceback walk and the benchmark's probes with their
plain PyTorch versions, and the batched aligners (``batch``).

Importing this package never builds or loads the CUDA library; the first
launch on a CUDA tensor does.
"""

from .batch import (
    PairResult,
    ProfileArena,
    align_pairs_batched,
    align_tracksets_batched,
    choose_route,
)
from .fused_dp import wavefront_dp_fused, wavefront_dp_fused_plain
from .fused_scores import fused_skewed_scores
from .probes import alu_chains, smem_chain, write_blocks
from .replay import moves_to_result, replay_moves, replay_moves_plain
from .scan import wavefront_dp as wavefront_dp_plain
from .scores import composite_skewed_scores, skewed_pair_scores
from .tiled_dp import wavefront_dp_tiled, wavefront_dp_tiled_plain
from .wavefront import wavefront_dp

__all__ = [
    "PairResult",
    "ProfileArena",
    "align_pairs_batched",
    "align_tracksets_batched",
    "alu_chains",
    "choose_route",
    "composite_skewed_scores",
    "fused_skewed_scores",
    "moves_to_result",
    "replay_moves",
    "replay_moves_plain",
    "skewed_pair_scores",
    "smem_chain",
    "wavefront_dp",
    "wavefront_dp_fused",
    "wavefront_dp_fused_plain",
    "wavefront_dp_plain",
    "wavefront_dp_tiled",
    "wavefront_dp_tiled_plain",
    "write_blocks",
]
