"""Compute kernels of the port: the Hopper producer, DP and traceback walk
with their plain PyTorch versions, and the batched aligner (``batch``).

Importing this package never builds or loads the CUDA library; the first
launch on a CUDA tensor does.
"""

from .batch import PairResult, ProfileArena, align_pairs_batched
from .fused_scores import fused_skewed_scores
from .replay import moves_to_result, replay_moves, replay_moves_plain
from .scan import wavefront_dp as wavefront_dp_plain
from .scores import skewed_pair_scores
from .wavefront import wavefront_dp

__all__ = [
    "PairResult",
    "ProfileArena",
    "align_pairs_batched",
    "fused_skewed_scores",
    "moves_to_result",
    "replay_moves",
    "replay_moves_plain",
    "skewed_pair_scores",
    "wavefront_dp",
    "wavefront_dp_plain",
]
