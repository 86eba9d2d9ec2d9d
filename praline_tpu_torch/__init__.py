"""praline-tpu-torch: the PyTorch/CUDA port of the praline-tpu MSA engine.

Runs the same progressive multiple sequence alignment as ``praline_tpu``
(the JAX package, which stays the reference) on an NVIDIA H100: the score
producer and the wavefront DP are CUDA kernels written for Hopper
(``csrc/``), everything around them is plain PyTorch, and the host layers
(``types``, ``io``, ``oracle``, ``util``: checkpoints and metrics) are the
port's own copies of the JAX package's numpy code: the port imports
nothing of ``praline_tpu``.  The host types, readers, writers and the
metrics registry a caller needs are re-exported here, so a user of the
port imports only ``praline_tpu_torch``.

Every entry point takes an explicit ``device``; there is no global device
state.  This root imports neither the kernels' build nor JAX.
"""

from .io import (
    builtin_score_matrix,
    format_alignment_clustal,
    format_alignment_fasta,
    load_sequence_fasta,
)
from .types import (
    ALPHABET_AA,
    ALPHABET_DNA,
    GAP,
    Alignment,
    PralineConfig,
    Profile,
    ScoreMatrix,
    Sequence,
)
from .util.metrics import METRICS

from .device import resolve_device
from .msa import msa_align

__version__ = "0.1.0"

__all__ = [
    "ALPHABET_AA",
    "ALPHABET_DNA",
    "GAP",
    "METRICS",
    "Alignment",
    "PralineConfig",
    "Profile",
    "ScoreMatrix",
    "Sequence",
    "builtin_score_matrix",
    "format_alignment_clustal",
    "format_alignment_fasta",
    "load_sequence_fasta",
    "msa_align",
    "resolve_device",
    "__version__",
]
