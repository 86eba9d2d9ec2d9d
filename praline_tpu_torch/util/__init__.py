"""Cross-cutting utilities: metrics/logging, checkpoints (copies of the
JAX package's ``praline_tpu/util`` modules of the same names)."""

from .checkpoint import Checkpoint, run_digest
from .metrics import METRICS, configure_logging, log

__all__ = [
    "Checkpoint",
    "METRICS",
    "configure_logging",
    "log",
    "run_digest",
]
