"""Observability: stage timers, DP-cell counters, profiler spans, logging.

Replaces the reference's progress-message streaming (SURVEY.md §6: C8
messages + CLI progress) with stdlib logging plus a process-wide metrics
registry: per-stage wall time, DP cells executed (so cells/s is reportable
per stage), pair counts, and counters of the DP cells launched against the
cells needed (``METRICS.counters``).

Copy of ``praline_tpu/util/metrics.py`` with its profiling hooks on
``torch.profiler`` instead of ``jax.profiler``.  :func:`span` opens a
``torch.profiler.record_function`` range whenever a torch profiler is
recording, whoever started it (the CLI's ``--profile-dir``, a benchmark,
a caller's own ``torch.profiler.profile``); with none recording it costs
one test of the profiler's flag.  The host steps' spans are named
``<layer>:<step>`` (``pipeline:``, ``batch:``, ``dispatch:``, ``gather:``,
``merge:``, ``ring:``, and the fused and tiled kernels' wrappers'
``fused:`` and ``tiled:``); the pipeline's two scopes keep their names
``msa_align`` and ``merge``.  :func:`enable_profiling` arms a trace directory,
and the outermost :func:`maybe_trace` scope (``msa_align``) then profiles
the host and the card and writes a Chrome trace there on exit, unless a
profiler is already recording: then it only opens its range.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from pathlib import Path

import torch.autograd.profiler as _profiler

log = logging.getLogger("praline_tpu_torch")


@dataclasses.dataclass
class StageStats:
    seconds: float = 0.0
    cells: float = 0.0
    pairs: int = 0

    @property
    def cells_per_s(self) -> float:
        return self.cells / self.seconds if self.seconds > 0 else 0.0


class Metrics:
    """Process-wide per-stage counters (reset per pipeline run), notes: what
    a stage chose (the merge's walk, column capacity and attempts), and
    ``counters``: integers that only grow, which :meth:`reset` leaves
    alone, so that a reader can take ratios over a whole process.

    ``counters`` holds the DP cells the batch drivers launch and need, a
    route each (``batch.cells_launched:{route}``: rows times the bucket's
    ``bx * by`` a chunk; ``batch.cells_needed:{route}``: ``lx * ly`` at the
    true lengths), the pairs that enter the batch driver by each entry
    (``batch.pairs:indexed``: as index arrays, ``align_pairs_indexed``;
    ``batch.pairs:listed``: as a list of profile pairs,
    ``align_pairs_batched``), the chunks of the tiled and checkpointed
    routes by score source (``tiled.chunks:{hs,rows,composite}``) and the
    problems they ran (``tiled.problems:{scores,traceback}``), and the
    device merge's (``merge.cells_launched``: joins times ``C_cap**2`` for
    every rung a walk tries; ``merge.cells_needed``: the emitted joins'
    ``cols_left * cols_right``)."""

    def __init__(self) -> None:
        self.stages: dict[str, StageStats] = {}
        self.notes: dict[str, object] = {}
        self.counters: dict[str, int] = {}

    def stage(self, name: str) -> StageStats:
        return self.stages.setdefault(name, StageStats())

    def reset(self) -> None:
        self.stages.clear()
        self.notes.clear()

    def note(self, key: str, value) -> None:
        self.notes[key] = value

    def count(self, key: str, n: int) -> None:
        self.counters[key] = self.counters.get(key, 0) + int(n)

    def add_pairs(self, stage: str, n_pairs: int, cells: float) -> None:
        s = self.stage(stage)
        s.pairs += n_pairs
        s.cells += cells

    @contextlib.contextmanager
    def timed(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.stage(stage).seconds += dt
            log.info("stage %s: %.3fs", stage, dt)

    def log_summary(self) -> None:
        for name, s in self.stages.items():
            log.info(
                "stage %-12s %8.3fs  pairs=%-6d cells=%.3g  (%.3g cells/s)",
                name,
                s.seconds,
                s.pairs,
                s.cells,
                s.cells_per_s,
            )


METRICS = Metrics()

_trace_dir: str | None = None
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range ``name`` (``<layer>:<step>``) around the enclosed
    block where a torch profiler is recording, on the profiler's clock
    beside the card's activity in its trace; with none recording, no range
    (one read of the profiler's flag)."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _profiler.record_function(name)


def enable_profiling(trace_dir: str) -> None:
    """Arm profiling: the next outermost :func:`maybe_trace` scope (the
    pipeline run) writes a trace into ``trace_dir``."""
    global _trace_dir
    _trace_dir = str(trace_dir)


def disable_profiling() -> None:
    """Disarm profiling (the counterpart of :func:`enable_profiling`)."""
    global _trace_dir
    _trace_dir = None


@contextlib.contextmanager
def maybe_trace(name: str):
    """Profile the enclosed scope when a trace directory is armed and no
    profiler is recording yet.

    Such a scope runs a ``torch.profiler.profile`` of the host and, where a
    card is visible, the card, and on exit writes
    ``{name}.{pid}.{ns}.pt.trace.json`` (Chrome trace format) into the
    directory.  Under a profiler that is already recording (its own, or
    one the caller started) the scope is a :func:`span` alone: no second
    profiler, no file."""
    if _trace_dir is None or _profiler._is_profiler_enabled:
        with span(name):
            yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(_trace_dir)
    with profile(activities=activities) as prof:
        with _profiler.record_function(name):
            yield
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}.{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(str(path))
    log.info("wrote profile trace %s", path)


def configure_logging(verbosity: int, json_lines: bool = False) -> None:
    level = logging.WARNING
    if verbosity == 1:
        level = logging.INFO
    elif verbosity >= 2:
        level = logging.DEBUG
    handler = logging.StreamHandler()
    if json_lines:
        class _Json(logging.Formatter):
            def format(self, record):
                return json.dumps(
                    {
                        "t": round(record.created, 3),
                        "level": record.levelname,
                        "msg": record.getMessage(),
                    }
                )

        handler.setFormatter(_Json())
    else:
        handler.setFormatter(
            logging.Formatter("[%(asctime)s] %(levelname)s %(message)s", "%H:%M:%S")
        )
    log.handlers[:] = [handler]
    log.setLevel(level)
