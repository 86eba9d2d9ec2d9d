"""Observability: stage timers, DP-cell counters, structured logging.

Replaces the reference's progress-message streaming (SURVEY.md §6: C8
messages + CLI progress) with stdlib logging plus a process-wide metrics
registry: per-stage wall time, DP cells executed (so cells/s is reportable
per stage), and pair counts.

Copy of ``praline_tpu/util/metrics.py`` with its profiling hooks on
``torch.profiler`` instead of ``jax.profiler``: :func:`enable_profiling`
arms a trace directory (the CLI's ``--profile-dir``), the outermost
:func:`maybe_trace` scope (``msa_align``) profiles the host and the card
and writes a Chrome trace there on exit, and nested scopes and
:func:`annotate` spans (``dispatch:...`` per chunk, ``kernels/batch.py``)
become ``torch.profiler.record_function`` ranges on its timeline.  With
nothing armed they cost one test of a module global.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from pathlib import Path

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
    """Process-wide per-stage counters (reset per pipeline run), and notes:
    what a stage chose (the merge's walk, column capacity and attempts)."""

    def __init__(self) -> None:
        self.stages: dict[str, StageStats] = {}
        self.notes: dict[str, object] = {}

    def stage(self, name: str) -> StageStats:
        return self.stages.setdefault(name, StageStats())

    def reset(self) -> None:
        self.stages.clear()
        self.notes.clear()

    def note(self, key: str, value) -> None:
        self.notes[key] = value

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

    def summary(self) -> dict:
        return {
            name: {
                "seconds": round(s.seconds, 4),
                "cells": s.cells,
                "pairs": s.pairs,
                "cells_per_s": round(s.cells_per_s, 1),
            }
            for name, s in self.stages.items()
        }

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
_trace_active = False


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
    """Profile the enclosed scope when a trace directory is armed.

    The outermost scope runs a ``torch.profiler.profile`` of the host and,
    where a card is visible, the card, and on exit writes
    ``{name}.{pid}.{ns}.pt.trace.json`` (Chrome trace format) into the
    directory; nested scopes become ``record_function`` ranges, so that
    per-stage callers compose with the pipeline-level trace."""
    global _trace_active
    if _trace_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if _trace_active:
        with record_function(name):
            yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(_trace_dir)
    _trace_active = True
    try:
        with profile(activities=activities) as prof:
            with record_function(name):
                yield
    finally:
        _trace_active = False
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}.{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(str(path))
    log.info("wrote profile trace %s", path)


@contextlib.contextmanager
def annotate(name: str):
    """Label a region on the profiler timeline (a no-op unless a
    :func:`maybe_trace` profile runs)."""
    if not _trace_active:
        yield
        return
    from torch.profiler import record_function

    with record_function(name):
        yield


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
