"""Observability: stage timers, DP-cell counters, structured logging.

Replaces the reference's progress-message streaming (SURVEY.md §6: C8
messages + CLI progress) with stdlib logging plus a process-wide metrics
registry: per-stage wall time, DP cells executed (so cells/s is reportable
per stage), and pair counts.

Copy of ``praline_tpu/util/metrics.py`` without its ``jax.profiler`` hooks:
the port's CLI refuses ``--profile-dir``, and a profile of the card is
taken with ``torch.profiler`` (``chip_smoke.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import time

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
