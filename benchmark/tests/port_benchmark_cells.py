"""Shared pieces of the benchmark's CPU tests: a tiny cell of each entry."""

import copy
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]

TINY = {"members": 6, "root": 48, "lo": 30, "hi": 48, "substitution": 0.25, "insertions": 2,
        "max_insert": 3, "max_cut": 39, "alphabet": 20}


def tiny_cell(workload: str) -> harness.Cell:
    """``workload`` of the repository's BENCHMARK.json with families of 6
    members of 30-48 residues, so that the port's CPU path runs it."""
    cell = harness.find_cell(ROOT, workload)
    cell.traffic = dict(copy.deepcopy(cell.traffic), family=dict(TINY), pool=3,
                        check_requests=2, trace_requests=1)
    return cell
