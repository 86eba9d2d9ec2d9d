"""The card's peaks and the least time the card could take for a request's DP work.

Frozen from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``INT8_OPS_PER_S``,
``F32_LANES_PER_SM``, ``card_rates``, ``bound``, ``operand_bytes``'s column
size), so that later changes to the program cannot move the yardstick.
Published peaks of one H100 SXM at its 700 W limit: 3.35 TB/s of device
memory, 1979 dense int8 TOP/s on the tensor cores; the f32 rate is that of
lane-instructions (no kernel of the port issues an FMA, so an f32 operation
is one instruction): the card's SMs times 128 lanes times its maximum SM
clock as ``nvidia-smi --query-gpu=clocks.max.sm`` reports it.

A request's work is the DP cells it needs (``lx * ly`` at true lengths; no
bucket or skew padding), whatever route computes them:

* each cell's score, a dot product of ``A`` terms: ``2 A`` int8 operations;
* each cell's recurrence: the lane-instructions of one plain DP step for its
  mode, gap series and output (``data/lane_ops.json``: the count of
  ``praline_tpu_torch/bench.py::count_step_lane_ops`` frozen as data);
* its inputs read once (``(A + 1)`` float32 a profile column) and its outputs
  written once (8 bytes a scores-only problem, a byte a cell of traceback).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_LANES_PER_SM = 128
LANE_OPS = Path(__file__).resolve().parent / "data" / "lane_ops.json"


def card_rates(sms: int) -> dict:
    """The f32 lane-instruction rate of a card of ``sms`` SMs at its maximum SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    return {"sms": sms, "sm_clock_hz": mhz * 1e6, "f32_ops_per_s": sms * F32_LANES_PER_SM * mhz * 1e6}


def lane_ops(gap_series, mode: str, traceback: bool) -> float:
    key = f"{mode}:{','.join(map(str, gap_series))}:{'traceback' if traceback else 'scores'}"
    table = json.loads(LANE_OPS.read_text())["lane_ops_per_cell"]
    if key not in table:
        raise KeyError(f"no frozen lane-instruction count for {key}; add it to {LANE_OPS.name}")
    return float(table[key])


@dataclasses.dataclass
class Work:
    """A request's needed DP work, summed over its problems."""

    cells: float = 0.0
    f32_ops: float = 0.0
    int8_ops: float = 0.0
    nbytes: float = 0.0

    def add_problems(self, cells: float, columns: float, problems: int, A: int,
                     ops_per_cell: float, traceback: bool) -> None:
        """``problems`` DP problems of ``cells`` needed cells in all, whose
        profiles hold ``columns`` columns in all."""
        self.cells += cells
        self.f32_ops += cells * ops_per_cell
        self.int8_ops += cells * 2 * A
        self.nbytes += columns * (A + 1) * 4 + (cells if traceback else problems * 8)

    def __iadd__(self, other: "Work") -> "Work":
        self.cells += other.cells
        self.f32_ops += other.f32_ops
        self.int8_ops += other.int8_ops
        self.nbytes += other.nbytes
        return self


def bound_s(work: Work, rates: dict) -> float:
    """The larger of the bytes' time and the operations' time, in seconds."""
    t_bytes = work.nbytes / HBM_BYTES_PER_S
    t_ops = work.f32_ops / rates["f32_ops_per_s"] + work.int8_ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops)
