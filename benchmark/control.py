#!/usr/bin/env python3
"""The control of the check: the reference in the program's place, in bfloat16.

    python3 benchmark/control.py --workload default.msa128 --seeds 11,12,13

For each seed, the cell's first ``check_requests`` families (as a run
checks) go through the reference with its DP cells in bfloat16, the nearest
precision below the float32 the configurations state: the all-pairs stage
and, for a whole alignment, the guide tree on its scores and the merge
along that tree.  That output is judged exactly as a run judges the
program's (``reference/msa.py::judge``); each number has to come out above
its limit.  Prints one JSON line a seed.  The benchmark's own runs do not
run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device: str, count: int, dtype=None) -> dict:
    """The numbers the check reads for the control on ``count`` families of ``seed``."""
    import torch

    from benchmark import families, harness
    from benchmark.reference import msa as ref

    S = harness.score_matrix(cell.bench, cell.config)
    whole = cell.traffic["entry"] == "msa_align"
    total: dict = {}
    for index in range(count):
        tokens = families.family(seed, index, cell.traffic["family"])
        out = ref.lowered(tokens, S, cell.config, whole, device, dtype or torch.bfloat16)
        for name, value in ref.judge(tokens, out, S, cell.config, device).items():
            total[name] = total.get(name, 0) + value
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.find_cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = readings(cell, seed, "cuda", int(cell.traffic["check_requests"]))
        print(json.dumps({"workload": args.workload, "seed": seed, "control": got,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
