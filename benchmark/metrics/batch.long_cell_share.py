"""The share of the DP cells the batch drivers' problems needed that ran on
the long routes: 100 times the sum of ``batch.cells_needed:{route}``
(``lx * ly`` at true lengths) over the fused, tiled and checkpointed routes,
over its sum over every route, from the program's ``METRICS.counters``.
They only grow, and one cell runs in a benchmark process, so the share
covers its warm-up, window and traced requests.  Nothing where the program
has no counters."""

LONG = ("fused", "tiled", "checkpointed")


def read(run):
    import praline_tpu_torch

    counters = getattr(praline_tpu_torch.METRICS, "counters", None) or {}
    prefix = "batch.cells_needed:"
    needed = {k[len(prefix):]: v for k, v in counters.items() if k.startswith(prefix)}
    total = sum(needed.values())
    return 100.0 * sum(needed.get(r, 0) for r in LONG) / total if total else None
