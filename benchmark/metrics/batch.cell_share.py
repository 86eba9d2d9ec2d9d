"""The share of the DP cells the batch drivers launched that the problems
needed: 100 times the sum of ``batch.cells_needed:{route}`` (``lx * ly`` at
true lengths) over the sum of ``batch.cells_launched:{route}`` (rows times
the bucket's ``bx * by``), every route, from the program's
``METRICS.counters``.  They only grow, and one cell runs in a benchmark
process, so the share covers its warm-up, window and traced requests, all
families of one length set.  Nothing where the program has no counters."""


def read(run):
    import praline_tpu_torch

    counters = getattr(praline_tpu_torch.METRICS, "counters", None) or {}
    launched = sum(v for k, v in counters.items() if k.startswith("batch.cells_launched:"))
    needed = sum(v for k, v in counters.items() if k.startswith("batch.cells_needed:"))
    return 100.0 * needed / launched if launched else None
