"""The share of the DP cells the device merge launched that its emitted
joins needed: 100 times ``merge.cells_needed`` (each join's
``cols_left * cols_right`` in the emitted alignment) over
``merge.cells_launched`` (joins times ``C_cap**2`` for every rung a walk
tried, reruns included), from the program's ``METRICS.counters``, over the
benchmark process's requests.  Nothing where the program has no counters."""


def read(run):
    import praline_tpu_torch

    counters = getattr(praline_tpu_torch.METRICS, "counters", None) or {}
    launched = counters.get("merge.cells_launched", 0)
    return 100.0 * counters.get("merge.cells_needed", 0) / launched if launched else None
