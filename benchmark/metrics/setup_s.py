"""Seconds from the process's start to the first timed request: imports,
the card's context, loading (on a checkout's first run, building) the
kernels, the family pool and the warm-up requests."""


def read(run):
    return run.setup_s
